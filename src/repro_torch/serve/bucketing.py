"""Shape bucketing for the solve server.

The port of :mod:`repro.serve.bucketing`.  A heterogeneous request stream
is mapped onto *buckets*: each request is zero/identity padded up to its
bucket's canonical shape, so the number of distinct shapes the server runs
is bounded by the (logarithmic) number of shape classes.  The boundaries,
the keys and the embeddings are the reference's, so a key, or a padded
operand, made by either package from the same NumPy input is equal
(``BucketKey.dtype`` is the NumPy dtype name, ``"float32"``/``"float64"``).

The padding is *exact*: a request's answer inside the padded system is
bit-identical to the port's unbatched driver on the raw shape.  Two
ingredients make that true:

* the embeddings couple the real block to the padding only through exact
  zeros (block-diagonal identity for square systems, identity tail rows for
  least squares, a ``sqrt(tiny)`` diagonal for pivoted QR so padding
  columns always lose the pivot race), and
* every reduction on the ``"cuda"`` backend's path sums its terms in an
  order fixed by the index of the term alone, so trailing zero terms leave
  the bits as they are: the GEMM's split-K chunks, the strip TRSM's
  substitution order, the QR and QRCP panels' 32-row chunks dealt
  round-robin over their blocks (at every height) and, on CPU tensors, the
  plain versions' chains and aligned pairwise sums.
  :class:`repro_torch.serve.solver.SolveServer` says where this stops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tune.cache import dtype_name

__all__ = [
    "SHAPE_QUANTUM", "BucketKey", "round_up", "shape_class", "batch_slots",
    "pad_request", "extract", "flops",
]

#: Bucket boundaries are multiples of this.
SHAPE_QUANTUM = 32

#: Below this, boundaries advance linearly in quanta; above, geometrically
#: (powers of two), bounding the number of shape classes logarithmically.
_LINEAR_LIMIT = 128

#: Square-system dmfs (padded with a block-diagonal identity).
SQUARE_DMFS = ("gesv", "posv")
#: Least-squares dmfs (padded with identity tail rows).
TALL_DMFS = ("gels", "geqp3")


def round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def boundary(x: int) -> int:
    """Smallest bucket boundary >= x (linear in quanta, then geometric)."""
    x = max(1, int(x))
    if x <= _LINEAR_LIMIT:
        return round_up(x, SHAPE_QUANTUM)
    b = _LINEAR_LIMIT
    while b < x:
        b *= 2
    return b


def _rhs_boundary(nrhs: int) -> int:
    """RHS columns quantize to powers of two (1, 2, 4, ...)."""
    b = 1
    while b < nrhs:
        b *= 2
    return b


class BucketKey(NamedTuple):
    """One shape class: the unit the server batches and counts."""

    dmf: str
    dtype: str    # NumPy dtype name, "float32" / "float64"
    m: int        # canonical (padded) row count
    n: int        # canonical (padded) column count
    nrhs: int     # canonical (padded) RHS columns


def shape_class(dmf: str, m: int, n: int, nrhs: int, dtype) -> BucketKey:
    """Canonical bucket for a raw (m × n, nrhs) request; ``dtype`` may be a
    torch, NumPy or string dtype."""
    if dmf in SQUARE_DMFS:
        if m != n:
            raise ValueError(f"{dmf} needs a square matrix, got {m}x{n}")
        np_ = boundary(n)
        mp = np_
    elif dmf in TALL_DMFS:
        if m < n:
            raise ValueError(f"{dmf} needs m >= n, got {m}x{n}")
        np_ = boundary(n)
        # the identity tail adds (np_ − n) rows; the row boundary must
        # leave room for the worst-case tail in this column class
        mp = boundary(m + (np_ - 1))
    else:
        raise ValueError(f"unknown dmf {dmf!r}")
    return BucketKey(dmf, dtype_name(dtype), mp, np_, _rhs_boundary(nrhs))


def batch_slots(n_requests: int, max_batch: int) -> int:
    """The reference's padded batch size: the next power of two, never 1.

    The reference fills its batches up to this with replicas of a real
    request; the port runs only the real requests and keeps the count for
    the ``bucket_fill`` and ``padding_waste`` metrics.
    """
    slots = 2
    while slots < n_requests:
        slots *= 2
    return min(slots, max(2, max_batch)) if n_requests <= max_batch else slots


def pad_request(dmf: str, a: torch.Tensor, b: torch.Tensor,
                key: BucketKey) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed (a, b) into the bucket's canonical shape, exactly; new
    tensors on ``a``'s device.

    * square dmfs: ``diag(A, I)`` — padded pivot rows are zero in real
      columns, so LU pivoting and the substitution sweeps never couple the
      blocks; posv padding keeps the matrix SPD.
    * gels: identity rows below the real block for the padding columns —
      the padded LS solution is exactly ``(x, 0)``.
    * geqp3: same embedding with a ``sqrt(tiny)`` diagonal so the padded
      columns always lose the global pivot competition against real ones,
      leaving the real pivot order untouched.
    """
    m, n = a.shape
    nrhs = b.shape[1]
    kw = dict(dtype=a.dtype, device=a.device)
    bp = torch.zeros((key.m, key.nrhs), **kw)
    bp[:m, :nrhs] = b
    if dmf in SQUARE_DMFS:
        ap = torch.zeros((key.n, key.n), **kw)
        ap[:n, :n] = a
        ap.diagonal()[n:] = 1.0
        return ap, bp
    ap = torch.zeros((key.m, key.n), **kw)
    ap[:m, :n] = a
    tail = key.n - n
    diag = torch.finfo(a.dtype).tiny if dmf == "geqp3" else 1.0
    # the correctly rounded sqrt(tiny) at the working dtype
    ap[m : m + tail, n:].diagonal()[:] = torch.sqrt(
        torch.tensor(diag, **kw))
    return ap, bp


def extract(x_pad: torch.Tensor, n: int, nrhs: int) -> torch.Tensor:
    """Recover the raw-shape solution from a padded one."""
    return x_pad[:n, :nrhs]


def flops(dmf: str, m: int, n: int, nrhs: int) -> float:
    """Nominal flop count of one request (raw shape) for GFLOP/s metrics."""
    if dmf == "gesv":
        return (2.0 / 3.0) * n ** 3 + 2.0 * n * n * nrhs
    if dmf == "posv":
        return (1.0 / 3.0) * n ** 3 + 2.0 * n * n * nrhs
    # QR-based: 2mn² − 2n³/3 for the factor plus the two solve sweeps
    return 2.0 * m * n * n - (2.0 / 3.0) * n ** 3 + \
        2.0 * n * (m + n) * nrhs
