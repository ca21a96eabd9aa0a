"""LU factorization with partial pivoting (LUpp) — all scheduling variants.

The port of :mod:`repro.core.lu`.  The algorithm is declared once as
:data:`LU_OPS`; the engine in :mod:`repro_torch.core.pipeline` emits

* :func:`lu_blocked`   — right-looking blocked GETRF, the **MTB** variant;
* :func:`lu_tiled`     — **RTM**: the trailing update in per-tile tasks;
* :func:`lu_lookahead` — **LA**: static look-ahead, ``depth`` panels in
  flight, and **LA_MB** with ``fused_pu=`` (the fused panel update).

Pivoting follows GETRF: ``ipiv[j]`` (0-based, global, int32) is the row
swapped with row ``j`` at step ``j``, and interchanges apply to whole rows,
so ``P·A = L·U`` and the numerics do not depend on the schedule.

In-place updates.  Where the reference writes ``a.at[...].set(...)``, the
port writes into views of one working copy of the matrix: the panel
factors in place, ``swap`` permutes rows of the column blocks outside the
panel in place, and ``update`` overwrites its block.  The drivers copy the
caller's input once (in :func:`repro_torch.core.pipeline.factorize`).

Row interchanges.  :func:`laswp` does not issue one row swap per pivot:
it composes the panel's swap sequence into one permutation of the rows it
touches (on the host, one device-to-host copy of the panel's pivots) and
applies that as one gather and one scatter.  The result equals the
sequential swaps.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import pipeline
from repro_torch.core.blocking import BlockSpec
from repro_torch.core.pipeline import StepOps

__all__ = [
    "lu_unblocked",
    "lu_blocked",
    "lu_tiled",
    "lu_lookahead",
    "laswp",
    "permutation_from_pivots",
    "unpack_lu",
    "LU_OPS",
]


# ---------------------------------------------------------------------------
# Unblocked panel factorization (PF) — GETF2, the plain version of the
# panel kernel (repro_torch.kernels.panel_lu).
# ---------------------------------------------------------------------------
def lu_unblocked(panel: torch.Tensor) -> torch.Tensor:
    """Factor an (m × nb) panel in place; return int32 panel-relative pivots.

    At step ``j`` rows ``j`` and ``piv[j]`` (>= j) were interchanged; the
    pivot is the first largest ``|a[i, j]|`` over ``i >= j`` (as
    ``jnp.argmax``), the multipliers are ``a[:, j] / pivot`` and the rank-1
    update rounds each product and difference once.
    """
    m, nb = panel.shape
    steps = min(m, nb)
    piv = torch.empty(steps, dtype=torch.int32, device=panel.device)
    for j in range(steps):
        p = torch.argmax(panel[j:, j].abs()) + j
        piv[j] = p
        rows = torch.stack((torch.full_like(p, j), p))
        panel[rows] = panel[rows.flip(0)]
        if j + 1 < m:
            l = panel[j + 1 :, j] / panel[j, j]
            panel[j + 1 :, j] = l
            panel[j + 1 :, j + 1 :] -= l[:, None] * panel[j, j + 1 :][None, :]
    return piv


# ---------------------------------------------------------------------------
# Row interchanges (LASWP analogue).
# ---------------------------------------------------------------------------
def _compose_swaps(piv: np.ndarray, size: int) -> np.ndarray:
    """``perm`` over ``size`` rows with ``new[r] == old[perm[r]]`` after the
    swaps ``r=j <-> r=piv[j]`` for j in order."""
    perm = np.arange(size)
    for j, p in enumerate(piv.tolist()):
        perm[j], perm[p] = perm[p], perm[j]
    return perm


def _moved_rows(piv: torch.Tensor, offset: int, device):
    """(dst, src) row indices of the composed swap sequence, moved rows
    only; None when the sequence is the identity.  One host copy of piv."""
    piv = piv.cpu().numpy()
    perm = _compose_swaps(piv, max(int(piv.max()) + 1, piv.size)
                          if piv.size else 0)
    moved = np.nonzero(perm != np.arange(perm.shape[0]))[0]
    if moved.size == 0:
        return None
    dst = torch.from_numpy(moved + offset).to(device)
    src = torch.from_numpy(perm[moved] + offset).to(device)
    return dst, src


def laswp(a: torch.Tensor, piv: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Apply the swap sequence ``row offset+j <-> row offset+piv[j]`` to
    ``a`` in place, as one gather; returns ``a``."""
    rows = _moved_rows(piv, offset, a.device)
    if rows is not None:
        dst, src = rows
        a[dst] = a[src]
    return a


def permutation_from_pivots(piv: torch.Tensor, n: int) -> torch.Tensor:
    """Row-permutation vector ``perm`` (int64) such that ``A[perm] == P·A``."""
    return torch.from_numpy(_compose_swaps(piv.cpu().numpy(), n)).to(
        piv.device)


def unpack_lu(lu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split packed LU into (unit-lower L, upper U)."""
    eye = torch.eye(lu.shape[0], dtype=lu.dtype, device=lu.device)
    return torch.tril(lu, -1) + eye, torch.triu(lu)


# ---------------------------------------------------------------------------
# The StepOps declaration.
# ---------------------------------------------------------------------------
class _LUCtx(NamedTuple):
    piv: torch.Tensor          # panel-relative pivots of the factored panel


def _init(a):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"LU needs a square matrix, got {tuple(a.shape)}")
    return a, torch.zeros((a.shape[0],), dtype=torch.int32, device=a.device)


def _factor(state, st, backend, panel_fn):
    # PF(k): ``panel_fn`` factors the (m × bk) panel view in place and
    # returns its panel-relative pivots.
    a, ipiv = state
    k, bk = st.k, st.bk
    piv = (panel_fn or lu_unblocked)(a[k:, k : k + bk])
    ipiv[k : k + bk] = piv + k
    return state, _LUCtx(piv)


def _swap(state, ctx, st, backend):
    # Interchanges of panel k applied to every column outside the panel —
    # eager under mtb/rtm, deferred one iteration under la (Listing 5).
    a, _ = state
    k, n = st.k, a.shape[1]
    if k == 0 and st.k_next >= n:
        return state
    rows = _moved_rows(ctx.piv, k, a.device)
    if rows is not None:
        dst, src = rows
        for cols in (slice(0, k), slice(st.k_next, n)):
            if cols.start < cols.stop:
                block = a[:, cols]
                block[dst] = block[src]
    return state


def _update(state, ctx, st, c0, c1, backend):
    # TU_k over columns [c0, c1): TRSM on the block row, GEMM below it.
    a, _ = state
    k, bk, k_next = st.k, st.bk, st.k_next
    u12 = a[k : k + bk, c0:c1]
    backend.trsm(a[k : k + bk, k : k + bk], u12, side="left", lower=True,
                 unit_diagonal=True, out=u12)
    backend.update(a[k_next:, c0:c1], a[k_next:, k : k + bk], u12)
    return state


def _tiles(state, ctx, st, backend):
    # RTM: one TRSM task per trailing column panel, one GEMM task per tile.
    a, _ = state
    n = a.shape[1]
    k, bk = st.k, st.bk
    l11 = a[k : k + bk, k : k + bk]
    for j in range(st.k_next, n, bk):
        cols = slice(j, min(j + bk, n))
        u12 = a[k : k + bk, cols]
        backend.trsm(l11, u12, side="left", lower=True, unit_diagonal=True,
                     out=u12)
        for i in range(st.k_next, n, bk):
            rows = slice(i, min(i + bk, n))
            backend.update(a[rows, cols], a[rows, k : k + bk], u12)
    return state


def _pu(state, ctx, st, st_next, backend, fused):
    # LA_MB: TRSM + GEMM + GETF2 in one kernel —
    # ``fused(l11, l21, a1l, a2l) -> (u12, packed, piv)`` writes U12 into
    # a1l and the packed panel into a2l in place.
    a, ipiv = state
    k, bk, k_next = st.k, st.bk, st.k_next
    lcols = slice(st_next.k, st_next.k_next)
    _, _, piv = fused(a[k : k + bk, k : k + bk], a[k_next:, k : k + bk],
                      a[k : k + bk, lcols], a[k_next:, lcols])
    ipiv[st_next.k : st_next.k_next] = piv + st_next.k
    return state, _LUCtx(piv)


LU_OPS = StepOps(
    name="lu",
    init=_init,
    factor=_factor,
    update=_update,
    finalize=lambda state: state,
    swap=_swap,
    tiles=_tiles,
    pu=_pu,
)


# ---------------------------------------------------------------------------
# Public drivers — thin engine wrappers.  Each copies ``a`` once to
# ``device`` (None = the GPU) and returns (packed LU, global int32 ipiv).
# ---------------------------------------------------------------------------
def lu_blocked(a, b: BlockSpec = 128, *, backend="cuda",
               panel_fn: Optional[Callable] = None, device=None, mesh=None,
               layout=None):
    """Right-looking blocked LUpp (MTB)."""
    return pipeline.factorize(LU_OPS, a, b, variant="mtb", backend=backend,
                              panel_fn=panel_fn, device=device, mesh=mesh,
                              layout=layout)


def lu_tiled(a, b: BlockSpec = 128, *, backend="cuda",
             panel_fn: Optional[Callable] = None, device=None, mesh=None,
             layout=None):
    """Blocked LUpp with the trailing update fragmented into per-tile
    tasks (RTM, paper Listing 4)."""
    return pipeline.factorize(LU_OPS, a, b, variant="rtm", backend=backend,
                              panel_fn=panel_fn, device=device, mesh=mesh,
                              layout=layout)


@pipeline.mark_depth_capable
def lu_lookahead(a, b: BlockSpec = 128, *, backend="cuda",
                 panel_fn: Optional[Callable] = None,
                 fused_pu: Optional[Callable] = None, depth: int = 1,
                 device=None, mesh=None, layout=None):
    """LUpp with static look-ahead; ``depth`` panels in flight.

    The pivots of PF(k+1) are applied at the start of iteration k+1 (row
    interchanges commute with the row-parallel trailing update), so the
    factors equal the blocked variant's at every depth.  ``fused_pu``: a
    fused panel update ``(l11, l21, a1l, a2l) -> (u12, packed, piv)``
    (LA_MB), writing into ``a1l`` and ``a2l`` in place.
    """
    return pipeline.factorize(LU_OPS, a, b, variant="la", depth=depth,
                              backend=backend, panel_fn=panel_fn,
                              fused_pu=fused_pu, device=device, mesh=mesh,
                              layout=layout)
