"""Cholesky factorization (lower, ``A = L·Lᵀ``) — all scheduling variants.

The port of :mod:`repro.core.cholesky`.  The algorithm is declared once as
:data:`CHOLESKY_OPS`; the engine in :mod:`repro_torch.core.pipeline` emits

* :func:`cholesky_blocked`   — right-looking blocked POTRF, the **MTB**
  variant;
* :func:`cholesky_tiled`     — **RTM**: one update task per b × b tile of
  the lower trailing triangle;
* :func:`cholesky_lookahead` — **LA**: static look-ahead, ``depth`` panels
  in flight, and **LA_MB** with ``fused_pu=`` (the fused panel update).

Cholesky needs no pivoting: ``PU(k+1)`` and ``TU_right(k)`` share only the
read-only ``L21`` of panel k.  Only the lower triangle of the input is
read where it matters; the result is ``tril``'d, as in the reference.

In-place updates.  As in :mod:`repro_torch.core.lu`, the hooks write into
views of one working copy of the matrix.  The update's B operand is
``lrowᵀ``, a transposed view; the GEMM kernel takes unit stride in the
last dimension, so the hooks hand it a contiguous copy of ``lrowᵀ``
(``(c1 − c0) × b`` values, one copy kernel per update).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import pipeline
from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec
from repro_torch.core.pipeline import StepOps

__all__ = [
    "cholesky_unblocked",
    "cholesky_panel",
    "cholesky_blocked",
    "cholesky_tiled",
    "cholesky_lookahead",
    "CHOLESKY_OPS",
]


def cholesky_unblocked(a: torch.Tensor) -> torch.Tensor:
    """Unblocked right-looking Cholesky of an (nb × nb) SPD block, in place
    (lower; the upper triangle is zeroed); returns ``a``.

    Each step takes an IEEE square root, one division, then the outer
    product and the difference as two ops, each rounded once — the
    rounding that the fused Cholesky panel-update kernel repeats.
    """
    nb = a.shape[0]
    for j in range(nb):
        d = torch.sqrt(a[j, j])
        if j + 1 < nb:
            col = a[j + 1 :, j] / d
            outer = col[:, None] * col[None, :]
            a[j + 1 :, j + 1 :] -= outer
            a[j + 1 :, j] = col
        a[j, j] = d
    return a.tril_()


def cholesky_panel(panel: torch.Tensor, nb: int, backend="cuda") -> torch.Tensor:
    """PF for Cholesky composed of PyTorch ops and the backend's TRSM:
    factor the (m × nb) panel (diagonal block and the rows below it) in
    place; returns ``panel``.  The engine takes it where the backend has no
    Cholesky panel kernel (``backend="torch"``); the ``"cuda"`` backend's
    is ``kernels.fused_panel_update.cholesky_panel``, which rounds as this
    composition does on the card."""
    l11 = cholesky_unblocked(panel[:nb])
    if panel.shape[0] > nb:
        l21 = panel[nb:]
        resolve_backend(backend).trsm(l11, l21, side="right", lower=True,
                                      trans=True, out=l21)
    return panel


# ---------------------------------------------------------------------------
# The StepOps declaration.
# ---------------------------------------------------------------------------
def _init(a):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(
            f"Cholesky needs a square matrix, got {tuple(a.shape)}")
    return a, None


def _factor(state, st, backend, panel_fn):
    # PF(k): ``panel_fn`` has the `cholesky_panel` signature
    # ``(m × nb panel, nb, backend) -> factored panel`` and works in place.
    a, _ = state
    k, bk = st.k, st.bk
    (panel_fn or cholesky_panel)(a[k:, k : k + bk], bk, backend)
    return state, None


def _update(state, ctx, st, c0, c1, backend):
    # TU_k on columns [c0, c1): A[c0:, c0:c1] -= L[c0:, k] · L[c0:c1, k]ᵀ.
    # Rows start at c0 — entries above are strictly upper and never read.
    a, _ = state
    k, bk = st.k, st.bk
    lrow_t = a[c0:c1, k : k + bk].mT.contiguous()
    backend.update(a[c0:, c0:c1], a[c0:, k : k + bk], lrow_t)
    return state


def _tiles(state, ctx, st, backend):
    # RTM: one update task per b×b tile of the lower trailing triangle.
    a, _ = state
    n = a.shape[0]
    k, bk = st.k, st.bk
    for j in range(st.k_next, n, bk):
        cols = slice(j, min(j + bk, n))
        lj_t = a[cols, k : k + bk].mT.contiguous()
        for i in range(j, n, bk):
            rows = slice(i, min(i + bk, n))
            backend.update(a[rows, cols], a[rows, k : k + bk], lj_t)
    return state


def _pu(state, ctx, st, st_next, backend, fused):
    # LA_MB: update + PF of the next block column in one kernel —
    # ``fused(lrow_next, l21, panel)`` factors ``panel`` in place.
    a, _ = state
    k, bk, k_next = st.k, st.bk, st.k_next
    lcols = slice(st_next.k, st_next.k_next)
    fused(a[lcols, k : k + bk], a[k_next:, k : k + bk], a[k_next:, lcols])
    return state, None


CHOLESKY_OPS = StepOps(
    name="cholesky",
    init=_init,
    factor=_factor,
    update=_update,
    finalize=lambda state: state[0].tril_(),
    tiles=_tiles,
    pu=_pu,
)


# ---------------------------------------------------------------------------
# Public drivers — thin engine wrappers.  Each copies ``a`` once to
# ``device`` (None = the GPU) and returns the lower factor L.
# ---------------------------------------------------------------------------
def cholesky_blocked(a, b: BlockSpec = 128, *, backend="cuda",
                     panel_fn: Optional[Callable] = None, device=None,
                     mesh=None, layout=None):
    """Right-looking blocked Cholesky (MTB)."""
    return pipeline.factorize(CHOLESKY_OPS, a, b, variant="mtb",
                              backend=backend, panel_fn=panel_fn,
                              device=device, mesh=mesh, layout=layout)


def cholesky_tiled(a, b: BlockSpec = 128, *, backend="cuda",
                   panel_fn: Optional[Callable] = None, device=None,
                   mesh=None, layout=None):
    """Blocked Cholesky with the trailing update fragmented into b×b tile
    tasks (RTM)."""
    return pipeline.factorize(CHOLESKY_OPS, a, b, variant="rtm",
                              backend=backend, panel_fn=panel_fn,
                              device=device, mesh=mesh, layout=layout)


@pipeline.mark_depth_capable
def cholesky_lookahead(a, b: BlockSpec = 128, *, backend="cuda",
                       panel_fn: Optional[Callable] = None,
                       fused_pu: Optional[Callable] = None, depth: int = 1,
                       device=None, mesh=None, layout=None):
    """Cholesky with static look-ahead; ``depth`` panels in flight.

    ``fused_pu``: a fused panel update ``(lrow, l21, panel) -> panel`` that
    applies the update to the next block column and factors it in place,
    in one kernel (LA_MB).
    """
    return pipeline.factorize(CHOLESKY_OPS, a, b, variant="la", depth=depth,
                              backend=backend, panel_fn=panel_fn,
                              fused_pu=fused_pu, device=device, mesh=mesh,
                              layout=layout)
