"""Matrix inversion by blocked Gauss–Jordan elimination (GJE).

The port of :mod:`repro.core.gauss_jordan`.  Unlike the one-sided DMFs,
each iteration updates every column, left and right of the panel, so the
trailing-update : panel cost ratio is even larger.  Declared as
:data:`GAUSS_JORDAN_OPS` and scheduled by :mod:`repro_torch.core.pipeline`,
with the engine's two-sided hooks: ``update_left`` (the already inverted
columns left of the panel) and ``commit`` (the panel's own columns become
``I[:, kr] − M`` after the updates) form each iteration's epilogue;
``update_all`` is ``mtb``'s one bulk op.

Unpivoted (valid for SPD and diagonally dominant inputs, as in the
reference).  After the sweep the working copy holds ``A⁻¹``.

Blocked step for panel k (columns ``kc``, rows ``kr``, the same range):

    D   = A[kr, kc]                  (b × b)
    M   = (A[:, kc] − I[:, kr])·D⁻¹  (n × b)  — the panel factorization
    A[:, other] −= M·A[kr, other]            — the update (GEMM)
    A[:, kc]     = I[:, kr] − M              — the commit

In place.  ``D⁻¹`` is :func:`gj_inverse_unblocked` on a copy of the
diagonal block (PyTorch ops; the reference traces it, no TPU kernel
computes it) and ``M`` one β = 0 GEMM of the backend.  Every update —
``update``'s column ranges, ``update_left`` and ``update_all`` — is the
backend's in-place GEMM-accumulate over all n rows.  Its B operand is the
row block ``A[kr, c0:c1]``, which lies inside the columns being written,
and the GEMM kernel does not guard against aliasing, so each update first
copies that ``b × (c1 − c0)`` block.  With one op for every range, ``mtb``'s
bulk update and ``la``'s column ranges take the same roundings on a
column-decomposable backend (``"cuda"``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import pipeline
from repro_torch.core.blocking import BlockSpec
from repro_torch.core.pipeline import StepOps

__all__ = ["gj_inverse_unblocked", "gj_inverse_blocked",
           "gj_inverse_lookahead", "GAUSS_JORDAN_OPS"]


def gj_inverse_unblocked(a: torch.Tensor) -> torch.Tensor:
    """Unblocked Gauss–Jordan inversion (no pivoting) of a square ``a``, in
    place; returns ``a``, which then holds ``a⁻¹``."""
    n = a.shape[0]
    for j in range(n):
        p = a[j, j].clone()
        rowj = a[j] / p
        colj = a[:, j].clone()
        upd = colj[:, None] * rowj[None, :]
        upd[j] = 0.0
        a -= upd
        a[j] = rowj
        a[:, j] = colj / -p
        a[j, j] = 1.0 / p
    return a


def _gj_panel(a: torch.Tensor, k: int, bk: int, backend,
              inv_fn: Optional[Callable] = None) -> torch.Tensor:
    """M = (A[:, kc] − I[:, kr])·D⁻¹ for panel k; a new n × bk tensor.

    ``inv_fn`` (the panel-kernel hook) replaces
    :func:`gj_inverse_unblocked`: it gets a copy of the diagonal block,
    which it may overwrite, and returns that block's inverse.
    """
    dinv = (inv_fn or gj_inverse_unblocked)(a[k : k + bk, k : k + bk].clone())
    p = a[:, k : k + bk].clone()
    p[k : k + bk].diagonal().sub_(1.0)
    return backend.gemm(p, dinv)


# ---------------------------------------------------------------------------
# The StepOps declaration.
# ---------------------------------------------------------------------------
class _GJCtx(NamedTuple):
    m: torch.Tensor            # the n × bk multiplier block M of this panel


def _init(a):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(
            f"Gauss-Jordan needs a square matrix, got {tuple(a.shape)}")
    return a, None


def _factor(state, st, backend, panel_fn):
    # "PF(k)": D⁻¹ and M.  The panel's columns are not written here — the
    # commit finalizes them after the iteration's updates.
    a, _ = state
    return state, _GJCtx(_gj_panel(a, st.k, st.bk, backend, panel_fn))


def _update(state, ctx, st, c0, c1, backend):
    # TU_k on columns [c0, c1): all n rows, A[:, c] −= M·A[kr, c]; the row
    # block is copied first (it lies inside the columns written).
    a, _ = state
    row = a[st.k : st.k + st.bk, c0:c1].clone()
    backend.update(a[:, c0:c1], ctx.m, row)
    return state


def _update_left(state, ctx, st, backend):
    # the already inverted columns [0, k) — GJE's two-sided update
    return _update(state, ctx, st, 0, st.k, backend)


def _commit(state, ctx, st, backend):
    a, _ = state
    k, bk = st.k, st.bk
    cols = a[:, k : k + bk]
    cols.copy_(ctx.m).neg_()
    cols[k : k + bk].diagonal().add_(1.0)
    return state


def _update_all(state, ctx, st, backend):
    # mtb's one op: one update of every column (the panel's own are
    # recomputed, then overwritten by the commit), exactly the blocked GJE
    # sweep
    state = _update(state, ctx, st, 0, state[0].shape[1], backend)
    return _commit(state, ctx, st, backend)


GAUSS_JORDAN_OPS = StepOps(
    name="gauss_jordan",
    init=_init,
    factor=_factor,
    update=_update,
    finalize=lambda state: state[0],
    update_left=_update_left,
    update_all=_update_all,
    commit=_commit,
)


# ---------------------------------------------------------------------------
# Public drivers — thin engine wrappers.  Each copies ``a`` once to
# ``device`` (None = the GPU) and returns ``A⁻¹``.
# ---------------------------------------------------------------------------
def gj_inverse_blocked(a, b: BlockSpec = 128, *, backend="cuda",
                       panel_fn: Optional[Callable] = None, device=None):
    """Blocked GJE inversion (MTB: one update op per iteration)."""
    return pipeline.factorize(GAUSS_JORDAN_OPS, a, b, variant="mtb",
                              backend=backend, panel_fn=panel_fn,
                              device=device)


@pipeline.mark_depth_capable
def gj_inverse_lookahead(a, b: BlockSpec = 128, *, backend="cuda",
                         panel_fn: Optional[Callable] = None, depth: int = 1,
                         device=None):
    """GJE inversion with static look-ahead; ``depth`` panels in flight.

    ``PU(k+1)`` updates the next panel's columns with panel k's ``M`` and
    computes the next ``D⁻¹``/``M`` right away, independent of the update
    of the remaining columns (``TU_right``) and of the epilogue, which
    updates the inverted columns to the left.
    """
    return pipeline.factorize(GAUSS_JORDAN_OPS, a, b, variant="la",
                              depth=depth, backend=backend, panel_fn=panel_fn,
                              device=device)
