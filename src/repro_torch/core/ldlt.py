"""LDLᵀ factorization (symmetric indefinite, no pivoting) — all scheduling
variants.

The port of :mod:`repro.core.ldlt`.  ``A = L·D·Lᵀ`` with unit-lower L and
diagonal D, unpivoted: valid for quasi-definite and diagonally dominant
symmetric matrices (Bunch–Kaufman pivoting is out of scope, as in the
reference).  Declared once as :data:`LDLT_OPS`; the engine in
:mod:`repro_torch.core.pipeline` emits

* :func:`ldlt_blocked`   — right-looking blocked LDLᵀ, the **MTB** variant;
* :func:`ldlt_lookahead` — **LA**, ``depth`` panels in flight.  No backend
  has a fused LDLᵀ panel update, so ``la_mb`` resolves to ``la``.

There is no RTM variant (the paper's RTM study covers the three canonical
DMFs only).

Packed format: L strictly below the diagonal (unit diagonal implicit), D
on it; the result is ``tril``'d.

The panel (PF) is :func:`ldlt_panel`: the diagonal sweep
:func:`ldlt_unblocked` as PyTorch ops (the reference traces it; no TPU
kernel computes it), then ``L21 = A21·L11⁻ᵀ·D⁻¹`` through the backend's
right, lower, transposed, unit-diagonal TRSM — on the ``"cuda"`` backend
the ``trsm_right_lower_t`` kernel — and one division.  The trailing update
(TU) is the backend's in-place GEMM-accumulate with ``W = L[c0:c1, k]·D_k``,
whose transpose the hook hands the kernel as a contiguous copy
(``(c1 − c0) × b`` values).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import pipeline
from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec
from repro_torch.core.pipeline import StepOps

__all__ = ["ldlt_unblocked", "ldlt_panel", "ldlt_blocked", "ldlt_lookahead",
           "unpack_ldlt", "LDLT_OPS"]


def ldlt_unblocked(a: torch.Tensor) -> torch.Tensor:
    """Unblocked right-looking LDLᵀ of an (nb × nb) symmetric block, in
    place (the upper triangle is zeroed); returns ``a``.

    Each step divides the column by the pivot ``d``, subtracts
    ``(l·lᵀ)·d`` from the trailing block (two products and the
    difference, each rounded once, as the reference orders them) and
    stores ``l``.
    """
    nb = a.shape[0]
    for j in range(nb - 1):
        d = a[j, j]
        l = a[j + 1 :, j] / d
        a[j + 1 :, j + 1 :] -= (l[:, None] * l[None, :]) * d
        a[j + 1 :, j] = l
    return a.tril_()


def ldlt_panel(panel: torch.Tensor, nb: int, backend="cuda") -> torch.Tensor:
    """PF for LDLᵀ: factor the (m × nb) panel in place — the diagonal
    block by :func:`ldlt_unblocked`, then ``L21 = A21·L11⁻ᵀ·D⁻¹`` (the
    backend's unit-diagonal right TRSM, then one division); returns
    ``panel``."""
    fac = ldlt_unblocked(panel[:nb])
    if panel.shape[0] > nb:
        x = panel[nb:]
        resolve_backend(backend).trsm(fac, x, side="right", lower=True,
                                      trans=True, unit_diagonal=True, out=x)
        x /= torch.diagonal(fac)[None, :]
    return panel


def unpack_ldlt(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split packed LDLᵀ into (unit-lower L, diagonal d); new tensors."""
    l = torch.tril(packed, -1)
    l.diagonal().fill_(1.0)
    return l, torch.diagonal(packed).clone()


# ---------------------------------------------------------------------------
# The StepOps declaration.
# ---------------------------------------------------------------------------
def _init(a):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"LDLT needs a square matrix, got {tuple(a.shape)}")
    return a, None


def _factor(state, st, backend, panel_fn):
    # PF(k): ``panel_fn`` has the `ldlt_panel` signature
    # ``(m × nb panel, nb, backend) -> factored panel`` and works in place.
    a, _ = state
    k, bk = st.k, st.bk
    (panel_fn or ldlt_panel)(a[k:, k : k + bk], bk, backend)
    return state, None


def _update(state, ctx, st, c0, c1, backend):
    # TU_k on [c0, c1): A[c0:, c0:c1] -= L[c0:, k] · (L[c0:c1, k]·D_k)ᵀ.
    # Rows start at c0 — entries above are strictly upper and never read.
    a, _ = state
    k, bk = st.k, st.bk
    d = torch.diagonal(a[k : k + bk, k : k + bk])
    w_t = (a[c0:c1, k : k + bk] * d[None, :]).mT.contiguous()
    backend.update(a[c0:, c0:c1], a[c0:, k : k + bk], w_t)
    return state


LDLT_OPS = StepOps(
    name="ldlt",
    init=_init,
    factor=_factor,
    update=_update,
    finalize=lambda state: state[0].tril_(),
)


# ---------------------------------------------------------------------------
# Public drivers — thin engine wrappers.  Each copies ``a`` once to
# ``device`` (None = the GPU) and returns the packed factor.
# ---------------------------------------------------------------------------
def ldlt_blocked(a, b: BlockSpec = 128, *, backend="cuda",
                 panel_fn: Optional[Callable] = None, device=None):
    """Blocked right-looking LDLᵀ (MTB)."""
    return pipeline.factorize(LDLT_OPS, a, b, variant="mtb", backend=backend,
                              panel_fn=panel_fn, device=device)


@pipeline.mark_depth_capable
def ldlt_lookahead(a, b: BlockSpec = 128, *, backend="cuda",
                   panel_fn: Optional[Callable] = None, depth: int = 1,
                   device=None):
    """LDLᵀ with static look-ahead; ``depth`` panels in flight."""
    return pipeline.factorize(LDLT_OPS, a, b, variant="la", depth=depth,
                              backend=backend, panel_fn=panel_fn,
                              device=device)
