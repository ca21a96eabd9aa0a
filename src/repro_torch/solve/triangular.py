"""Blocked multi-RHS triangular substitution with static look-ahead.

The port of :mod:`repro.solve.triangular`.  A triangular solve with an
(n × nrhs) right-hand side walks the factorizations' panel schedule: per
panel a small diagonal solve (the "PF" analogue) and a GEMM update of the
remaining row panels (the "TU" analogue).  As in the look-ahead
factorizations, the update of the next panel's rows (PU) is issued before
the bulk update of the rest, so the next diagonal solve depends on the
small update only.

Both functions return a new tensor and leave ``rhs`` unchanged; inside,
the solve updates one working copy in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec, max_width, panel_steps

__all__ = ["trsm_blocked", "lu_solve_packed"]


def _offdiag(t: torch.Tensor, rows: slice, k: int, bk: int,
             trans: bool) -> torch.Tensor:
    """Block ``op(T)[rows, k:k+bk]``; a transposed read is made contiguous
    (the kernels take unit stride in the last dimension)."""
    if trans:
        return t[k : k + bk, rows].mT.contiguous()
    return t[rows, k : k + bk]


def trsm_blocked(
    t: torch.Tensor,
    rhs: torch.Tensor,
    *,
    lower: bool = True,
    trans: bool = False,
    unit_diagonal: bool = False,
    block: BlockSpec = 128,
    backend="cuda",
) -> torch.Tensor:
    """Solve ``op(T)·X = B`` for a multi-column B with blocked substitution.

    Each trailing update is split into (next-panel rows | rest).
    """
    be = resolve_backend(backend)
    n = t.shape[0]
    if rhs.shape[0] != n:
        raise ValueError(f"rhs rows {rhs.shape[0]} != matrix dim {n}")
    steps = list(panel_steps(n, block))
    forward = lower != trans  # lower·notrans / upper·trans march downward
    order = steps if forward else list(reversed(steps))
    x = rhs.clone()

    for i, st in enumerate(order):
        k, bk = st.k, st.bk
        xk = x[k : k + bk]
        be.trsm(t[k : k + bk, k : k + bk], xk, side="left", lower=lower,
                trans=trans, unit_diagonal=unit_diagonal, out=xk)

        if i + 1 == len(order):
            break
        nxt = order[i + 1]
        # PU: update the next panel's rows first (enables its solve) …
        pu = slice(nxt.k, nxt.k + nxt.bk)
        be.update(x[pu], _offdiag(t, pu, k, bk, trans), xk)
        # … TU_right: bulk update of the rest, data-independent of PU.
        rest = slice(pu.stop, n) if forward else slice(0, pu.start)
        if rest.start < rest.stop:
            be.update(x[rest], _offdiag(t, rest, k, bk, trans), xk)
    return x


def lu_solve_packed(
    lu: torch.Tensor,
    rhs: torch.Tensor,
    *,
    block: BlockSpec = 128,
    backend="cuda",
) -> torch.Tensor:
    """Solve ``L·U·X = B`` from a packed (already row-permuted) LU.

    On the ``"cuda"`` backend a system of at most one panel (n ≤ the
    widest block, and within the kernel's 256 rows) takes the fused small
    solve — both sweeps in one launch.  Everything else runs the blocked
    :func:`trsm_blocked` pair.
    """
    be = resolve_backend(backend)
    n = lu.shape[0]
    if be.name == "cuda":
        from repro_torch.kernels import ops as kops

        if n <= min(max_width(block), kops.SMALL_SOLVE_MAX_N):
            if rhs.shape[0] != n:
                raise ValueError(f"rhs rows {rhs.shape[0]} != matrix dim {n}")
            return kops.lu_solve_small(lu, rhs)
    y = trsm_blocked(lu, rhs, lower=True, unit_diagonal=True, block=block,
                     backend=be)
    return trsm_blocked(lu, y, lower=False, block=block, backend=be)
