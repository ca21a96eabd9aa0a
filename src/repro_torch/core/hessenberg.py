"""Blocked Hessenberg reduction (GEHRD semantics) — a two-sided StepOps DMF.

The port of :mod:`repro.core.hessenberg`.  Computes ``H = Qᵀ·A·Q`` with H
upper Hessenberg (zero below the first subdiagonal) and
``Q = H_0·H_1·…`` a product of Householder reflectors.  The iteration
factors a single panel, so it fits the one-panel StepOps contract; the
two-sidedness shows in the rows the trailing update touches (all of them:
the right transform ``A·Q`` reaches above the panel).

Panel factorization follows xLAHR2
(:func:`repro_torch.kernels.panel_hessenberg.hessenberg_panel`: the CUDA
kernel on the card, its plain version on the CPU): for panel column
``kj`` the updated column is ``(I − V·Tᵀ·Vᵀ)·(a₀[:, kj] − W·T·V[kj, :]ᵀ)``
with ``W = A₀·V``, then the reflector zeroing its rows ``kj+2:``.  The
per-column GEMV ``A₀·v_j`` reads the whole trailing matrix, so PF(k+1)
depends on all of TU_k: :data:`HESSENBERG_OPS` declares ``la_unsafe`` and
runs under ``mtb`` and ``rtm`` only.

Transposed operands.  The trailing update reads ``Vᵀ`` (twice) and
``Tᵀ``; ``factor`` makes one contiguous copy of each per panel and keeps it
in the panel's context, so ``update`` copies nothing whatever the
schedule (as ``repro_torch.core.qr.Panel``).

Packed format mirrors GEHRD: H on/above the first subdiagonal, reflector
``v_j`` below it in column ``j`` (implicit ``v[j+1] = 1``);
:func:`form_q_hess` rebuilds Q, :func:`unpack_hessenberg` extracts H.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import pipeline
from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec, panel_steps
from repro_torch.core.pipeline import StepOps
from repro_torch.core.qr import build_t_matrix
from repro_torch.kernels.panel_hessenberg import hessenberg_panel_plain

__all__ = ["hessenberg_blocked", "hessenberg_tiled", "unpack_hessenberg",
           "form_q_hess", "HESSENBERG_OPS"]


class _HessCtx(NamedTuple):
    v: torch.Tensor           # n × bk reflectors (col j: 0 to row k+j, 1 at k+j+1)
    vt: torch.Tensor          # Vᵀ, contiguous
    tt: torch.Tensor          # Tᵀ, contiguous (T: bk × bk, upper)
    y: torch.Tensor           # n × bk   Y = A₀·V·T (the right-update operand)


def _init(a):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(
            f"Hessenberg reduction is a similarity transform and needs a "
            f"square matrix, got shape {tuple(a.shape)}")
    return a, torch.zeros((a.shape[0],), dtype=a.dtype, device=a.device)


def _factor(state, st, backend, panel_fn):
    # PF(k), xLAHR2: the panel needs the whole matrix, because the running
    # W = A₀·V reads every trailing column (the la_unsafe reason).  Without
    # a hook (``backend="torch"``) it runs as plain ops; ``"cuda"`` supplies
    # the kernel through ``panel_fns``.
    a, taus = state
    k, bk = st.k, st.bk
    _, v, t, w, tau = (panel_fn or hessenberg_panel_plain)(a, k, bk)
    taus[k : k + bk] = tau
    y = backend.gemm(w, t)                # Y = A₀·V·T, one GEMM per panel
    return state, _HessCtx(v, v.mT.contiguous(), t.mT.contiguous(), y)


def _update(state, ctx, st, c0, c1, backend):
    # TU_k on columns [c0, c1): the right update on all rows (A·Q reaches
    # above the panel), then the left compact-WY apply on rows k+1:.
    a = state[0]
    r = st.k + 1
    cols = a[:, c0:c1]
    backend.update(cols, ctx.y, ctx.vt[:, c0:c1])
    low = cols[r:]
    z = backend.gemm(ctx.tt, backend.gemm(ctx.vt[:, r:], low))
    backend.update(low, ctx.v[r:], z)
    return state


def _tiles(state, ctx, st, backend):
    # RTM: one two-sided update task per trailing column panel.
    n = state[0].shape[0]
    for j in range(st.k_next, n, st.bk):
        state = _update(state, ctx, st, j, min(j + st.bk, n), backend)
    return state


HESSENBERG_OPS = StepOps(
    name="hessenberg",
    init=_init,
    factor=_factor,
    update=_update,
    finalize=lambda state: state,
    tiles=_tiles,
    la_unsafe="GEHRD's panel builds W = A₀·v with GEMVs over the whole "
              "trailing block, so PF(k+1) is data-dependent on TU_k^R — "
              "pre-factoring would read stale bulk columns (DESIGN.md §11)",
)


# ---------------------------------------------------------------------------
# Packed-format helpers (ORGHR analogues).
# ---------------------------------------------------------------------------
def unpack_hessenberg(packed: torch.Tensor) -> torch.Tensor:
    """Extract H (exactly zero below the first subdiagonal)."""
    return torch.triu(packed, -1)


def _panel_v(packed: torch.Tensor, k: int, bk: int) -> torch.Tensor:
    """The reflectors of panel ``k`` on rows ``k+1:`` as one masked op:
    column j holds the packed entries below row ``k+j+1``, a 1 at that row,
    and nothing for the columns ``k+j >= n − 2``, which reduced no rows."""
    n = packed.shape[0]
    dev = packed.device
    rows = torch.arange(k + 1, n, device=dev)[:, None]
    head = k + 1 + torch.arange(bk, device=dev)[None, :]   # v_j[k+j+1] = 1
    one = ((rows == head) & (head < n - 1)).to(packed.dtype)
    return torch.where(rows > head, packed[k + 1 :, k : k + bk], one)


def form_q_hess(packed: torch.Tensor, taus: torch.Tensor, b: BlockSpec = 128,
                *, backend="cuda") -> torch.Tensor:
    """Q (n × n) explicitly from GEHRD output (``A = Q·H·Qᵀ``).

    The panels are applied last to first; when panel ``k`` is applied, Q
    differs from I only in rows and columns ``> k``, and the panel's
    reflectors are zero on rows ``≤ k``, so the update is restricted to
    ``Q[k+1:, k+1:]``.
    """
    be = resolve_backend(backend)
    n = packed.shape[0]
    q = torch.eye(n, dtype=packed.dtype, device=packed.device)
    for st in reversed(list(panel_steps(n, b))):
        k, bk = st.k, st.bk
        if k >= n - 2:                    # every reflector is the identity
            continue
        v = _panel_v(packed, k, bk)
        t = build_t_matrix(v, taus[k : k + bk])
        qk = q[k + 1 :, k + 1 :]
        w = be.gemm(t, be.gemm(v.mT.contiguous(), qk))
        be.update(qk, v, w)
    return q


# ---------------------------------------------------------------------------
# Public drivers.  Each copies ``a`` once to ``device`` (None = the GPU)
# and returns (packed, taus).
# ---------------------------------------------------------------------------
def hessenberg_blocked(a, b: BlockSpec = 128, *, backend="cuda",
                       panel_fn=None, device=None):
    """Blocked GEHRD (MTB).  Returns ``(packed, taus)``: H on/above the
    first subdiagonal and the reflectors below it."""
    return pipeline.factorize(HESSENBERG_OPS, a, b, variant="mtb",
                              backend=backend, panel_fn=panel_fn,
                              device=device)


def hessenberg_tiled(a, b: BlockSpec = 128, *, backend="cuda",
                     panel_fn=None, device=None):
    """GEHRD with the two-sided trailing update fragmented into
    per-column-panel tasks (RTM).  Same output as
    :func:`hessenberg_blocked`."""
    return pipeline.factorize(HESSENBERG_OPS, a, b, variant="rtm",
                              backend=backend, panel_fn=panel_fn,
                              device=device)
