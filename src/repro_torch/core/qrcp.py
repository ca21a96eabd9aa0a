"""QR with column pivoting — global GEQP3 and windowed ``qrcp_local``.

The port of :mod:`repro.core.qrcp`.  Both policies share the QR packing,
with ``a[:, jpvt] == Q·R`` (``jpvt[j]`` is the original index of the column
placed at position ``j``), so :func:`repro_torch.core.qr.form_q` applies.

**Global pivoting (:data:`QRCP_OPS`, GEQP3).**  The panel is xLAQPS
(:func:`repro_torch.kernels.panel_qrcp.qrcp_panel`) over the whole
trailing block: greedy pivot by partial column norm, exact norm downdate,
only the pivot rows of the trailing columns updated in the panel; the
rows below are updated by the engine's trailing update as one GEMM,
``A₂ ← A₂ − V₂·Fᵀ``.  The panel reads every trailing column, so
``la`` would pre-factor from stale norms — a different factorization:
:data:`QRCP_OPS` declares ``la_unsafe`` and runs under ``mtb``/``rtm``
only.

**Windowed pivoting (:data:`QRCP_LOCAL_OPS`, ``qrcp_local``).**  The pivot
search stays inside the panel's window, so the panel reads only its own
columns and look-ahead is legal (``la``/``la<d>``); ``|r_jj|`` is
non-increasing only within each window.  The trailing update is GEQRF's
compact-WY apply, with T from the ``larft`` kernel.

Column interchanges.  The panel swaps whole columns of the rows it holds;
the ``swap`` hook replays the panel's interchanges on the R rows above it
(the column analogue of LU's ``laswp``), and ``jpvt`` takes the same
interchanges.  Both compose the panel's swap sequence into one gather:
the panel's ``piv`` is read on the host once per panel (one device-to-host
copy), as the port's LU ``laswp`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import pipeline
from repro_torch.core.lu import _moved_rows
from repro_torch.core.pipeline import StepOps
from repro_torch.core.qr import (Panel, apply_qt_blocked, build_t_matrix,
                                 larft_plain)

__all__ = ["qrcp_blocked", "qrcp_tiled", "QRCP_OPS",
           "qrcp_local_blocked", "qrcp_local_tiled", "qrcp_local_lookahead",
           "QRCP_LOCAL_OPS"]


def _default_panel(block, steps):
    # Without a hook (``backend="torch"``) the panel runs as plain ops; the
    # ``"cuda"`` backend supplies the kernel through ``panel_fns``.
    from repro_torch.kernels.panel_qrcp import qrcp_panel_plain

    return qrcp_panel_plain(block, steps)


def _init(a):
    if a.dim() != 2:
        raise ValueError(f"QRCP needs a matrix, got shape {tuple(a.shape)}")
    taus = torch.zeros((min(a.shape),), dtype=a.dtype, device=a.device)
    jpvt = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)
    return a, (taus, jpvt)


def _replay_pivots(x: torch.Tensor, moved) -> torch.Tensor:
    """Apply a panel's composed interchanges (``_moved_rows`` output, or
    None for none) along the first dimension of ``x``, in place."""
    if moved is not None:
        dst, src = moved
        x[dst] = x[src]
    return x


class _QRCPCtx(NamedTuple):
    v: torch.Tensor           # (m−k) × steps reflectors, unit diagonal
    f: torch.Tensor           # (n−k) × steps, F = B₀ᵀ·V·T (a view of Fᵀ)
    moved: Optional[tuple]    # the panel's interchanges, composed


def _factor(state, st, backend, panel_fn):
    # PF(k): xLAQPS over the whole trailing block, in place.
    a, (taus, jpvt) = state
    m = a.shape[0]
    k, bk = st.k, st.bk
    steps = min(bk, m - k)
    _, v, f, tau, piv = (panel_fn or _default_panel)(a[k:, k:], steps)
    taus[k : k + steps] = tau
    moved = _moved_rows(piv, 0, a.device)
    _replay_pivots(jpvt[k:], moved)
    return state, _QRCPCtx(v, f, moved)


def _swap(state, ctx, st, backend):
    # Panel-k interchanges replayed on the R rows above the panel (rows k:
    # were swapped inside the panel).
    a = state[0]
    if st.k > 0:
        _replay_pivots(a[: st.k, st.k :].mT, ctx.moved)
    return state


def _update(state, ctx, st, c0, c1, backend):
    # TU_k on columns [c0, c1): the deferred A₂ ← A₂ − V₂·Fᵀ; rows
    # k .. k+steps−1 were completed by the panel's pivot-row updates.
    a = state[0]
    steps = ctx.v.shape[1]
    r0 = st.k + steps
    if r0 < a.shape[0] and c0 < c1:
        backend.update(a[r0:, c0:c1], ctx.v[steps:],
                       ctx.f[c0 - st.k : c1 - st.k].mT)
    return state


def _tiles(state, ctx, st, backend):
    # RTM: one deferred-update task per trailing column panel.
    n = state[0].shape[1]
    for j in range(st.k_next, n, st.bk):
        state = _update(state, ctx, st, j, min(j + st.bk, n), backend)
    return state


def _rows_left(state, st):
    return st.k < state[0].shape[0]


QRCP_OPS = StepOps(
    name="qrcp",
    init=_init,
    factor=_factor,
    update=_update,
    finalize=lambda state: (state[0], state[1][0], state[1][1]),
    swap=_swap,
    tiles=_tiles,
    # m < n: factorable panels end once the rows are exhausted; the panel's
    # pivot-row updates complete R for the columns beyond them
    stop=lambda state, st: not _rows_left(state, st),
    can_factor=_rows_left,
    width=lambda a: a.shape[1],
    la_unsafe="GEQP3's greedy pivot reads the downdated norms of every "
              "trailing column after TU_k, so PF(k+1) ahead of TU_k^R "
              "would commit pivots from stale norms (DESIGN.md §11)",
)


# ---------------------------------------------------------------------------
# Windowed pivoting: pivots restricted to the panel window.
# ---------------------------------------------------------------------------
class _QRCPLocalCtx(NamedTuple):
    wy: Panel                 # compact-WY reflector of the panel
    moved: Optional[tuple]    # the panel's interchanges, composed
    k: int                    # panel origin: guards the lazy swap replay
    w: int                    # panel width: the extent the pivots permute


def _factor_local(state, st, backend, panel_fn):
    # PF(k): the same xLAQPS panel, handed a window exactly `bk` columns
    # wide, so the pivot search never sees trailing data.
    a, (taus, jpvt) = state
    m = a.shape[0]
    k, bk = st.k, st.bk
    steps = min(bk, m - k)
    _, v, _, tau, piv = (panel_fn or _default_panel)(a[k:, k : k + bk], steps)
    taus[k : k + steps] = tau
    moved = _moved_rows(piv, 0, a.device)
    _replay_pivots(jpvt[k : k + bk], moved)
    # T by the larft kernel where the backend supplies the panel kernel,
    # else as plain ops (``backend="torch"``).
    t = (larft_plain if panel_fn is None else build_t_matrix)(v, tau)
    return state, _QRCPLocalCtx(Panel.of(v, t), moved, k, bk)


def _swap_local(state, ctx, st, backend):
    # Panel-k interchanges on the R rows above the panel, inside its window.
    # Under la the engine replays swaps with whatever ctx is in flight; the
    # ctx.k guard keeps the replay idempotent when the look-ahead has run
    # out of factorable panels (wide inputs) and ctx is stale.
    a = state[0]
    k = st.k
    if ctx is None or ctx.k != k or k == 0:
        return state
    _replay_pivots(a[:k, k : k + ctx.w].mT, ctx.moved)
    return state


def _update_local(state, ctx, st, c0, c1, backend):
    # TU_k on columns [c0, c1): GEQRF's compact-WY Qᵀ apply.
    apply_qt_blocked(ctx.wy, state[0][st.k :, c0:c1], backend)
    return state


def _tiles_local(state, ctx, st, backend):
    n = state[0].shape[1]
    for j in range(st.k_next, n, st.bk):
        state = _update_local(state, ctx, st, j, min(j + st.bk, n), backend)
    return state


QRCP_LOCAL_OPS = StepOps(
    name="qrcp_local",
    init=_init,
    factor=_factor_local,
    update=_update_local,
    finalize=lambda state: (state[0], state[1][0], state[1][1]),
    swap=_swap_local,
    tiles=_tiles_local,
    stop=lambda state, st: not _rows_left(state, st),
    can_factor=_rows_left,
    width=lambda a: a.shape[1],
)


# ---------------------------------------------------------------------------
# Public drivers.  Each copies ``a`` once to ``device`` (None = the GPU)
# and returns (packed, taus, jpvt).
# ---------------------------------------------------------------------------
def _driver(ops: StepOps, variant: str, doc: str):
    def driver(a, b=128, **kw):
        return pipeline.factorize(ops, a, b, variant=variant, **kw)

    driver.__name__ = driver.__qualname__ = f"{ops.name}_{variant}"
    driver.__doc__ = doc
    if variant == "la":
        pipeline.mark_depth_capable(driver)
    return driver


qrcp_blocked = _driver(QRCP_OPS, "mtb", """Blocked GEQP3 (MTB).  Returns
(packed, taus, jpvt): R on/above the diagonal, reflectors below it,
``a[:, jpvt] == Q·R``.""")
qrcp_tiled = _driver(QRCP_OPS, "rtm", """GEQP3 with the deferred trailing
update fragmented into per-column-panel tasks (RTM).""")
qrcp_local_blocked = _driver(QRCP_LOCAL_OPS, "mtb", """Windowed-pivoting
QRCP (MTB): pivots stay inside each panel window; ``|diag R|`` is
non-increasing within each window only.""")
qrcp_local_tiled = _driver(QRCP_LOCAL_OPS, "rtm", """Windowed-pivoting QRCP
with the trailing update fragmented into per-column-panel tasks (RTM).""")
qrcp_local_lookahead = _driver(QRCP_LOCAL_OPS, "la", """Windowed-pivoting
QRCP with static look-ahead (``depth=d`` panels in flight): the pivot
search never leaves the window, so PF(k+1) after the narrow update is the
same computation as after the full update.""")
