"""Two-sided reduction to band form — stage 1 of the SVD (paper §6.4).

The port of :mod:`repro.core.band_reduction`.  Großer–Lang style blocked
reduction: at step k (offset ``o = k·w``)

1. QR-factor the panel ``A[o:, o:o+w]`` → zeros below the diagonal,
2. apply ``Qᴸᵀ`` to the trailing columns,
3. LQ-factor the row block ``A[o:o+w, o+w:]`` → zeros right of the band,
4. apply ``Qᴿ`` to the trailing rows.

The result is upper triangular with superdiagonal bandwidth ``w``, and has
A's singular values (an orthogonal equivalence).  Flop count: 8n³/3.

Look-ahead (:func:`band_reduction_lookahead`): the wide product
``W = A·V_R·T_R`` of the right update is shared between ``PU(k+1)`` — the
update of the next QR panel's columns, then its factorization — and
``TU_right``, the update of the remaining columns, which does not depend
on it.

As in the reference, band reduction stays outside the generic engine: its
iteration couples two panel factorizations (left QR, right LQ), so it
keeps a loop of its own, is not depth-capable, and shares only the panel
traversal and the ``panel_fn=`` hook with the engine's DMFs.

Tracing: with a tracer installed each panel is a ``PF`` span (``QR(k)``,
``LQ(k)``, under look-ahead ``QR(k+1)`` ahead of ``TU_right``), each
update a ``TU`` span (``TUL(k)`` left, ``TUR(k)`` right, under look-ahead
also ``W(k)``, the shared product) and look-ahead's narrow update of the
next panel a ``PU`` span, tagged as the engine's spans are.

In place on one working copy.  Both panels go through the QR panel hook
``(panel) -> (panel, tau, T)``: the caller's ``panel_fn``, else the
backend's ``panel_fns["qr"]`` (on ``"cuda"`` the ``qr_panel`` kernel),
else the plain GEQR2 + LARFT (:func:`repro_torch.core.qr.qr_panel_plain`).
The LQ panel factors ``Aᵀ`` of a row block; the kernel needs unit stride
in the last dimension, so it gets a contiguous copy of that transpose.
The updates are the backend's GEMMs and in-place GEMM-accumulates.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.blocking import BlockSpec, normalize_block, panel_steps
from repro_torch.core.pipeline import _call
from repro_torch.core.qr import Panel, apply_qt_blocked
from repro_torch.core.qr import _hooked_factor_panel as _qr_panel
from repro_torch.device import resolve_device, working_copy
from repro_torch.obs import tracer as _obs

__all__ = ["band_reduction_blocked", "band_reduction_lookahead",
           "check_uniform_tiling"]


def check_uniform_tiling(n: int, w: BlockSpec) -> None:
    """Band reduction needs a uniform schedule that tiles ``n`` exactly:
    ``w`` is the output bandwidth, so it cannot vary mid-sweep.  A scalar
    must divide n; an explicit schedule must be one width that does."""
    spec = normalize_block(w)
    if isinstance(spec, int):
        if n % spec:
            raise ValueError(
                f"band reduction requires n % w == 0 (n={n}, w={spec})")
        return
    # the requested widths, not the clipped expansion: [128] on n = 96
    # would expand to a "uniform" (96,) and reduce nothing
    if len(set(spec)) > 1 or n % spec[0]:
        raise ValueError(
            f"band reduction requires a uniform schedule tiling n={n} "
            f"exactly (w is the output bandwidth); got schedule {spec}")


def _setup(a, w, backend, panel_fn, device):
    be = resolve_backend(backend)
    work = working_copy(a, resolve_device(device))
    if work.dim() != 2 or work.shape[0] != work.shape[1]:
        raise ValueError(
            f"band reduction needs a square matrix, got {tuple(work.shape)}")
    check_uniform_tiling(work.shape[0], w)
    if panel_fn is None and be.panel_fns is not None:
        panel_fn = be.panel_fns.get("qr")
    return be, work, panel_fn


def _left_panel(panel: torch.Tensor, bw: int, panel_fn) -> Panel:
    """QR of the (m × bw) ``panel`` in place; leaves R on top and zeros
    below it, and returns the reflector."""
    _, pnl = _qr_panel(panel, panel_fn)
    panel[:bw].triu_()
    panel[bw:].zero_()
    return pnl


def _right_panel(a_rows: torch.Tensor, panel_fn) -> Panel:
    """LQ of the (w × m) row block ``a_rows`` via QR of its transpose.

    Overwrites ``a_rows`` with ``[Rᵀ 0]`` and returns the reflector:
    ``Q = I − V·T·Vᵀ`` (m × m) is the right transform for the trailing
    rows.
    """
    w = a_rows.shape[0]
    work = a_rows.mT.contiguous()                     # (m × w)
    _, pnl = _qr_panel(work, panel_fn)
    a_rows.zero_()
    a_rows[:, :w] = work[:w].triu_().mT
    return pnl


def _t(pnl: Panel) -> torch.Tensor:
    return pnl.tt.mT.contiguous()


def _apply_right(c: torch.Tensor, pnl: Panel,
                 backend: Backend) -> torch.Tensor:
    """``C ← C·(I − V·T·Vᵀ)`` in place — the LQ transform from the right;
    returns ``c``."""
    w = backend.gemm(backend.gemm(c, pnl.v), _t(pnl))  # (rows × w)
    return backend.update(c, w, pnl.vt)


def band_reduction_blocked(a, w: BlockSpec = 128, *, backend="cuda",
                           panel_fn: Optional[Callable] = None, device=None):
    """Blocked two-sided reduction to band width ``w`` (MTB).  Copies ``a``
    once to ``device`` (None = the GPU) and returns the band matrix."""
    be, a, panel_fn = _setup(a, w, backend, panel_fn, device)
    tr = _obs.active()
    n = a.shape[0]
    for i, st in enumerate(panel_steps(n, w)):
        o, bw, nxt = st.k, st.bk, st.k_next
        pnl = _call(tr, "PF", f"QR({i})",
                    lambda: _left_panel(a[o:, o : o + bw], bw, panel_fn),
                    step=i, it=i)
        if nxt < n:
            _call(tr, "TU", f"TUL({i})",
                  lambda: apply_qt_blocked(pnl, a[o:, nxt:], be),
                  step=i, it=i, cols=(nxt, n))
            rpnl = _call(tr, "PF", f"LQ({i})",
                         lambda: _right_panel(a[o : o + bw, nxt:], panel_fn),
                         step=i, it=i)
            _call(tr, "TU", f"TUR({i})",
                  lambda: _apply_right(a[nxt:, nxt:], rpnl, be),
                  step=i, it=i, cols=(nxt, n))
    return a


def band_reduction_lookahead(a, w: BlockSpec = 128, *, backend="cuda",
                             panel_fn: Optional[Callable] = None,
                             device=None):
    """Band reduction with look-ahead on the right update (module doc)."""
    be, a, panel_fn = _setup(a, w, backend, panel_fn, device)
    tr = _obs.active()
    n = a.shape[0]
    pnl_next = None                       # the next QR panel, pre-factored
    for i, st in enumerate(panel_steps(n, w)):
        o, bw, nxt = st.k, st.bk, st.k_next
        panel = a[o:, o : o + bw]
        if pnl_next is None:
            pnl = _call(tr, "PF", f"QR({i})",
                        lambda: _left_panel(panel, bw, panel_fn),
                        step=i, it=i)
        else:
            pnl = pnl_next
            panel[:bw].triu_()
            panel[bw:].zero_()
        pnl_next = None
        if nxt >= n:
            break
        # left update of the whole trailing block (the LQ row panel needs it)
        _call(tr, "TU", f"TUL({i})",
              lambda: apply_qt_blocked(pnl, a[o:, nxt:], be),
              step=i, it=i, cols=(nxt, n))
        rpnl = _call(tr, "PF", f"LQ({i})",
                     lambda: _right_panel(a[o : o + bw, nxt:], panel_fn),
                     step=i, it=i)
        # the shared wide product W = A·V_R·T_R
        c = a[nxt:, nxt:]
        wprod = _call(tr, "TU", f"W({i})",
                      lambda: be.gemm(be.gemm(c, rpnl.v), _t(rpnl)),
                      step=i, it=i)
        b_next = st.b_next
        # PU(k+1): the next panel's columns, then their QR ...
        _call(tr, "PU", f"PU({i}->{i + 1})",
              lambda: be.update(c[:, :b_next], wprod, rpnl.vt[:, :b_next]),
              step=i, it=i, depth=1, cols=(nxt, nxt + b_next))
        _, pnl_next = _call(tr, "PF", f"QR({i + 1})",
                            lambda: _qr_panel(c[:, :b_next], panel_fn),
                            step=i + 1, it=i, depth=1)
        # ... and TU_right, independent of PU(k+1)
        if b_next < c.shape[1]:
            _call(tr, "TU", f"TUR({i})",
                  lambda: be.update(c[:, b_next:], wprod,
                                    rpnl.vt[:, b_next:]),
                  step=i, it=i, cols=(nxt + b_next, n), inflight=1)
    return a
