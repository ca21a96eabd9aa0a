"""Householder QR (GEQRF semantics) — all scheduling variants.

The port of :mod:`repro.core.qr`.  Compact-WY blocked algorithm: each panel
produces Householder vectors ``V`` (packed below the diagonal, implicit
unit diagonal), scalars ``tau`` and the upper-triangular ``T`` with
``Q_panel = I − V·T·Vᵀ``; the trailing update is
``Qᵀ·C = C − V·(Tᵀ·(Vᵀ·C))``.  Declared once as :data:`QR_OPS`; the engine
in :mod:`repro_torch.core.pipeline` emits

* :func:`qr_blocked`   — **MTB**;
* :func:`qr_tiled`     — **RTM**: one Qᵀ-apply task per trailing column
  panel (the panel-fragmented version, as in the reference, so every
  variant gives the same GEQRF output);
* :func:`qr_lookahead` — **LA**, ``depth`` panels in flight.  QR has no
  fused panel-update kernel, so ``la_mb`` resolves to ``la``.

Wide inputs (m < n): the traversal stops once the rows are exhausted
(``stop``/``can_factor``), and the taus have length ``min(m, n)``.

The plain versions of the QR panel kernel live here, as the reference's
kernel body is :func:`qr_unblocked` + :func:`build_t_matrix`:
:func:`qr_panel_plain`, that is :func:`qr_unblocked` (GEQR2) and
:func:`larft_plain` (LARFT).  On CUDA
tensors :func:`build_t_matrix` launches the ``larft`` entry of the panel
kernel (``repro_torch.kernels.panel_qr``), so the solve's ``apply_qt``,
:func:`form_q` and the ``qrcp_local`` panels take one launch per panel
rather than a loop of ``nb`` PyTorch ops.

Transposed operands.  The GEMM kernel takes unit stride in the last
dimension, and the update reads ``Vᵀ`` and ``Tᵀ``.  ``factor`` therefore
makes one contiguous copy of each per panel and keeps it in the panel's
context (:class:`Panel`), so ``update`` — called once per panel under
``mtb``, ``1 + depth`` times under ``la``, once per column panel under
``rtm`` — copies nothing: two copies per panel (``Vᵀ``: ``(m − k) × b``
values, ``Tᵀ``: ``b × b``), besides ``V`` itself, which the reference
also unpacks.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import pipeline
from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.blocking import BlockSpec, panel_steps
from repro_torch.core.pipeline import StepOps

__all__ = [
    "pairwise_sum",
    "qr_unblocked",
    "householder_vector",
    "build_t_matrix",
    "larft_plain",
    "qr_panel_plain",
    "qr_blocked",
    "qr_tiled",
    "qr_lookahead",
    "unpack_v",
    "apply_qt_blocked",
    "form_q",
    "Panel",
    "QR_OPS",
]


def pairwise_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum of ``x`` along ``dim`` as an aligned binary tree: the length is
    padded with zeros to a power of two and adjacent pairs are added level
    by level.  A term's place in the tree depends on its index alone, so
    terms appended as zeros (a padded system's extra rows) leave the bits
    of the sum as they are, whatever the length; elementwise ops only, so
    no library reduction regroups the terms by shape.  The plain versions'
    reductions over rows go through it.
    """
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(x.shape[1:])
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _reflector(x: torch.Tensor, alpha: torch.Tensor):
    """``(tau, beta, denom)`` of the reflector for a column whose part at
    and below the diagonal is ``x`` (``x[0] == alpha``).

    ``beta = −sign(alpha)·‖x‖`` with ``sign(0) = +1``; a zero column
    (``‖x‖ == 0``) gives ``tau = 0`` and ``H = I``.  Tensor ops only, so no
    value goes to the host.
    """
    xnorm = torch.sqrt(pairwise_sum(x * x))
    one = torch.ones((), dtype=x.dtype, device=x.device)
    sign = torch.where(alpha >= 0, one, -one)
    beta = -sign * xnorm
    safe = xnorm > 0
    tau = torch.where(safe, (beta - alpha) / torch.where(safe, beta, one),
                      torch.zeros_like(one))
    denom = torch.where(safe, alpha - beta, one)
    return tau, torch.where(safe, beta, alpha), denom


def householder_vector(x: torch.Tensor, j: int):
    """Reflector ``H = I − tau·v·vᵀ`` zeroing ``x[j+1:]``, with ``v[j] = 1``.

    Returns ``(v, tau, beta)``: ``v`` zero above row ``j``, ``beta`` the
    new ``x[j]`` — the step of :func:`qr_unblocked`, same sign convention
    and degenerate-column guard.
    """
    tau, beta, denom = _reflector(x[j:], x[j])
    v = torch.zeros_like(x)
    v[j] = 1.0
    v[j + 1 :] = x[j + 1 :] / denom
    return v, tau, beta


def qr_unblocked(panel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GEQR2 of an (m × nb) panel, **in place**; returns ``(panel, tau)``.

    ``panel`` ends holding R on/above the diagonal and the Householder
    vectors below it (implicit ``v[j] = 1``); ``H_j = I − tau_j·v_j·v_jᵀ``,
    ``A = H_1·…·H_nb·R``.  ``tau`` has length ``nb``; only the first
    ``min(m, nb)`` columns get a reflector (the rest keep ``tau = 0``).
    Each column: ``w = tau·(vᵀ·A[:, j+1:])``, then ``A[:, j+1:] −= v·w``;
    the sums over rows are :func:`pairwise_sum`'s.
    """
    m, nb = panel.shape
    tau = torch.zeros(nb, dtype=panel.dtype, device=panel.device)
    for j in range(min(m, nb)):
        x = panel[j:, j]
        t, beta, denom = _reflector(x, x[0])
        v = x / denom
        v[0] = 1.0
        if j + 1 < nb:
            w = t * pairwise_sum(v[:, None] * panel[j:, j + 1 :])[None, :]
            panel[j:, j + 1 :] -= v[:, None] * w
        panel[j + 1 :, j] = v[1:]
        panel[j, j] = beta
        tau[j] = t
    return panel, tau


def unpack_v(packed: torch.Tensor, nb: int) -> torch.Tensor:
    """V (m × nb, unit diagonal, zero above it) from a packed panel; a new
    contiguous tensor."""
    v = torch.tril(packed[:, :nb], -1)
    v.diagonal().fill_(1.0)
    return v


def larft_plain(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """LARFT (forward, columnwise): T with ``H_1…H_nb = I − V·T·Vᵀ``.

    The plain version of the ``larft`` kernel: the Gram ``VᵀV``, its sums
    over the rows :func:`pairwise_sum`'s (taken 64 columns at a time),
    then ``T[:j, j] = −tau_j·T[:j, :j]·(VᵀV)[:j, j]``, ``T[j, j] = tau_j``.
    """
    nb = tau.shape[0]
    vtv = torch.cat([pairwise_sum(v[:, :nb, None] * v[:, None, j : j + 64])
                     for j in range(0, nb, 64)] or [v.new_zeros((0, 0))], 1)
    t = torch.zeros((nb, nb), dtype=v.dtype, device=v.device)
    for j in range(nb):
        if j:
            t[:j, j] = -tau[j] * (t[:j, :j] @ vtv[:j, j])
        t[j, j] = tau[j]
    return t


def qr_panel_plain(panel: torch.Tensor):
    """GEQR2 + LARFT as PyTorch ops, in place: ``(panel, tau, T)`` — the
    plain version of the QR panel kernel."""
    _, tau = qr_unblocked(panel)
    return panel, tau, larft_plain(unpack_v(panel, panel.shape[1]), tau)


def build_t_matrix(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """LARFT through :func:`repro_torch.kernels.panel_qr.larft`: the kernel
    on a CUDA tensor, :func:`larft_plain` on a CPU one."""
    from repro_torch.kernels.panel_qr import larft

    return larft(v, tau)


class Panel(NamedTuple):
    """One panel's compact-WY reflector, with the contiguous transposes the
    GEMM kernel reads (module doc)."""

    v: torch.Tensor       # (m − k) × b, unit diagonal
    vt: torch.Tensor      # Vᵀ, contiguous
    tt: torch.Tensor      # Tᵀ, contiguous

    @classmethod
    def of(cls, v: torch.Tensor, t: torch.Tensor) -> "Panel":
        return cls(v, v.mT.contiguous(), t.mT.contiguous())


def _pad_tau(tau: torch.Tensor, bk: int) -> torch.Tensor:
    """``tau`` padded with zeros (H = I) to ``bk`` entries: a wide panel
    that straddles row m has only ``m − k`` reflectors, and the unpacked
    V's phantom columns are zero anyway."""
    if tau.shape[0] >= bk:
        return tau
    return torch.cat([tau, tau.new_zeros(bk - tau.shape[0])])


def _hooked_factor_panel(block: torch.Tensor, panel_fn=None):
    """PF with the ``panel_fn=`` hook: ``(panel) -> (packed, tau, T)``,
    factoring ``panel`` in place (the QR panel kernel's contract; without
    a hook, :func:`qr_panel_plain`).  Returns ``(tau, Panel)``."""
    _, tau, t = (panel_fn or qr_panel_plain)(block)
    return tau, Panel.of(unpack_v(block, block.shape[1]), t)


def apply_qt_blocked(p: Panel, c: torch.Tensor,
                     backend: Backend) -> torch.Tensor:
    """``C ← Qᵀ·C = C − V·(Tᵀ·(Vᵀ·C))`` in place; returns ``c``."""
    w = backend.gemm(p.vt, c)                     # (b, nc)
    w = backend.gemm(p.tt, w)
    return backend.update(c, p.v, w)


# ---------------------------------------------------------------------------
# The StepOps declaration.
# ---------------------------------------------------------------------------
def _init(a):
    if a.dim() != 2:
        raise ValueError(f"QR needs a matrix, got shape {tuple(a.shape)}")
    return a, torch.zeros((min(a.shape),), dtype=a.dtype, device=a.device)


def _factor(state, st, backend, panel_fn):
    # PF(k): ``panel_fn`` (the GEQR2+LARFT kernel) factors the panel view
    # in place and returns (packed, tau, T).
    a, taus = state
    m = a.shape[0]
    k, bk = st.k, st.bk
    tau, pnl = _hooked_factor_panel(a[k:, k : k + bk], panel_fn)
    taus[k : k + bk] = tau[: min(bk, m - k)]
    return state, pnl


def _update(state, ctx, st, c0, c1, backend):
    # TU_k on columns [c0, c1): apply the block reflector to rows k:.
    apply_qt_blocked(ctx, state[0][st.k :, c0:c1], backend)
    return state


def _tiles(state, ctx, st, backend):
    # RTM: one Qᵀ-apply task per trailing column panel.
    a = state[0]
    n = a.shape[1]
    for j in range(st.k_next, n, st.bk):
        apply_qt_blocked(ctx, a[st.k :, j : min(j + st.bk, n)], backend)
    return state


QR_OPS = StepOps(
    name="qr",
    init=_init,
    factor=_factor,
    update=_update,
    finalize=lambda state: state,
    tiles=_tiles,
    # m < n: the traversal ends once the rows are exhausted, and look-ahead
    # must not pre-factor a panel that starts beyond row m
    stop=lambda state, st: st.k >= state[0].shape[0],
    can_factor=lambda state, st: st.k < state[0].shape[0],
    width=lambda a: a.shape[1],
)


# ---------------------------------------------------------------------------
# Public drivers — thin engine wrappers.  Each copies ``a`` once to
# ``device`` (None = the GPU) and returns (packed A, taus).
# ---------------------------------------------------------------------------
def qr_blocked(a, b: BlockSpec = 128, *, backend="cuda",
               panel_fn: Optional[Callable] = None, device=None, mesh=None,
               layout=None):
    """Blocked GEQRF (MTB).  Returns ``(packed, taus)``."""
    return pipeline.factorize(QR_OPS, a, b, variant="mtb", backend=backend,
                              panel_fn=panel_fn, device=device, mesh=mesh,
                              layout=layout)


def qr_tiled(a, b: BlockSpec = 128, *, backend="cuda",
             panel_fn: Optional[Callable] = None, device=None, mesh=None,
             layout=None):
    """GEQRF with the trailing update fragmented into per-panel tasks
    (RTM)."""
    return pipeline.factorize(QR_OPS, a, b, variant="rtm", backend=backend,
                              panel_fn=panel_fn, device=device, mesh=mesh,
                              layout=layout)


@pipeline.mark_depth_capable
def qr_lookahead(a, b: BlockSpec = 128, *, backend="cuda",
                 panel_fn: Optional[Callable] = None,
                 fused_pu: Optional[Callable] = None, depth: int = 1,
                 device=None, mesh=None, layout=None):
    """GEQRF with static look-ahead; ``depth`` panels in flight.

    Iteration k: ``PU(k+1)`` applies ``Q_kᵀ`` to the next panel's columns
    and factors them; ``TU_right(k)`` applies it to the rest.  ``fused_pu``
    is accepted for the variant registry's sake; ``QR_OPS`` declares no
    fused hook, so it changes nothing.
    """
    return pipeline.factorize(QR_OPS, a, b, variant="la", depth=depth,
                              backend=backend, panel_fn=panel_fn,
                              fused_pu=fused_pu, device=device, mesh=mesh,
                              layout=layout)


def form_q(packed: torch.Tensor, taus: torch.Tensor, b: BlockSpec = 128, *,
           backend="cuda") -> torch.Tensor:
    """Q (m × m) explicitly from GEQRF output (ORGQR analogue)."""
    be = resolve_backend(backend)
    m, n = packed.shape
    q = torch.eye(m, dtype=packed.dtype, device=packed.device)
    steps = [st for st in panel_steps(n, b) if st.k < m]
    for st in reversed(steps):
        k, bk = st.k, st.bk
        v = unpack_v(packed[k:, k : k + bk], bk)
        t = build_t_matrix(v, _pad_tau(taus[k : k + bk], bk))
        # Q ← (I − V·T·Vᵀ)·Q on rows k:
        w = be.gemm(t, be.gemm(v.mT.contiguous(), q[k:]))
        be.update(q[k:], v, w)
    return q
