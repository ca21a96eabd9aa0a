"""The generic static look-ahead engine: one loop, depth-d look-ahead.

The port of :mod:`repro.core.pipeline`.  A DMF declares its algorithm once
as a :class:`StepOps` record — how to **factor** a panel, **swap** the
panel's row interchanges into the other columns, and **update** a range
of trailing columns — and the engine emits every scheduling variant:

* ``variant="mtb"`` — one panel/update pair per iteration (paper
  Listing 3);
* ``variant="rtm"`` — the trailing update fragmented into per-tile tasks
  (Listing 4), through :attr:`StepOps.tiles`;
* ``variant="la", depth=d`` — static look-ahead with d panels in flight
  (Listing 5 for d = 1, its §5 generalization for d ≥ 2);
* ``variant="la", fused_pu=...`` — LA_MB: the first narrow update and the
  next panel factorization as one fused kernel (:attr:`StepOps.pu`).

Each loop issues its ops in the reference's order.  Every trailing column
receives every panel's update exactly once and in panel order, so with
column-decomposable kernels the variants give bitwise the same factors.

In-place state.  The state is ``(a, aux)`` as in the reference, but ``a``
is one working copy of the matrix that the hooks update in place through
views; the engine copies the caller's input once, on the device the
caller asked for (:func:`repro_torch.device.resolve_device`).  In this
slice all ops run on one CUDA stream, in the order issued, so ``la``'s
PF(k+1) does not yet overlap TU_k^R on the device.

Row exhaustion.  A DMF may declare ``stop``/``can_factor``/``width``
(QR and QRCP on wide ``m < n`` inputs end their traversal once the rows
are exhausted) and ``la_unsafe`` (global QRCP and Hessenberg: the panel
reads trailing data, so ``la`` would compute another factorization;
``factorize`` refuses it with the reason).

Two-sided updates.  Gauss–Jordan inversion updates the columns left of
the panel too and writes the panel's own columns last: ``update_left`` and
``commit`` form the per-iteration epilogue (span ``EPI``), which every
loop runs after an iteration's updates, the last panel's included; under
``mtb`` a DMF with ``update_all`` issues its whole update as that one
bulk op instead.

Mesh.  ``mesh=`` (a ``torch.distributed.device_mesh.DeviceMesh``) lowers
the ``mtb`` and ``la`` schedules onto 1-D column block-cyclic shards, one
rank a shard (:func:`repro_torch.core.distributed.factorize_mesh`),
bitwise the single-device engine at the same schedule, pivots included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.blocking import BlockSpec, PanelStep, panel_steps
from repro_torch.device import resolve_device, working_copy
from repro_torch.obs import tracer as _obs

__all__ = ["StepOps", "factorize", "mark_depth_capable", "supports_depth"]

#: Engine state: ``(a, aux)`` — the working matrix plus per-DMF side output
#: (``ipiv`` for LU, ``taus`` for QR, ``(taus, jpvt)`` for QRCP, None for
#: Cholesky).
State = Tuple[torch.Tensor, Any]

_MISSING = object()


@dataclasses.dataclass(frozen=True)
class StepOps:
    """One DMF, declared as the operations of a single panel iteration.

    ``st`` is the :class:`~repro_torch.core.blocking.PanelStep` of the
    panel being applied, not of the columns being updated.

    * ``init(a) -> state`` — build ``(a, aux)`` around the working copy.
    * ``factor(state, st, backend, panel_fn) -> (state, ctx)`` — PF(k):
      factor panel ``st`` in place and return the context its updates need.
    * ``update(state, ctx, st, c0, c1, backend) -> state`` — apply panel
      ``st``'s transform to columns ``[c0, c1)``, ``c0 >= st.k_next``.
    * ``finalize(state) -> result``.
    * ``swap`` (optional) — apply the panel's row interchanges to the
      columns outside it; eager after ``factor`` under mtb/rtm, deferred to
      the next iteration under la (the pivot deferral of Listing 5).
    * ``tiles`` (optional) — the RTM fragmentation of the whole trailing
      update; a DMF without it has no ``rtm`` variant.
    * ``pu(state, ctx, st, st_next, backend, fused) -> (state, ctx_next)``
      (optional) — the fused panel update of LA_MB: ``update`` of panel
      ``st_next``'s columns and its ``factor`` in one call of ``fused``,
      which writes its results into the working copy in place.  Only
      consulted when the caller passes ``fused_pu=``.
    * ``update_left(state, ctx, st, backend) -> state`` (optional) — apply
      panel ``st``'s transform to the columns left of it, ``[0, st.k)``
      (Gauss–Jordan's two-sided update); part of the epilogue.
    * ``update_all(state, ctx, st, backend) -> state`` (optional) — the
      whole iteration's update, every column and the commit, as ``mtb``'s
      one bulk op.
    * ``commit(state, ctx, st, backend) -> state`` (optional) — write the
      panel's final columns (Gauss–Jordan's ``I − M``); the epilogue's
      last op.
    * ``stop(state, st) -> bool`` (optional) — end the traversal at
      ``st`` (QR on ``m < n`` inputs, once the rows are exhausted).
    * ``can_factor(state, st) -> bool`` (optional) — whether panel ``st``
      is factorable; look-ahead asks it before pre-factoring a panel.
    * ``width(a) -> int`` — the traversal width (``a.shape[1]`` for QR).
    * ``la_unsafe`` — the reason this DMF's ``factor`` reads trailing data
      beyond the panel columns, so that ``la`` would compute another
      factorization; the engine refuses ``variant="la"`` with it.
    """

    name: str
    init: Callable[[torch.Tensor], State]
    factor: Callable[..., Tuple[State, Any]]
    update: Callable[..., State]
    finalize: Callable[[State], Any]
    swap: Optional[Callable[..., State]] = None
    tiles: Optional[Callable[..., State]] = None
    pu: Optional[Callable[..., Tuple[State, Any]]] = None
    update_left: Optional[Callable[..., State]] = None
    update_all: Optional[Callable[..., State]] = None
    commit: Optional[Callable[..., State]] = None
    stop: Optional[Callable[[State, PanelStep], bool]] = None
    can_factor: Optional[Callable[[State, PanelStep], bool]] = None
    width: Callable[[torch.Tensor], int] = lambda a: a.shape[0]
    la_unsafe: Optional[str] = None

    def _stop(self, state: State, st: PanelStep) -> bool:
        return self.stop is not None and self.stop(state, st)

    def _factorable(self, state: State, st: PanelStep) -> bool:
        return self.can_factor is None or self.can_factor(state, st)


def factorize(
    ops: StepOps,
    a,
    b: BlockSpec = 128,
    *,
    variant: str = "la",
    depth: int = 1,
    backend="cuda",
    panel_fn: Optional[Callable] = None,
    fused_pu: Optional[Callable] = None,
    device=None,
    mesh=None,
    layout=None,
):
    """Run one scheduling variant of ``ops`` over a copy of ``a``.

    ``a`` may be a tensor or a NumPy array; it is copied once to
    ``device`` (``None`` means the GPU) and never modified.  When the
    caller passes no ``panel_fn``, the backend's panel registry
    (``Backend.panel_fns``) supplies it — this is how ``backend="cuda"``
    routes every variant through the GETF2 kernel.  ``fused_pu`` (``la``
    only) is the fused panel-update kernel of LA_MB.

    ``mesh=`` runs the same schedule over block-cyclic shards of a
    ``DeviceMesh`` (every rank calls it with the same ``a``; each gets the
    whole result), and ``layout=`` (a ``distributed.Layout``) picks the
    mesh dimension; by default the active ``parallel.sharding`` Rules'
    ``"panels"`` entry decides.
    """
    if mesh is not None:
        from repro_torch.core import distributed as _dist

        return _dist.factorize_mesh(ops, a, b, variant=variant, depth=depth,
                                    backend=backend, panel_fn=panel_fn,
                                    fused_pu=fused_pu, mesh=mesh,
                                    layout=layout, device=device)
    if layout is not None:
        raise ValueError("layout= is a mesh-path parameter; pass mesh= too")
    be = resolve_backend(backend)
    work = working_copy(a, resolve_device(device))
    if panel_fn is None and be.panel_fns is not None:
        panel_fn = be.panel_fns.get(ops.name)
    if variant == "mtb":
        return _run_blocked(ops, work, b, be, panel_fn, tiled=False)
    if variant == "rtm":
        if ops.tiles is None:
            raise ValueError(f"{ops.name!r} has no RTM (tiled) fragmentation")
        return _run_blocked(ops, work, b, be, panel_fn, tiled=True)
    if variant == "la":
        if ops.la_unsafe is not None:
            raise ValueError(
                f"{ops.name!r} cannot be scheduled with look-ahead: "
                f"{ops.la_unsafe}")
        if depth < 1:
            raise ValueError(f"look-ahead depth must be >= 1, got {depth}")
        return _run_la(ops, work, b, depth, be, panel_fn, fused_pu)
    raise ValueError(
        f"unknown scheduling variant {variant!r}; expected mtb/rtm/la")


# ---------------------------------------------------------------------------
# Every hook call below is bracketed by a span when a tracer is installed
# (``repro_torch.obs.tracer.trace()``); with none — the default — each site
# costs one ``tr is None`` predicate.  Span tags: ``step`` = panel index,
# ``it`` = the iteration that ran the work, ``depth`` = step − it.
# ---------------------------------------------------------------------------
def _call(tr, cat, name, thunk, **tags):
    return thunk() if tr is None else tr.wrap(cat, name, thunk, **tags)


def _epilogue(tr, ops: StepOps, state, ctx, st, backend, i):
    """The per-iteration epilogue: ``update_left`` (past the first panel),
    then ``commit``; spanned only where a DMF declares either."""
    if ops.update_left is None and ops.commit is None:
        return state

    def run():
        s = state
        if ops.update_left is not None and st.k > 0:
            s = ops.update_left(s, ctx, st, backend)
        if ops.commit is not None:
            s = ops.commit(s, ctx, st, backend)
        return s

    return _call(tr, "EPI", f"EPI({i})", run, step=i, it=i)


def _run_blocked(ops: StepOps, a, b, backend: Backend, panel_fn,
                 tiled: bool):
    """MTB: PF(k) ; SWAP(k) ; TU(k) over the whole trailing matrix as one
    update — or, for RTM (``tiled``), fragmented into per-tile tasks — ;
    EPI(k).  Under MTB a DMF with ``update_all`` issues it as the
    iteration's one update instead of TU and EPI."""
    tr = _obs.active()
    n = ops.width(a)
    state = ops.init(a)
    for i, st in enumerate(panel_steps(n, b)):
        if ops._stop(state, st):
            break
        state, ctx = _call(tr, "PF", f"PF({i})",
                           lambda: ops.factor(state, st, backend, panel_fn),
                           step=i, it=i)
        if ops.swap is not None:
            state = _call(tr, "SWAP", f"SWAP({i})",
                          lambda: ops.swap(state, ctx, st, backend),
                          step=i, it=i)
        if ops.update_all is not None and not tiled:
            state = _call(tr, "TU", f"TU({i})",
                          lambda: ops.update_all(state, ctx, st, backend),
                          step=i, it=i, cols=(0, n))
            continue
        if st.k_next < n:
            state = _call(
                tr, "TU", f"TU({i})",
                (lambda: ops.tiles(state, ctx, st, backend)) if tiled else
                (lambda: ops.update(state, ctx, st, st.k_next, n, backend)),
                step=i, it=i, cols=(st.k_next, n), tiles=tiled)
        state = _epilogue(tr, ops, state, ctx, st, backend, i)
    return ops.finalize(state)


def _run_la(ops: StepOps, a, b, depth, backend: Backend, panel_fn,
            fused_pu=None):
    """LA(depth=d): PF(k+1) right after the narrow update of its columns,
    ahead of the bulk TU_k^R; d panels in flight (Listing 5).  With
    ``fused_pu`` (LA_MB) that update and PF(k+1) are one fused call."""
    tr = _obs.active()
    n = ops.width(a)
    state = ops.init(a)
    steps = list(panel_steps(n, b))
    if not steps:
        return ops.finalize(state)
    fused = fused_pu is not None and ops.pu is not None

    # PF(0) runs before the pipelined loop (Listing 5 prologue).
    ctx = None
    if ops._factorable(state, steps[0]):
        state, ctx = _call(
            tr, "PF", "PF(0)",
            lambda: ops.factor(state, steps[0], backend, panel_fn),
            step=0, it=-1, depth=1)

    for i, st in enumerate(steps):
        # Panel-i interchanges, deferred from the iteration that factored
        # it: applied to every column outside panel i before any
        # iteration-i update touches them.
        if ops.swap is not None:
            state = _call(tr, "SWAP", f"SWAP({i})",
                          lambda: ops.swap(state, ctx, st, backend),
                          step=i, it=i)
        if ops._stop(state, st):
            break
        if st.k_next >= n:
            # the last panel's epilogue (Gauss–Jordan: its update of every
            # column to its left, and its commit)
            state = _epilogue(tr, ops, state, ctx, st, backend, i)
            break

        # PU chain: narrow updates of the next `dd` panels' columns;
        # PF(i+1) fires right after the first one (fused with it: LA_MB).
        dd = min(depth, len(steps) - 1 - i)
        if dd >= 1 and not ops._factorable(state, steps[i + 1]):
            # the next panel starts beyond the factorable rows (QR on
            # m < n): nothing to pre-factor, so the whole trailing range
            # is TU_right, as under mtb
            dd = 0
        nctx = _MISSING
        for j in range(1, dd + 1):
            stj = steps[i + j]
            if j == 1 and fused:
                # one fused kernel does TU^L + PF: a single PU span
                state, nctx = _call(
                    tr, "PU", f"PU+PF({i}->{i + 1})",
                    lambda: ops.pu(state, ctx, st, stj, backend, fused_pu),
                    step=i, it=i, depth=1, fused=True,
                    cols=(stj.k, stj.k_next))
                continue
            state = _call(
                tr, "PU", f"PU({i}->{i + j})",
                lambda: ops.update(state, ctx, st, stj.k, stj.k_next,
                                   backend),
                step=i, it=i, depth=j, cols=(stj.k, stj.k_next))
            if j == 1:
                state, nctx = _call(
                    tr, "PF", f"PF({i + 1})",
                    lambda: ops.factor(state, stj, backend, panel_fn),
                    step=i + 1, it=i, depth=1)

        # TU_right(i): the bulk update — data-independent of the PU chain.
        r0 = steps[i + dd].k_next if dd >= 1 else st.k_next
        if r0 < n:
            state = _call(tr, "TU", f"TU({i})",
                          lambda: ops.update(state, ctx, st, r0, n, backend),
                          step=i, it=i, cols=(r0, n), inflight=dd)
        state = _epilogue(tr, ops, state, ctx, st, backend, i)
        if nctx is not _MISSING:
            ctx = nctx
    return ops.finalize(state)


def mark_depth_capable(fn: Callable) -> Callable:
    """Tag a driver as accepting ``depth=`` (pipeline-backed look-ahead)."""
    fn.supports_depth = True
    return fn


def supports_depth(fn: Callable) -> bool:
    return getattr(fn, "supports_depth", False)
