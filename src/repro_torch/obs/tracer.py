"""Execution-trace span recorder for the look-ahead engine.

The port of :mod:`repro.obs.tracer`.  The paper's central evidence is
execution traces: timelines showing the panel factorization PF(k+1) hidden
under the bulk trailing update TU_k^R once static look-ahead is embedded.
Every hook invocation of :mod:`repro_torch.core.pipeline` (and the driver
layer above it) becomes a :class:`Span` tagged with its category, panel
index, owning iteration and in-flight depth.  Categories
(:data:`CATEGORIES`): ``PF`` (panel factorization), ``TU`` (bulk trailing
update), ``PU`` (narrow update of a panel in flight), ``SWAP`` (row
interchanges), ``BCAST`` (a mesh run's panel broadcast, tagged with its
owner ``shard`` and payload ``bytes``), ``EPI`` (the per-iteration epilogue of a two-sided DMF:
Gauss–Jordan's update of the columns left of the panel and its commit),
``TILE`` (one task of the tile-DAG executor,
:func:`repro_torch.core.tiles.run_dag`), ``drive`` (a whole driver call),
``sweep`` (the tuner's lane; no layer emits it yet, as in the
reference) and ``serve`` (one flushed batch of the solve server,
:class:`repro_torch.serve.solver.SolveServer`).

A tracer built with ``metrics=`` (a
:class:`repro_torch.obs.metrics.Metrics` registry, e.g. a server's
``metrics``) also records every finished span's duration in that
registry's ``span.<cat>`` histogram, so engine traces and serve summaries
share one snapshot.

* **Disabled is free and bitwise-invisible.**  No tracer installed ⇒ every
  instrumented site runs its original call behind a single
  ``tracer.active() is None`` predicate.
* **Spans observe, never reorder.**  Enabling tracing adds timestamps and,
  with ``fence=True``, a ``torch.cuda.synchronize()`` after each
  instrumented call whose result holds a CUDA tensor, so the span bounds
  the device work the call launched rather than its enqueue.
* **Injectable clock** so span math is unit-testable deterministically.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "trace", "active", "CATEGORIES"]

#: The span categories the engine and the drivers emit.
CATEGORIES = ("PF", "TU", "PU", "SWAP", "EPI", "BCAST", "TILE", "drive",
              "sweep", "serve")

#: The currently installed tracer (None = tracing disabled, the default).
_ACTIVE: Optional["Tracer"] = None


def active() -> Optional["Tracer"]:
    """The installed tracer, or None when tracing is disabled."""
    return _ACTIVE


@dataclasses.dataclass
class Span:
    """One timed interval of the instrumented execution.

    ``step`` is the panel index the work belongs to (the ``k`` in PF(k)),
    ``it`` the outer iteration that ran it, and ``depth`` the in-flight
    distance ``step - it`` for look-ahead pre-factorizations (the prologue
    PF(0) carries ``it=-1``, ``depth=1``).
    """

    cat: str
    name: str
    t0: float
    t1: float
    step: int = -1
    it: int = -1
    depth: int = 0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def _holds_cuda(value: Any) -> bool:
    """True when ``value`` (a tensor or nested tuples/lists/dicts of them)
    holds a tensor on a CUDA device."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, (tuple, list)):
        return any(_holds_cuda(v) for v in value)
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    return False


def _fence(value: Any) -> None:
    """Wait for the device work behind ``value``; a no-op for values that
    hold no CUDA tensor (CPU runs, ints, pivot tuples)."""
    if _holds_cuda(value):
        import torch

        torch.cuda.synchronize()


class Tracer:
    """Span recorder with an injectable clock and an optional metrics
    registry (``metrics``: every finished span also feeds its
    ``span.<cat>`` duration histogram)."""

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 fence: bool = True, metrics=None) -> None:
        self.clock = clock
        self.fence = fence
        self.metrics = metrics
        self.spans: List[Span] = []

    def add(self, span: Span) -> Span:
        """Record an externally built span (synthetic spans in tests)."""
        self.spans.append(span)
        if self.metrics is not None:
            self.metrics.histogram(f"span.{span.cat}").record(span.dur)
        return span

    def wrap(self, cat: str, name: str, thunk: Callable[[], Any], *,
             step: int = -1, it: int = -1, depth: int = 0,
             **meta) -> Any:
        """Run ``thunk`` inside a span and return its result.

        The end timestamp is taken after fencing the result (when
        ``fence=True``), so the span bounds the device work the thunk
        launched.
        """
        t0 = self.clock()
        out = thunk()
        if self.fence:
            _fence(out)
        self.add(Span(cat, name, t0, self.clock(), step=step, it=it,
                      depth=depth, meta=dict(meta)))
        return out

    @contextlib.contextmanager
    def span(self, cat: str, name: str, *, step: int = -1, it: int = -1,
             depth: int = 0, fence_on: Any = None, **meta):
        """Context-manager form for block-shaped sites (serve flushes,
        driver bodies).  ``fence_on`` optionally names the value whose
        device work the end timestamp waits for (with ``fence=True``)."""
        t0 = self.clock()
        try:
            yield
        finally:
            if self.fence and fence_on is not None:
                _fence(fence_on)
            self.add(Span(cat, name, t0, self.clock(), step=step, it=it,
                          depth=depth, meta=dict(meta)))

    def by_cat(self, cat: str) -> List[Span]:
        return [s for s in self.spans if s.cat == cat]

    def total(self, cat: Optional[str] = None) -> float:
        return sum(s.dur for s in (self.spans if cat is None
                                   else self.by_cat(cat)))

    def clear(self) -> None:
        self.spans.clear()


@contextlib.contextmanager
def trace(tracer: Optional[Tracer] = None, **kw):
    """Install a tracer for the dynamic extent of the block.

        with trace() as tr:
            lu_lookahead(a, 128, depth=2)
        tr.total("PF")

    Nesting installs are allowed; the previous tracer is restored on exit.
    ``**kw`` forwards to the :class:`Tracer` constructor when none is given.
    """
    global _ACTIVE
    if tracer is None:
        tracer = Tracer(**kw)
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev
