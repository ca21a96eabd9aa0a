"""Metrics primitives of the serve layer: counters, gauges, histograms.

A copy of :mod:`repro.obs.metrics` (stdlib only), kept in the port so that
it imports nothing of the reference.  Plain-Python counters, gauges and
histograms, with no device work, exposed as a flat-dict
:meth:`Metrics.snapshot`.  :mod:`repro_torch.serve.metrics` re-exports
everything.

The summary schema is that of
:meth:`repro_torch.serve.engine.ServeEngine.generate`'s stats dict: every
summary carries ``wall``, ``items_per_s``, ``p50_ms`` and ``p99_ms`` (see
:func:`throughput_summary`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Metrics", "throughput_summary",
           "SUMMARY_KEYS"]

#: Field names every serve-layer stats/summary dict must carry.
SUMMARY_KEYS = ("wall", "items_per_s", "p50_ms", "p99_ms")


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-written value (queue depth, fill ratio, ...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Bounded-memory sample distribution with exact small-N percentiles.

    Keeps at most ``capacity`` samples; once full, every ``stride``-th
    observation replaces the oldest retained slot (deterministic reservoir —
    no RNG, so harness runs are reproducible).  Percentiles interpolate the
    sorted retained samples.  This is the repo's one percentile
    implementation — benchmarks and reports route through it rather than
    spelling their own sorted-list math.
    """

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self.count = 0
        self.total = 0.0
        self._samples: List[float] = []
        self._cursor = 0

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if len(self._samples) < self.capacity:
            self._samples.append(value)
        else:
            self._samples[self._cursor] = value
            self._cursor = (self._cursor + 1) % self.capacity

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0.0 when no samples were recorded."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        if len(s) == 1:
            return s[0]
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Metrics:
    """Named registry of the three primitive kinds."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def snapshot(self) -> Dict[str, float]:
        """Flat plain-dict view: ``counter.X``, ``gauge.X``, ``hist.X.p50``…"""
        out: Dict[str, float] = {}
        for name, c in sorted(self._counters.items()):
            out[f"counter.{name}"] = c.value
        for name, g in sorted(self._gauges.items()):
            out[f"gauge.{name}"] = g.value
        for name, h in sorted(self._histograms.items()):
            out[f"hist.{name}.count"] = float(h.count)
            out[f"hist.{name}.mean"] = h.mean
            out[f"hist.{name}.p50"] = h.percentile(50.0)
            out[f"hist.{name}.p99"] = h.percentile(99.0)
        return out


def throughput_summary(wall: float, items: float,
                       latency: "Optional[Histogram | List[float]]" = None
                       ) -> Dict[str, float]:
    """The shared serve-layer summary schema (``SUMMARY_KEYS``).

    ``latency`` may be a :class:`Histogram` or a plain list of seconds (the
    engine records per-decode-step latencies as a list).
    """
    if isinstance(latency, list):
        h = Histogram()
        for v in latency:
            h.record(v)
        latency = h
    return {
        "wall": float(wall),
        "items_per_s": items / wall if wall > 0 else 0.0,
        "p50_ms": 1e3 * latency.percentile(50.0) if latency else 0.0,
        "p99_ms": 1e3 * latency.percentile(99.0) if latency else 0.0,
    }
