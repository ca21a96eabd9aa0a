"""Observability for the port: the span tracer (:mod:`.tracer`) and the
metrics primitives of the serve layer (:mod:`.metrics`)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metrics,
                                     throughput_summary)
from repro_torch.obs.tracer import Span, Tracer, active, trace

__all__ = ["Span", "Tracer", "active", "trace", "Counter", "Gauge",
           "Histogram", "Metrics", "throughput_summary"]
