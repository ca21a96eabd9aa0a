"""Observability for the port: the span tracer (:mod:`.tracer`), the
metrics primitives of the serve layer (:mod:`.metrics`), and, imported by
their users, the trace reports (:mod:`.report`: overlap, tile-DAG critical
path, model-against-measured attainment) and exports (:mod:`.export`:
Chrome/Perfetto JSON, a terminal timeline)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metrics,
                                     throughput_summary)
from repro_torch.obs.tracer import Span, Tracer, active, trace

__all__ = ["Span", "Tracer", "active", "trace", "Counter", "Gauge",
           "Histogram", "Metrics", "throughput_summary"]
