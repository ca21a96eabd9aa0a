"""Observability for the port: the span tracer (:mod:`.tracer`)."""
from repro_torch.obs.tracer import Span, Tracer, active, trace

__all__ = ["Span", "Tracer", "active", "trace"]
