"""Serve-layer metrics — re-export shim over :mod:`repro_torch.obs.metrics`
(the reference keeps the same shim at ``repro.serve.metrics``)."""
from repro_torch.obs.metrics import (SUMMARY_KEYS, Counter, Gauge, Histogram,
                                     Metrics, throughput_summary)

__all__ = ["Counter", "Gauge", "Histogram", "Metrics", "throughput_summary",
           "SUMMARY_KEYS"]
