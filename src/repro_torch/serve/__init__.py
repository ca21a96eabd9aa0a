"""Serving layer of the port: the batched LM engine (:mod:`.engine`) and
the bucketed factorization-as-a-service solve server (:mod:`.solver`,
shape buckets in :mod:`.bucketing`)."""
from repro_torch.serve.bucketing import BucketKey, shape_class
from repro_torch.serve.metrics import Metrics, throughput_summary
from repro_torch.serve.solver import (FactorCache, ServerConfig, SolveRequest,
                                      SolveResponse, SolveServer)

__all__ = [
    "BucketKey", "shape_class", "Metrics", "throughput_summary",
    "FactorCache", "ServerConfig", "SolveRequest", "SolveResponse",
    "SolveServer",
]
