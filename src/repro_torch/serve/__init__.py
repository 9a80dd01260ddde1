"""Decomposition-as-a-service: multi-tenant batched CP-ALS on the card.

``DecompositionService`` admits heterogeneous CP-ALS requests, buckets
them by padded geometry signature, and serves each batch through
``repro_torch.core.cp_als_fused.MultiTensorCPALS`` with bounded in-flight
batches, every MTTKRP of a batch one launch of the split kernel;
``repro_torch.serve.traffic`` generates RNG-pinned open-loop load.
"""

from repro_torch.serve.service import (
    BucketExecutor,
    BucketSignature,
    DecompRequest,
    DecompResponse,
    DecompositionService,
    bucket_signature,
    geometry_signature,
)
from repro_torch.serve.traffic import TrafficConfig, replay_trace, synthetic_trace

__all__ = [
    "BucketExecutor",
    "BucketSignature",
    "DecompRequest",
    "DecompResponse",
    "DecompositionService",
    "bucket_signature",
    "geometry_signature",
    "TrafficConfig",
    "replay_trace",
    "synthetic_trace",
]
