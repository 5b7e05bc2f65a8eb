"""`repro_torch.serving` — port of `repro.serving`: the paged KV cache and
the continuous-batching scheduler."""

from repro_torch.serving.kv_cache import NULL_BLOCK, BlockAllocator
from repro_torch.serving.scheduler import (
    Request,
    Scheduler,
    ServingConfig,
    prepack_serving_params,
)

__all__ = [
    "NULL_BLOCK",
    "BlockAllocator",
    "Request",
    "Scheduler",
    "ServingConfig",
    "prepack_serving_params",
]
