"""Inference v2: FastGen-style ragged serving over a paged KV pool
(counterpart of ``deepspeed_tpu/inference/v2``)."""

from .engine_v2 import RaggedInferenceEngineV2, build_engine_v2
from .kv_cache import BlockAllocator, KVCacheConfig, init_kv_pool
from .scheduler import RaggedScheduler, Request, RequestState

__all__ = [
    "RaggedInferenceEngineV2", "build_engine_v2",
    "BlockAllocator", "KVCacheConfig", "init_kv_pool",
    "Request", "RequestState", "RaggedScheduler",
]
