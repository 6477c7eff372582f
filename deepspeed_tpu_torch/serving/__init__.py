"""In-process serving plane: paged prefix-sharing KV cache, SLO-aware
streaming front-end, multi-replica routing.

Counterpart of ``deepspeed_tpu/serving`` (its in-process part):

* :mod:`.prefix_cache` — refcounted page allocator + hash-trie prefix index;
* :mod:`.scheduler` — :class:`ServingScheduler`, the v2 planner with
  prefix-shared reservations and preemptible decode slots;
* :mod:`.frontend` — submit/stream/cancel, latency-class queues, admission
  control, preemption, replica drain;
* :mod:`.router` — replica health + prefix-affine least-outstanding routing;
* :mod:`.metrics` — per-class TTFT/TPOT trackers and counters.

The networked plane (front door, workers, KV transfer), tracing, SLO
monitors, replay and the autoscaler are not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..utils.device import DeviceLike
from .frontend import (NoHealthyReplicaError, ServingFrontend, ServingHandle,
                       ServingParams)
from .metrics import CLASSES, LatencyTracker, ServingMetrics
from .prefix_cache import PrefixCache, RefcountedBlockAllocator
from .router import Replica, ReplicaRouter
from .scheduler import ServingScheduler

__all__ = [
    "CLASSES", "LatencyTracker", "NoHealthyReplicaError", "PrefixCache",
    "RefcountedBlockAllocator", "Replica", "ReplicaRouter",
    "ServingFrontend", "ServingHandle", "ServingMetrics", "ServingParams",
    "ServingScheduler", "build_serving_frontend",
]


def build_serving_frontend(model: Any, replicas: int = 1,
                           cache_config: Any = None,
                           max_batch_slots: int = 8,
                           prefill_chunk: int = 128,
                           prefill_batch: int = 2,
                           decode_burst: int = 8,
                           prefix_sharing: bool = True,
                           max_cached_blocks: int = 0,
                           serving_params: Optional[ServingParams] = None,
                           device: DeviceLike = "cuda",
                           mesh: Any = None) -> ServingFrontend:
    """N v2 engine replicas of ``model`` behind one front-end.  Each replica
    owns a full KV pool on ``device`` (memory scales with ``replicas``).
    Under tensor parallelism (a model split over ``mesh``) each rank builds
    its own front-end and drives ``pump()`` itself."""
    from ..inference.v2 import build_engine_v2

    def factory(cc, slots, chunk, pbatch):
        return ServingScheduler(cc, max_batch_slots=slots,
                                prefill_chunk=chunk, prefill_batch=pbatch,
                                prefix_sharing=prefix_sharing,
                                max_cached_blocks=max_cached_blocks)

    reps: List[Replica] = []
    for i in range(int(replicas)):
        eng = build_engine_v2(
            model, cache_config=cache_config,
            max_batch_slots=max_batch_slots, prefill_chunk=prefill_chunk,
            prefill_batch=prefill_batch, decode_burst=decode_burst,
            scheduler_factory=factory, device=device, mesh=mesh)
        reps.append(Replica(eng, i))
    return ServingFrontend(reps, params=serving_params)
