"""ZeRO over ``torch.distributed``: the placement rule and its collectives
(:mod:`.sharder`), ``Init`` and ``GatheredParameters`` (:mod:`.init_ctx`);
the stages themselves run in ``runtime/engine.py``."""

from .init_ctx import GatheredParameters, Init
from .sharder import (Placement, ZeroShardingPolicy, compute_weight,
                      dp_shardable_dim, placement_of, reshard_layout_report)

__all__ = ["GatheredParameters", "Init", "Placement", "ZeroShardingPolicy",
           "compute_weight", "dp_shardable_dim", "placement_of",
           "reshard_layout_report"]
