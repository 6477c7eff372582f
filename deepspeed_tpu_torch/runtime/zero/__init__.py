"""ZeRO over ``torch.distributed``: the placement rule and its collectives
(:mod:`.sharder`), ``Init`` and ``GatheredParameters`` (:mod:`.init_ctx`),
the host optimizer of ZeRO-Offload (:mod:`.offload`) and the offload
config groups; the stages themselves run in ``runtime/engine.py``."""

from ..config import OffloadOptimizerConfig, OffloadParamConfig
from .init_ctx import GatheredParameters, Init
from .offload import CPUOffloadOptimizer
from .sharder import (Placement, TensorShard, ZeroShardingPolicy,
                      compute_weight, dp_shardable_dim, placement_of,
                      reshard_layout_report, tensor_of)

__all__ = ["CPUOffloadOptimizer", "GatheredParameters", "Init",
           "OffloadOptimizerConfig", "OffloadParamConfig", "Placement",
           "TensorShard", "ZeroShardingPolicy",
           "compute_weight", "dp_shardable_dim", "placement_of",
           "reshard_layout_report", "tensor_of"]
