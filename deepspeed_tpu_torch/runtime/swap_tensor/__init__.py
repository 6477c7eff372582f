"""ZeRO-Infinity: the trunk's layers in a cpu or nvme tier
(:mod:`.partitioned_param_swapper`) streamed through the card by the
layer-streaming executor (:mod:`.infinity_engine`)."""

from .infinity_engine import PROTOCOL, LayerStreamingEngine
from .partitioned_param_swapper import PartitionedParamSwapper

__all__ = ["LayerStreamingEngine", "PROTOCOL", "PartitionedParamSwapper"]
