"""Mixture of experts on one device: top-k gating, the MoE layer and the
reference-shaped ``MoE`` block."""

from .layer import MoE, swiglu_expert_fn
from .sharded_moe import (GateIndices, GateMeta, MOELayer, TopKGate,
                          top_k_gating, top_k_gating_indices)

__all__ = ["GateIndices", "GateMeta", "MOELayer", "MoE", "TopKGate",
           "swiglu_expert_fn", "top_k_gating", "top_k_gating_indices"]
