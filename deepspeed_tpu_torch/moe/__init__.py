"""Mixture of experts: top-k gating, the MoE layer (on a process mesh:
global routing over the data-parallel ranks' tokens and the experts
exchanged over the ``expert`` axis) and the reference-shaped ``MoE``
block with Residual-MoE."""

from .layer import MoE, swiglu_expert_fn
from .sharded_moe import (GateIndices, GateMeta, MOELayer, TopKGate,
                          top_k_gating, top_k_gating_indices)

__all__ = ["GateIndices", "GateMeta", "MOELayer", "MoE", "TopKGate",
           "swiglu_expert_fn", "top_k_gating", "top_k_gating_indices"]
