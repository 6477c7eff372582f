"""Mixtral-family sparse-MoE decoder in PyTorch: serving and training.

Counterpart of ``deepspeed_tpu/models/mixtral.py``: the Llama backbone with
the dense FFN replaced by a top-k routed SwiGLU over expert-stacked weights.
Each layer holds the router ``wg [H, E]`` and the experts ``w_gate / w_up
[E, H, I]`` and ``w_down [E, I, H]``, in the JAX orientation, so the experts
are three ``torch.bmm`` calls with no transpose, and it has no dense
projections.  The FFN goes through ``moe/sharded_moe.MOELayer``: the router
in fp32, then the rung ``config.moe_dispatch_impl`` resolves to (on the
card above the dense crossover, the hand-written CUDA dispatch and combine
kernels).  Training adds ``aux_loss_coef`` times the layers' summed
load-balancing losses to the cross entropy (``LlamaModel.loss``); the
serving hooks drop them.  Every token of a call counts toward the experts'
capacity, padding included, as in the JAX model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..moe.layer import swiglu_expert_fn
from ..moe.sharded_moe import MOELayer, TopKGate
from ..utils.device import DeviceLike
from .llama import Init, LlamaConfig, LlamaDecoderLayer, LlamaModel


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    aux_loss_coef: float = 0.02
    #: token dispatch rung of the MoE layer: auto | dense | sparse | pallas
    moe_dispatch_impl: str = "auto"

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        d = dict(vocab_size=512, hidden_size=128, intermediate_size=176,
                 num_layers=4, num_heads=8, num_kv_heads=4, max_seq_len=256,
                 num_experts=4, top_k=2)
        d.update(kw)
        return cls(**d)

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MixtralConfig":
        """The public ``mistralai/Mixtral-8x7B-v0.1`` config."""
        d = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8,
                 max_seq_len=32768, rope_theta=1e6, num_experts=8, top_k=2)
        d.update(kw)
        return cls(**d)

    def _params(self, experts_per_token: int) -> int:
        H, I, V, L, E = (self.hidden_size, self.intermediate_size,
                         self.vocab_size, self.num_layers, self.num_experts)
        hd, nh, nkv = self.hd, self.num_heads, self.num_kv_heads
        per_layer = (H * nh * hd + 2 * H * nkv * hd + nh * hd * H + H * E
                     + experts_per_token * 3 * H * I + 2 * H)
        head = H if self.tie_embeddings else H + H * V
        return V * H + L * per_layer + head

    def num_params(self) -> int:
        """Every parameter, all ``num_experts`` experts included."""
        return self._params(self.num_experts)

    def active_params(self) -> int:
        """The parameters a token runs through: ``top_k`` experts."""
        return self._params(self.top_k)


class MixtralDecoderLayer(LlamaDecoderLayer):
    """Attention as Llama's; the FFN is the router and the expert stacks."""

    def _build_ffn(self, c: MixtralConfig, device: DeviceLike) -> None:
        H, I, E = c.hidden_size, c.intermediate_size, c.num_experts

        def param(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=c.storage_dtype))

        self.wg = param(H, E)
        self.w_gate = param(E, H, I)
        self.w_up = param(E, H, I)
        self.w_down = param(E, I, H)

    def _reset_ffn(self, normal_: Init) -> None:
        H, I = self.w_gate.shape[1], self.w_gate.shape[2]
        for w, fan_in in ((self.wg, H), (self.w_gate, H), (self.w_up, H),
                          (self.w_down, I)):
            normal_(w, fan_in)

    def experts(self) -> dict:
        return {"w_gate": self.w_gate, "w_up": self.w_up,
                "w_down": self.w_down}


class MixtralModel(LlamaModel):
    """Llama backbone + top-k routed SwiGLU experts."""

    layer_cls = MixtralDecoderLayer

    def __init__(self, config: MixtralConfig, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__(config, device=device, seed=seed)
        gate = TopKGate(num_experts=config.num_experts, k=config.top_k,
                        capacity_factor=config.capacity_factor,
                        eval_capacity_factor=config.capacity_factor,
                        min_capacity=4)
        self._moe_layer = MOELayer(gate, swiglu_expert_fn,
                                   dispatch_impl=config.moe_dispatch_impl)

    def _ffn(self, layer: MixtralDecoderLayer, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routed FFN over every token of ``h [..., H]``."""
        y, l_aux, _ = self._moe_layer(layer.wg, layer.experts(), h)
        return y, l_aux
