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

On a process mesh (JAX ``param_specs``): the expert stacks hold this
rank's ``E/ep`` experts (dim 0, the ``expert`` axis) and, under tensor
parallelism, its ``I/tp`` columns (``w_gate`` / ``w_up`` dim 2,
``w_down`` dim 1); the router is whole.  Each whole weight is drawn from
the seed and narrowed, so every shard is a slice of the one-process model.
Under tensor parallelism every rank routes the same tokens the same way
(dispatch #11) and its experts' output, combined (#12), is a partial sum
that ``_tp_reduce`` (Megatron's *g*) adds.  In training the tokens into
the dispatch and the combine weights pass Megatron's *f* (the MoE layer
is built with ``expert_tensor_parallel``): the gate values multiply
partial outputs, so their gradient is a sum over ``tensor``, and *f* makes
the router's gradient (and the aux loss's share in it, counted once) whole
and equal on every rank (JAX ``param_specs`` :100-113 leaves the router
whole).  On data-parallel axes or ``seq`` above 1 the MoE layer
routes the global micro-batch (under ``seq`` each rank's ``S/sp`` chunk
of its rows, put in JAX's global ``(b, s)`` order) and exchanges the
experts' buffers over ``expert`` (``moe/sharded_moe.py``); ``loss``
then counts the aux loss ``1/sp`` a ``seq`` rank.  With both an
``expert`` and a ``tensor`` axis (JAX ``P(pipe, expert, None, tensor)``)
a rank holds its ``E/ep`` experts by its ``I/tp`` columns and the
exchange runs over the ``expert`` group of its tensor coordinate.  The
expert stacks carry ``ds_expert`` (``runtime/zero/sharder.ExpertShard``):
the engine reduces their gradients, and ZeRO cuts them, over the
``data`` axis of their expert and tensor coordinates alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..moe.layer import swiglu_expert_fn
from ..moe.sharded_moe import MOELayer, TopKGate
from ..parallel.mesh import AXIS_EXPERT, ProcessMesh
from ..runtime.zero.sharder import ExpertShard, compute_weight
from ..utils.device import DeviceLike
from .llama import (EXPERT_TP_DIMS, Init, LlamaConfig, LlamaDecoderLayer,
                    LlamaModel)


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
    """Attention as Llama's; the FFN is the router and this rank's slice
    of the expert stacks."""

    def _build_ffn(self, c: MixtralConfig, device: DeviceLike) -> None:
        H, I, E = c.hidden_size, c.intermediate_size // self.tp, \
            c.num_experts // self.ep

        def param(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=c.storage_dtype))

        self.wg = param(H, c.num_experts)
        self.w_gate = param(E, H, I)
        self.w_up = param(E, H, I)
        self.w_down = param(E, I, H)

    def _reset_ffn(self, normal_: Init) -> None:
        H = self.w_gate.shape[1]
        I = self.w_down.shape[1] * self.tp  # the whole FFN dim's fan-in
        normal_(self.wg, H)
        for name, fan_in in (("w_gate", H), ("w_up", H), ("w_down", I)):
            normal_(getattr(self, name), fan_in, EXPERT_TP_DIMS[name], 0)

    def experts(self) -> dict:
        """The expert stacks as the experts read them: cast to the compute
        dtype (gathered under ZeRO-3)."""
        return {name: compute_weight(getattr(self, name), self.compute_dtype)
                for name in EXPERT_TP_DIMS}


class MixtralModel(LlamaModel):
    """Llama backbone + top-k routed SwiGLU experts."""

    layer_cls = MixtralDecoderLayer
    #: under ``seq`` the MoE layer routes the global tokens over the data
    #: axes and ``seq``; at tensor x ``seq`` it is not ported yet (ROADMAP
    #: Queue 1 item 7c)
    sequence_tensor_parallel = False
    #: ZeRO++ over the expert stacks is not ported yet (ROADMAP Queue 1
    #: item 4c)
    zero_pp = False

    def __init__(self, config: MixtralConfig, device: DeviceLike = "cuda",
                 seed: int = 0, mesh: Optional[ProcessMesh] = None,
                 init_device: Optional[DeviceLike] = None):
        super().__init__(config, device=device, seed=seed, mesh=mesh,
                         init_device=init_device)
        gate = TopKGate(num_experts=config.num_experts, k=config.top_k,
                        capacity_factor=config.capacity_factor,
                        eval_capacity_factor=config.capacity_factor,
                        min_capacity=4)
        self._moe_layer = MOELayer(gate, swiglu_expert_fn, mesh=mesh,
                                   dispatch_impl=config.moe_dispatch_impl,
                                   expert_tensor_parallel=True)
        self._mark_experts()

    def _set_mesh(self, mesh: Optional[ProcessMesh]) -> None:
        """The tensor axis as Llama's, and the ``expert`` axis: this
        rank's ``E/ep`` experts."""
        super()._set_mesh(mesh)
        c = self.config
        ep = int(mesh.shape[AXIS_EXPERT]) if mesh is not None else 1
        if c.num_experts % ep:
            raise ValueError(f"expert size {ep} must divide the number of "
                             f"experts ({c.num_experts})")
        self.ep = ep
        self.ep_rank = mesh.axis_rank(AXIS_EXPERT) if ep > 1 else 0

    def _mark_experts(self) -> None:
        for layer in self.layers:
            for name in EXPERT_TP_DIMS:
                getattr(layer, name).ds_expert = ExpertShard(self.ep,
                                                             self.ep_rank)

    def shard_(self, mesh: ProcessMesh) -> "MixtralModel":
        super().shard_(mesh)
        self._moe_layer.mesh = self._moe_layer.gate.mesh = mesh
        self._mark_experts()
        return self

    def _ffn(self, layer: MixtralDecoderLayer, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routed FFN over every token of ``h [..., H]`` (this rank's
        rows on a data-parallel mesh)."""
        y, l_aux, _ = self._moe_layer(
            compute_weight(layer.wg, torch.float32), layer.experts(), h)
        return y, l_aux
