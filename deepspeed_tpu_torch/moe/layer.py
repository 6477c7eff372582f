"""The MoE block with the reference constructor surface, and the SwiGLU
expert.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``deepspeed/moe/layer.py:MoE``
of the reference: hidden_size, expert, num_experts, ep_size, k,
capacity_factor, eval_capacity_factor, min_capacity, noisy_gate_policy,
drop_tokens, use_rts).  ``expert`` is a functional ``(params, [E, C, H]) →
[E, C, H]`` callable (None: the SwiGLU expert), and the params are a dict of
expert-stacked tensors, as in the JAX package.  One device only:
``ep_size`` must divide ``num_experts`` and the experts are not sharded;
``use_residual`` (Residual-MoE) is not ported yet and ``use_tutel`` raises,
as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .sharded_moe import GateMeta, MOELayer, TopKGate

Tensor = torch.Tensor


def swiglu_expert_fn(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """SwiGLU over expert-stacked weights ``{w_gate [E, H, I], w_up [E, H,
    I], w_down [E, I, H]}`` (cast to ``x``'s dtype): ``x [E, C, H] →
    [E, C, H]``, three batched products, no transpose."""
    dt = x.dtype
    gate = torch.bmm(x, params["w_gate"].to(dt))
    up = torch.bmm(x, params["w_up"].to(dt))
    return torch.bmm(F.silu(gate) * up, params["w_down"].to(dt))


class MoE:
    """The reference-shaped MoE block: a :class:`TopKGate` and a
    :class:`MOELayer` over ``expert``."""

    def __init__(self, hidden_size: int,
                 expert: Optional[Callable[[Any, Tensor], Tensor]] = None,
                 num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True,
                 use_tutel: bool = False,
                 enable_expert_tensor_parallelism: bool = False,
                 dispatch_impl: str = "auto"):
        if num_experts % max(ep_size, 1):
            raise ValueError(
                f"num_experts({num_experts}) % ep_size({ep_size}) != 0")
        if use_tutel:
            raise ValueError(
                "use_tutel is not supported: Tutel's dispatch kernels are "
                "not part of this package; the hand-written CUDA dispatch "
                "(dispatch_impl='pallas' or 'auto') takes their place")
        if use_residual:
            raise NotImplementedError("use_residual (Residual-MoE) is not "
                                      "ported yet")
        del enable_expert_tensor_parallelism  # one device: nothing to split
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.gate = TopKGate(num_experts=num_experts, k=k,
                             capacity_factor=capacity_factor,
                             eval_capacity_factor=eval_capacity_factor,
                             min_capacity=min_capacity,
                             noisy_gate_policy=noisy_gate_policy,
                             drop_tokens=drop_tokens, use_rts=use_rts)
        self.moe_layer = MOELayer(self.gate, expert or swiglu_expert_fn,
                                  dispatch_impl=dispatch_impl)

    def init_params(self, generator: torch.Generator,
                    intermediate_size: int) -> Dict[str, Any]:
        """Router and SwiGLU expert weights, ``N(0, 1/fan_in)`` in fp32 on
        the generator's device."""
        E, H, I = self.num_experts, self.hidden_size, intermediate_size

        def normal(shape, fan_in):
            return torch.randn(shape, generator=generator,
                               device=generator.device) / math.sqrt(fan_in)

        return {"wg": normal((H, E), H),
                "experts": {"w_gate": normal((E, H, I), H),
                            "w_up": normal((E, H, I), H),
                            "w_down": normal((E, I, H), I)}}

    def __call__(self, params: Dict[str, Any], x: Tensor,
                 train: bool = True,
                 noise_rng: Optional[torch.Generator] = None
                 ) -> Tuple[Tensor, Tensor, GateMeta]:
        """``x [..., H]`` → ``(y, l_aux, meta)``; ``meta`` holds ``l_aux``,
        ``exp_counts``, ``drop_rate``, ``load``, ``entropy`` and
        ``overflow_frac``."""
        return self.moe_layer(params["wg"], params["experts"], x,
                              train=train, noise_rng=noise_rng)
