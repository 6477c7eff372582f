"""The MoE block with the reference constructor surface, and the SwiGLU
expert.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``deepspeed/moe/layer.py:MoE``
of the reference: hidden_size, expert, num_experts, ep_size, k,
capacity_factor, eval_capacity_factor, min_capacity, use_residual,
noisy_gate_policy, drop_tokens, use_rts, enable_expert_tensor_parallelism).
``expert`` is a functional ``(params, [E, C, H]) → [E, C, H]`` callable
(None: the SwiGLU expert), and the params are a dict of expert-stacked
tensors, as in the JAX package.

On a process mesh (``mesh=``, else the one ``utils.groups`` holds) the
block takes JAX's placement (:meth:`MoE.param_specs`): the expert stacks
are cut over ``expert`` on dim E and, with
``enable_expert_tensor_parallelism``, over ``tensor`` on the FFN dim;
:meth:`MoE.init_params` draws every whole weight and keeps this rank's
slice, so each rank holds a slice of the one-process block.  Under that
tensor split the expert and residual outputs are partial sums, summed over
the ``tensor`` group after the mix (Megatron's *g*: the backward passes
the cotangent through); the tokens into the experts and the residual MLP
and the gates and coefficients that weigh their partial outputs pass *f*,
so the router's, the coefficient's and the input's gradients are whole on
every tensor rank.  Residual-MoE (``use_residual``): a dense SwiGLU
``residual_mlp`` runs beside the experts and a learned 2-way softmax
``coefficient`` mixes the two.  ``use_tutel`` raises, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..comm import comm
from ..parallel.mesh import AXIS_EXPERT, AXIS_TENSOR
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


def shard_leaf(t: Tensor, spec: Tuple[Optional[str], ...],
               mesh: Any) -> Tensor:
    """This rank's block of a whole leaf: along each dim that ``spec``
    names a mesh axis, the axis coordinate's contiguous ``1/size``."""
    for dim, axis in enumerate(spec):
        n = int(mesh.shape[axis]) if axis is not None else 1
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split over the {axis} axis ({n})")
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.axis_rank(axis) * size, size)
    return t.contiguous()


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
                 mesh: Any = None, dispatch_impl: str = "auto"):
        if num_experts % max(ep_size, 1):
            raise ValueError(
                f"num_experts({num_experts}) % ep_size({ep_size}) != 0")
        if use_tutel:
            raise ValueError(
                "use_tutel is not supported: Tutel's dispatch kernels are "
                "not part of this package; the hand-written CUDA dispatch "
                "(dispatch_impl='pallas' or 'auto') takes their place")
        if mesh is None:
            from ..utils import groups
            mesh = groups.current_mesh()
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.use_residual = use_residual
        self.enable_expert_tensor_parallelism = \
            enable_expert_tensor_parallelism
        self.mesh = mesh
        self.gate = TopKGate(num_experts=num_experts, k=k,
                             capacity_factor=capacity_factor,
                             eval_capacity_factor=eval_capacity_factor,
                             min_capacity=min_capacity,
                             noisy_gate_policy=noisy_gate_policy,
                             drop_tokens=drop_tokens, use_rts=use_rts)
        self.moe_layer = MOELayer(
            self.gate, expert or swiglu_expert_fn, mesh=mesh,
            dispatch_impl=dispatch_impl,
            expert_tensor_parallel=enable_expert_tensor_parallelism)

    def param_specs(self) -> Dict[str, Any]:
        """Per leaf, the mesh axis each dim is cut over (None: whole), JAX
        ``MoE.param_specs``."""
        t = AXIS_TENSOR if self.enable_expert_tensor_parallelism else None
        specs: Dict[str, Any] = {
            "wg": (None, None),
            "experts": {"w_gate": (AXIS_EXPERT, None, t),
                        "w_up": (AXIS_EXPERT, None, t),
                        "w_down": (AXIS_EXPERT, t, None)}}
        if self.use_residual:
            specs["residual_mlp"] = {"w_gate": (None, None, t),
                                     "w_up": (None, None, t),
                                     "w_down": (None, t, None)}
            specs["coefficient"] = (None, None)
        return specs

    def _tp(self) -> int:
        if self.mesh is None or not self.enable_expert_tensor_parallelism:
            return 1
        return int(self.mesh.shape.get(AXIS_TENSOR, 1))

    def init_params(self, generator: torch.Generator,
                    intermediate_size: int) -> Dict[str, Any]:
        """Router and SwiGLU expert weights (with ``use_residual`` also the
        residual MLP ``[1, H, I]``-stacked and the coefficient ``[H, 2]``),
        ``N(0, 1/fan_in)`` in fp32 on the generator's device: the whole
        weights, each cut to this rank's slice on a mesh."""
        E, H, I = self.num_experts, self.hidden_size, intermediate_size

        def normal(shape, fan_in):
            return torch.randn(shape, generator=generator,
                               device=generator.device) / math.sqrt(fan_in)

        params: Dict[str, Any] = {
            "wg": normal((H, E), H),
            "experts": {"w_gate": normal((E, H, I), H),
                        "w_up": normal((E, H, I), H),
                        "w_down": normal((E, I, H), I)}}
        if self.use_residual:
            params["residual_mlp"] = {"w_gate": normal((1, H, I), H),
                                      "w_up": normal((1, H, I), H),
                                      "w_down": normal((1, I, H), I)}
            params["coefficient"] = normal((H, 2), H)
        return self.shard_params(params) if self.mesh is not None \
            else params

    def shard_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's slice of a whole parameter dict (:meth:`param_specs`
        on the block's mesh)."""
        def cut(tree, specs):
            if isinstance(tree, dict):
                return {k: cut(v, specs[k]) for k, v in tree.items()}
            return shard_leaf(tree, specs, self.mesh)
        return cut(params, self.param_specs())

    def __call__(self, params: Dict[str, Any], x: Tensor,
                 train: bool = True,
                 noise_rng: Optional[torch.Generator] = None
                 ) -> Tuple[Tensor, Tensor, GateMeta]:
        """``x [..., H]`` → ``(y, l_aux, meta)``; ``meta`` holds ``l_aux``,
        ``exp_counts``, ``drop_rate``, ``load``, ``entropy`` and
        ``overflow_frac``."""
        y, l_aux, meta = self.moe_layer(params["wg"], params["experts"], x,
                                        train=train, noise_rng=noise_rng)
        group = self.mesh.group(AXIS_TENSOR) if self._tp() > 1 else None

        def f(t):  # Megatron's f: the partial sums' gradients added
            return t if group is None else comm.tp_copy(t, group)

        if self.use_residual:
            H = x.shape[-1]
            dense = swiglu_expert_fn(params["residual_mlp"],
                                     f(x).reshape(1, -1, H)).reshape(x.shape)
            coef = f(torch.softmax(
                torch.einsum("...h,hc->...c", x,
                             params["coefficient"].to(x.dtype)), dim=-1))
            y = y * coef[..., 0:1] + dense * coef[..., 1:2]
        if group is not None:
            y = comm.tp_reduce(y, group)
        return y, l_aux, meta
