"""Mixed precision: the dynamic loss scaler and the gradient-norm helpers.

Counterpart of ``deepspeed_tpu/runtime/precision.py``.  The JAX scaler is a
functional state threaded through the compiled step; here it is a small
host object, since the fp16 step reads the overflow flag on the host to
decide whether to take the optimizer step.  Under ZeRO the gradients of
cut leaves are chunks: the overflow flag and the norm's partial sums are
reduced over the data-parallel group, replicated leaves counted once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..comm import comm
from ..ops.kernels.fused_adam import reference_sqsum
from .config import FP16Config


class DynamicLossScaler:
    """Overflow with hysteresis left: decrement it; at hysteresis 1: halve
    the scale (not below ``min_loss_scale``).  After ``loss_scale_window``
    clean steps: double it.  Hysteresis restores on every clean step under
    ``consecutive_hysteresis``, else when the scale grows.  A static scale
    never changes."""

    def __init__(self, initial_scale_power: int = 16,
                 loss_scale_window: int = 1000, hysteresis: int = 2,
                 min_loss_scale: float = 1.0, static_scale: float = 0.0,
                 consecutive_hysteresis: bool = False):
        self.init_scale = (static_scale if static_scale > 0
                           else 2.0 ** initial_scale_power)
        self.window = loss_scale_window
        self.hysteresis_init = hysteresis
        self.min_scale = min_loss_scale
        self.static = static_scale > 0
        self.consecutive_hysteresis = consecutive_hysteresis
        self.scale = float(self.init_scale)
        self.growth_counter = 0
        self.hysteresis = hysteresis

    @classmethod
    def from_config(cls, fp16: FP16Config) -> "DynamicLossScaler":
        """Caps ``initial_scale_power`` at 15: the loss cotangent enters the
        fp16 graph carrying the scale, and fp16's max is 65504."""
        return cls(initial_scale_power=min(fp16.initial_scale_power, 15),
                   loss_scale_window=fp16.loss_scale_window,
                   hysteresis=fp16.hysteresis,
                   min_loss_scale=fp16.min_loss_scale,
                   static_scale=fp16.loss_scale,
                   consecutive_hysteresis=fp16.consecutive_hysteresis)

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs to skip and grow as this one would."""
        return {"scale": self.scale, "growth_counter": self.growth_counter,
                "hysteresis": self.hysteresis}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.scale = float(state["scale"])
        self.growth_counter = int(state["growth_counter"])
        self.hysteresis = int(state["hysteresis"])

    def update(self, overflow: bool) -> None:
        if self.static:
            return
        if overflow:
            if self.hysteresis <= 1:
                self.scale = max(self.scale / 2.0, self.min_scale)
            else:
                self.hysteresis -= 1
            self.growth_counter = 0
            return
        if self.consecutive_hysteresis:
            self.hysteresis = self.hysteresis_init
        self.growth_counter += 1
        if self.growth_counter >= self.window:
            if not self.consecutive_hysteresis:
                self.hysteresis = self.hysteresis_init
            self.scale *= 2.0
            self.growth_counter = 0


def partial_norm_terms(grads: Sequence[torch.Tensor],
                replicated: Sequence[torch.Tensor],
                group: Any) -> List[torch.Tensor]:
    """What this rank adds to a sum over the whole model: its chunks, and
    the replicated leaves on group rank 0 only (every rank holds them)."""
    if group is None or comm.get_rank(group) == 0:
        return list(grads) + list(replicated)
    return list(grads)


def has_overflow(grads: Sequence[torch.Tensor],
                 group: Any = None) -> torch.Tensor:
    """0-dim bool: some gradient entry is not finite, on this rank or (with
    ``group``, a data-parallel group over whose ranks the gradients are
    cut) on any rank of ``group``: the flag is max-reduced, so every rank
    skips the step together."""
    grads = list(grads)
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    flag = torch.stack([~torch.isfinite(g).all() for g in grads]).any()
    if group is None:
        return flag
    flag = flag.to(torch.float32)
    comm.all_reduce(flag, comm.ReduceOp.MAX, group=group)
    return flag > 0


def global_grad_norm(grads: Sequence[torch.Tensor],
                     replicated: Sequence[torch.Tensor] = (),
                     group: Any = None) -> torch.Tensor:
    """0-dim fp32 ``sqrt(sum g^2)`` over the whole model (the plain version
    of the fused step's Σg² kernel).  Without ``group`` the gradients are
    whole (``replicated`` adds to them); with it, ``grads`` are this
    rank's chunks of the cut leaves and ``replicated`` the leaves every
    rank holds whole: each rank's partial sum is all-reduced, the
    replicated leaves counted once."""
    part = reference_sqsum(partial_norm_terms(grads, replicated, group))
    if group is not None:
        comm.all_reduce(part, group=group)
    return part.sqrt()


def clip_grads_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                              precomputed_norm: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Scale the gradients in place by ``min(1, max_norm / (norm + 1e-6))``;
    returns the norm before clipping (``precomputed_norm``, the global one
    over chunks, when given)."""
    norm = (precomputed_norm if precomputed_norm is not None
            else global_grad_norm(grads))
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, factor)
    return norm
