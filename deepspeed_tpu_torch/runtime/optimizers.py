"""Optimizer factory: the ds_config ``optimizer`` block to an update rule on
fp32 master parameters.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py``, which maps the
block onto optax.  The port follows optax's formulas exactly, with
``torch._foreach_*`` over all parameters at once:

* Adam: weight decay is L2 added to the gradient before the moments
  (``add_decayed_weights`` chained before ``adam``); AdamW decays the
  parameters decoupled from the moments;
* ``update = m_hat / (sqrt(v_hat) + eps)``: eps outside the root, bias
  correction from the count of applied steps, in ``optax.scale_by_adam``'s
  operation order (``ops/kernels/fused_adam.reference_adam``, tensor by
  tensor);
* Lion, SGD (``trace`` momentum) and Adagrad (``scale_by_rss``, initial
  accumulator 0.1) as optax has them.

The learning rate is passed to :meth:`step`; the engine evaluates
``schedule(step)`` before the step is counted, as optax's
``scale_by_learning_rate`` does.  Lamb, Muon and the 1-bit family raise
"not ported yet".  Under ``kernels.fused_adam`` the engine's fused step
updates :class:`Adam`'s ``m``, ``v`` and ``count`` in place through the
CUDA kernels of ``ops/kernels/fused_adam.py`` instead of calling
:meth:`Adam.step`: the fused and plain steps share one state, and a run can
switch between them (what JAX's ``find_adam_state`` /
``replace_adam_state`` keep possible for optax's state).  The plain step
is the kernel's plain version, one rounding per operation, so the two give
the same numbers.  A plain step in ``addcmul`` / ``addcdiv`` form (fewer
passes, contracted roundings) drifts from the fused one: five fp32 steps
of ``chip_smoke.py``'s narrow Mixtral on an H100 ended 7.1e-6 apart in
the loss, against the 1e-6 the two steps are held to.

Under ZeRO stages 1-3 the engine builds the optimizer over this rank's
chunks of the cut leaves (and the whole replicated ones) and passes the
chunk lists to :meth:`Optimizer.step`, so the state (m, v, Lion's m,
SGD's trace, Adagrad's sums) exists for this rank's chunks only.  Every
rule here is elementwise, so a chunk's update is that part of the whole
update and needs nothing else.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..ops.kernels.fused_adam import FusedAdamConfig, reference_adam
from .config import DeepSpeedConfig, OptimizerConfig
from .config_utils import is_auto

_NOT_PORTED = ("lamb", "fusedlamb", "onebitlamb", "onebitadam",
               "zerooneadam", "muon")


class Optimizer:
    """In-place update of ``params`` from their ``.grad``; the gradients
    are already unscaled and clipped by the engine.  The state is built
    for the shapes of ``params`` (contiguous fp32, whatever their
    strides)."""

    def __init__(self, params: List[torch.Tensor]):
        self.params = list(params)
        self.count = 0  # applied steps

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def _state(self, fill: float = 0.0) -> List[torch.Tensor]:
        return [torch.full(p.shape, fill, dtype=torch.float32,
                           device=p.device) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float, params: Optional[List[torch.Tensor]] = None,
             grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update of ``params`` (default: the tensors the optimizer was
        built over) from ``grads`` (default: their ``.grad``), tensors of
        the state's shapes, in its order."""
        params = self.params if params is None else list(params)
        grads = self._grads() if grads is None else list(grads)
        self.count += 1
        self._update(params, grads, lr)

    def _update(self, params: List[torch.Tensor],
                grads: List[torch.Tensor], lr: float) -> None:
        raise NotImplementedError


class Adam(Optimizer):
    """optax ``adam`` (``decoupled=False``: L2 weight decay added to the
    gradient first) or ``adamw`` (decoupled weight decay)."""

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True):
        super().__init__(params)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.decoupled = decoupled
        self.m, self.v = self._state(), self._state()

    def fused_config(self) -> FusedAdamConfig:
        """The hyperparameters of the fused kernel that takes this step."""
        return FusedAdamConfig(b1=self.b1, b2=self.b2, eps=self.eps,
                               weight_decay=self.weight_decay,
                               decoupled_wd=self.decoupled)

    def _update(self, params, grads, lr):
        reference_adam(params, grads, self.m, self.v, self.count, lr,
                       1.0, self.fused_config())


class Lion(Optimizer):
    """optax ``lion``: ``sign((1-b1) g + b1 m)``, then decoupled decay."""

    def __init__(self, params, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.weight_decay = float(weight_decay)
        self.m = self._state()

    def _update(self, params, grads, lr):
        upd = torch._foreach_mul(self.m, self.b1)
        torch._foreach_add_(upd, grads, alpha=1.0 - self.b1)
        torch._foreach_sign_(upd)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        torch._foreach_mul_(self.m, self.b2)
        torch._foreach_add_(self.m, grads, alpha=1.0 - self.b2)


class SGD(Optimizer):
    """optax ``sgd``: ``t = g + momentum t``, ``p -= lr t``."""

    def __init__(self, params, momentum: float = 0.0):
        super().__init__(params)
        self.momentum = float(momentum)
        self.trace = self._state()

    def _update(self, params, grads, lr):
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        torch._foreach_add_(params, self.trace, alpha=-lr)


class Adagrad(Optimizer):
    """optax ``adagrad``: ``s += g^2``, ``p -= lr g / sqrt(s + eps)``."""

    def __init__(self, params, eps: float = 1e-7,
                 initial_accumulator_value: float = 0.1):
        super().__init__(params)
        self.eps = float(eps)
        self.sum_sq = self._state(initial_accumulator_value)

    def _update(self, params, grads, lr):
        torch._foreach_addcmul_(self.sum_sq, grads, grads)
        scale = torch._foreach_add(self.sum_sq, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(params, scale, alpha=-lr)


def _clean_params(cfg: OptimizerConfig) -> Dict[str, Any]:
    return {k: v for k, v in cfg.params.items() if not is_auto(v)}


def build_optimizer(config: DeepSpeedConfig,
                    params: List[torch.Tensor]) -> Optimizer:
    """The base optimizer (no clipping: the engine clips, so the reported
    grad norm is the one before clipping)."""
    opt_cfg = config.optimizer or OptimizerConfig()
    name = opt_cfg.type.lower().replace("_", "")
    p = _clean_params(opt_cfg)
    betas = p.get("betas", [0.9, 0.999])
    eps = float(p.get("eps", 1e-8))
    wd = float(p.get("weight_decay", 0.0))
    if name in ("adam", "fusedadam"):
        return Adam(params, betas, eps, wd, decoupled=False)
    if name in ("adamw", "deepspeedcpuadam"):
        return Adam(params, betas, eps, wd, decoupled=True)
    if name in ("lion", "deepspeedcpulion"):
        # Adam's default betas are not Lion's: only explicit betas count
        return Lion(params, betas if "betas" in p else (0.9, 0.99), wd)
    if name == "sgd":
        return SGD(params, float(p.get("momentum", 0.0)))
    if name in ("adagrad", "deepspeedcpuadagrad"):
        return Adagrad(params, eps)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {opt_cfg.type!r} is not ported "
                                  "yet")
    raise ValueError(f"Unknown optimizer type '{opt_cfg.type}'")


def base_lr(config: DeepSpeedConfig) -> float:
    """``optimizer.params.lr`` (1e-3 without an optimizer block or with
    "auto"), the constant rate without a scheduler."""
    lr = (config.optimizer.params.get("lr", 1e-3)
          if config.optimizer is not None else 1e-3)
    return 1e-3 if is_auto(lr) else float(lr)
