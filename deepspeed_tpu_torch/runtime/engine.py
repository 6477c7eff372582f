"""The training engine: one device, ZeRO stage 0.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``):
``train_step`` follows ``_build_train_step`` and ``_grad_core``:

1. split the batch into ``gas`` microbatches; each loss is scaled by
   ``scale / gas`` under fp16, else by ``1 / gas``, and its gradient is
   accumulated into the fp32 master parameters' ``.grad``;
2. under fp16: unscale, check for overflow; on overflow zero the gradients
   and skip the update (parameters, optimizer state and the step count stay
   as they were), then update the loss scaler;
3. clip by global norm (or only measure it);
4. take the optimizer step at ``lr = schedule(step)``, the step counted
   after;
5. return ``{loss, grad_norm, lr, loss_scale, overflow}``.

The DeepSpeed-style ``forward`` / ``backward`` / ``step`` are the same
three stages driven by the caller: ``forward`` returns the microbatch's
loss with its graph, ``backward`` scales it and accumulates its gradient,
``step`` does 2-5 at the accumulation boundary (``train_step`` is built
from them).  The JAX engine compiled the whole step into one program and
kept its state functional; here PyTorch runs eagerly and updates the
parameters in place.  ``loss`` and ``grad_norm`` in the metrics are 0-dim
fp32 tensors on the device (read them when needed: reading syncs);
``lr``, ``loss_scale`` and ``overflow`` are host numbers.  Checkpointing,
ZeRO above 0, offload and the telemetry plane are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import log_dist
from .config import DeepSpeedConfig
from .lr_schedules import (LRScheduler, Schedule, constant_lr,
                           get_lr_schedule)
from .optimizers import base_lr, build_optimizer
from .precision import (DynamicLossScaler, clip_grads_by_global_norm,
                        global_grad_norm, has_overflow)

LossFn = Callable[[Any], torch.Tensor]


class DeepSpeedEngine:
    """``(loss_fn, fp32 master parameters, config)`` on one device."""

    def __init__(self, loss_fn: LossFn, params: List[torch.Tensor],
                 config: DeepSpeedConfig, module: Any = None,
                 device: DeviceLike = "cuda",
                 lr_schedule: Optional[Schedule] = None):
        self.device = resolve_device(device)
        self.config = config
        self.loss_fn = loss_fn
        self.module = module
        self.params = [p for p in params if p.requires_grad]
        for p in self.params:
            if p.device.type != self.device.type:
                raise ValueError(f"a parameter is on {p.device}, the engine "
                                 f"was asked to run on {self.device}")
            if p.dtype != torch.float32:
                raise TypeError(
                    f"parameters must be fp32 masters, got {p.dtype}: build "
                    "the model with LlamaConfig(param_dtype=torch.float32)")
        self.compute_dtype = config.dtype()
        model_dtype = getattr(getattr(module, "config", None), "dtype", None)
        if model_dtype is not None and model_dtype != self.compute_dtype:
            raise ValueError(f"the model computes in {model_dtype}, the "
                             f"config asks for {self.compute_dtype} "
                             "(bf16.enabled / fp16.enabled)")
        self.fp16_enabled = config.fp16.enabled is True
        self.bf16_enabled = config.bf16.enabled is True
        self.gradient_accumulation_steps = int(
            config.gradient_accumulation_steps)
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        clip = config.gradient_clipping
        self.gradient_clipping = 0.0 if isinstance(clip, str) else float(clip)
        self.steps_per_print = config.steps_per_print

        if lr_schedule is not None:
            self._schedule = lr_schedule
        elif config.scheduler is not None:
            self._schedule = get_lr_schedule(config.scheduler.type,
                                             config.scheduler.params)
        else:
            self._schedule = constant_lr(base_lr(config))
        self.lr_scheduler = LRScheduler(self._schedule)
        self.optimizer = build_optimizer(config, self.params)
        self.loss_scaler = (DynamicLossScaler.from_config(config.fp16)
                            if self.fp16_enabled else None)

        self.global_steps = 0     # train steps taken, skipped ones included
        self.micro_steps = 0
        self._skipped_steps = 0
        self._micro_in_step = 0   # microbatches accumulated since the step
        self._loss_sum: Optional[torch.Tensor] = None
        self._accumulation_boundary_forced: Optional[bool] = None
        self.last_metrics: Dict[str, Any] = {}

    # -- the three stages -------------------------------------------------

    def _to_device(self, batch: Any) -> Any:
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return batch

    @property
    def loss_scale(self) -> float:
        return self.loss_scaler.scale if self.loss_scaler is not None else 1.0

    def forward(self, batch: Any) -> torch.Tensor:
        """The microbatch's loss, with its graph (unscaled)."""
        return self.loss_fn(self._to_device(batch))

    __call__ = forward

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """Accumulate ``d(loss * scale / gas)`` into the masters' ``.grad``
        (``scale`` is 1 without fp16)."""
        gas = self.gradient_accumulation_steps
        scaled = ((loss * self.loss_scale / gas).float() if self.fp16_enabled
                  else loss / gas)
        scaled.backward()
        part = scaled.detach().float()
        self._loss_sum = part if self._loss_sum is None else \
            self._loss_sum + part
        self._micro_in_step += 1
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        if self._accumulation_boundary_forced is not None:
            return self._accumulation_boundary_forced
        return self._micro_in_step >= self.gradient_accumulation_steps

    def set_gradient_accumulation_boundary(self, is_boundary: bool) -> None:
        self._accumulation_boundary_forced = is_boundary

    def step(self) -> Optional[Dict[str, Any]]:
        """At the accumulation boundary: unscale, overflow check, clip, the
        optimizer step; returns the step's metrics (None before the
        boundary).  A boundary forced after ``n < gas`` microbatches
        averages over those ``n``, as the JAX engine's partial step does."""
        if not self.is_gradient_accumulation_boundary() or \
                self._micro_in_step == 0:
            return None
        n, gas = self._micro_in_step, self.gradient_accumulation_steps
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        mean_loss = self._loss_sum
        scale = self.loss_scale
        # 1/scale (fp16) and gas/n (a forced partial boundary) in one pass
        unscale = (1.0 / scale if self.fp16_enabled else 1.0) * gas / n
        if unscale != 1.0:
            torch._foreach_mul_(grads, unscale)
            mean_loss = mean_loss * unscale
        overflow = bool(has_overflow(grads)) if self.fp16_enabled else False
        if overflow:
            torch._foreach_zero_(grads)
        if self.gradient_clipping > 0:
            grad_norm = clip_grads_by_global_norm(grads,
                                                  self.gradient_clipping)
        else:
            grad_norm = global_grad_norm(grads)
        lr = self._schedule(self.optimizer.count)
        if overflow:
            self._skipped_steps += 1
        else:
            for p, g in zip(self.params, grads):
                p.grad = g
            self.optimizer.step(lr)
        if self.loss_scaler is not None:
            self.loss_scaler.update(overflow)
        self.zero_grad()
        self._micro_in_step, self._loss_sum = 0, None
        self.global_steps += 1
        self.lr_scheduler.last_step = self.optimizer.count
        self.last_metrics = {"loss": mean_loss, "grad_norm": grad_norm,
                             "lr": lr, "loss_scale": scale,
                             "overflow": overflow}
        if self.steps_per_print and \
                self.global_steps % int(self.steps_per_print) == 0:
            log_dist(f"step={self.global_steps} loss={float(mean_loss):.4f} "
                     f"lr={lr:.3e} grad_norm={float(grad_norm):.3f} "
                     f"loss_scale={scale:.0f}")
        return self.last_metrics

    def train_step(self, batch: Any) -> Dict[str, Any]:
        """One optimizer step over the global batch (its leading dim split
        into ``gas`` microbatches of consecutive rows)."""
        if self._micro_in_step:
            raise RuntimeError("train_step() called with microbatches from "
                               "backward() still pending a step()")
        gas = self.gradient_accumulation_steps
        batch = self._to_device(batch)
        rows = _rows(batch)
        if rows % gas:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"gradient_accumulation_steps={gas}")
        forced, self._accumulation_boundary_forced = \
            self._accumulation_boundary_forced, None
        try:
            for i in range(gas):
                self.backward(self.forward(_slice_rows(
                    batch, i * rows // gas, (i + 1) * rows // gas)))
            return self.step()
        finally:
            self._accumulation_boundary_forced = forced

    # -- evaluation and introspection --------------------------------------

    @torch.no_grad()
    def eval_loss(self, batch: Any) -> torch.Tensor:
        return self.loss_fn(self._to_device(batch))

    def get_lr(self) -> List[float]:
        """The rate the next step applies (skipped steps do not count)."""
        self.lr_scheduler.last_step = self.optimizer.count
        return [float(self._schedule(self.optimizer.count))]

    def get_global_grad_norm(self) -> Optional[float]:
        if "grad_norm" not in self.last_metrics:
            return None
        return float(self.last_metrics["grad_norm"])

    def get_loss_scale(self) -> float:
        return self.loss_scale

    @property
    def overflow(self) -> bool:
        """fp16 skip signal of the last step."""
        return bool(self.last_metrics.get("overflow", False))

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def train(self, mode: bool = True) -> "DeepSpeedEngine":
        return self

    def eval(self) -> "DeepSpeedEngine":
        return self


def _rows(batch: Any) -> int:
    if isinstance(batch, dict):
        return next(iter(batch.values())).shape[0]
    return batch.shape[0]


def _slice_rows(batch: Any, lo: int, hi: int) -> Any:
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]
