"""DeepSpeedCPUAdagrad (``deepspeed_tpu/ops/adam/cpu_adagrad.py``): the
host Adagrad of ``csrc/host/cpu_adam.cpp`` over fp32 CPU tensors."""

from __future__ import annotations

import ctypes
from typing import Any, List, Optional, Sequence

import torch

from .cpu_adam import f32_ptr, grad_fp32, host_fp32, host_lib


class DeepSpeedCPUAdagrad:
    def __init__(self, model_params: Sequence[Any], lr: float = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 pin_memory: bool = False):
        host_lib()
        self.params: List[torch.Tensor] = [host_fp32(p, pin_memory)
                                           for p in model_params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self.state_step = 0
        self._lr = float(lr)

    def begin_step(self, lr: Optional[float] = None) -> None:
        self.state_step += 1
        self._lr = float(lr if lr is not None else self.lr)

    def step_slot(self, i: int, grad: Any,
                  bf16_out: Optional[torch.Tensor] = None) -> None:
        if bf16_out is not None:
            raise NotImplementedError("bf16 wire emit is Adam-only")
        p = self.params[i]
        host_lib().ds_adagrad_step(
            f32_ptr(p), f32_ptr(grad_fp32(grad)),
            f32_ptr(self.exp_avg_sq[i]), ctypes.c_int64(p.numel()),
            ctypes.c_int(self.state_step), ctypes.c_float(self._lr),
            ctypes.c_float(self.eps), ctypes.c_float(self.weight_decay))

    def step(self, grads: Sequence[Any], lr: Optional[float] = None) -> None:
        self.begin_step(lr)
        for i in range(len(self.params)):
            self.step_slot(i, grads[i])
