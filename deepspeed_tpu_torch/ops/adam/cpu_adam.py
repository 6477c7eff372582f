"""DeepSpeedCPUAdam: the host optimizer of ZeRO-Offload and ZeRO-Infinity.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (the reference's
``deepspeed.ops.adam.DeepSpeedCPUAdam``): a fused Adam(W) step over fp32
master tensors in host memory, by the C++ source ``csrc/host/cpu_adam.cpp``
(the JAX package's ``csrc/adam/cpu_adam.cpp``, unchanged), called through
``ctypes`` on each tensor's ``data_ptr()``.  The tensors are contiguous
CPU tensors (pinned where the engine copies them to or from the card);
the gradient of a slot arrives each step as a CPU tensor of its shape
(fp32, or a 16-bit gradient cast to fp32 first).  ``ds_adam_step_bf16``
also writes the updated parameters in bf16 (round to nearest even) into
a 16-bit tensor viewed as ``torch.bfloat16``, the copy the card reads.
The ctypes call releases the GIL, so a worker thread's step overlaps the
caller's copies.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..op_builder import CPU_ADAM

_f32p = ctypes.POINTER(ctypes.c_float)
_u16p = ctypes.POINTER(ctypes.c_uint16)


def f32_ptr(t: torch.Tensor):
    """The ``float*`` of a contiguous fp32 CPU tensor."""
    if t.dtype != torch.float32 or t.device.type != "cpu" or \
            not t.is_contiguous():
        raise ValueError(f"need a contiguous fp32 CPU tensor, got {t.dtype} "
                         f"on {t.device} (contiguous={t.is_contiguous()})")
    return ctypes.cast(t.data_ptr(), _f32p)


def u16_ptr(t: torch.Tensor):
    """The ``uint16_t*`` of a contiguous 16-bit CPU tensor (bf16)."""
    if t.element_size() != 2 or t.device.type != "cpu" or \
            not t.is_contiguous():
        raise ValueError(f"need a contiguous 16-bit CPU tensor, got "
                         f"{t.dtype} on {t.device}")
    return ctypes.cast(t.data_ptr(), _u16p)


def host_fp32(t: Any, pin: bool = False) -> torch.Tensor:
    """An fp32 contiguous CPU tensor of its own (pinned on request) with
    ``t``'s values."""
    t = torch.as_tensor(t)
    out = torch.empty(t.shape, dtype=torch.float32, pin_memory=pin)
    out.copy_(t.detach())
    return out


def grad_fp32(g: Any) -> torch.Tensor:
    """``g`` as a contiguous fp32 CPU tensor (no copy when it is one)."""
    g = torch.as_tensor(g).detach()
    if g.device.type != "cpu":
        g = g.cpu()
    if g.dtype != torch.float32:
        g = g.float()
    return g.contiguous()


def host_lib() -> ctypes.CDLL:
    """The loaded host optimizer library, its entry points typed."""
    lib = CPU_ADAM.load()
    if not getattr(lib, "_ds_typed", False):
        f, i64, i32 = ctypes.c_float, ctypes.c_int64, ctypes.c_int
        lib.ds_adam_step.argtypes = [_f32p] * 4 + [i64, i32] + [f] * 5 + \
            [i32, i32]
        lib.ds_adam_step_bf16.argtypes = [_f32p] * 4 + [_u16p, i64, i32] + \
            [f] * 5 + [i32, i32]
        lib.ds_adagrad_step.argtypes = [_f32p] * 3 + [i64, i32] + [f] * 3
        lib.ds_lion_step.argtypes = [_f32p] * 3 + [i64, i32] + [f] * 4
        lib.ds_cpu_adam_num_threads.restype = i32
        lib._ds_typed = True
    return lib


def num_threads() -> int:
    """The OpenMP threads one host step runs on."""
    return int(host_lib().ds_cpu_adam_num_threads())


def adam_step(master: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, step: int, lr: float,
              betas: Tuple[float, float], eps: float, weight_decay: float,
              adamw_mode: bool, bias_correction: bool = True,
              bf16_out: Optional[torch.Tensor] = None) -> None:
    """One fused Adam(W) step over ``master`` (fp32, in place, with its
    moments ``m`` and ``v``); ``bf16_out`` receives the result in bf16."""
    n = master.numel()
    for t in (grad, m, v) + ((bf16_out,) if bf16_out is not None else ()):
        if t.numel() != n:
            raise ValueError(f"adam_step: {t.numel()} elements against the "
                             f"master's {n}")
    common = [ctypes.c_int64(n), ctypes.c_int(int(step)),
              ctypes.c_float(lr), ctypes.c_float(betas[0]),
              ctypes.c_float(betas[1]), ctypes.c_float(eps),
              ctypes.c_float(weight_decay), ctypes.c_int(int(adamw_mode)),
              ctypes.c_int(int(bias_correction))]
    args = [f32_ptr(master), f32_ptr(grad), f32_ptr(m), f32_ptr(v)]
    if bf16_out is not None:
        host_lib().ds_adam_step_bf16(*args, u16_ptr(bf16_out), *common)
    else:
        host_lib().ds_adam_step(*args, *common)


class DeepSpeedCPUAdam:
    """Adam(W) over host fp32 copies of ``model_params`` (``pin_memory``:
    the copies are pinned), with zeroed moments."""

    def __init__(self, model_params: Sequence[Any], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 amsgrad: bool = False, adamw_mode: bool = True,
                 fp32_optimizer_states: bool = True,
                 pin_memory: bool = False):
        if amsgrad:
            raise NotImplementedError("amsgrad not supported (reference "
                                      "parity)")
        host_lib()  # build (or raise) before any state is allocated
        self.params: List[torch.Tensor] = [host_fp32(p, pin_memory)
                                           for p in model_params]
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.defaults: Dict[str, Any] = dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            bias_correction=bias_correction, adamw_mode=adamw_mode)
        self.state_step = 0
        self._lr = float(lr)

    def begin_step(self, lr: Optional[float] = None) -> None:
        """Count one optimizer step; the slots are then updated one at a
        time by :meth:`step_slot` (the offload pipeline interleaves them
        with the copies)."""
        self.state_step += 1
        self._lr = float(lr if lr is not None else self.defaults["lr"])

    def step_slot(self, i: int, grad: Any,
                  bf16_out: Optional[torch.Tensor] = None) -> None:
        """The fused step over slot ``i`` alone; ``bf16_out`` (a 16-bit
        tensor viewed as ``torch.bfloat16``) receives the updated values."""
        d = self.defaults
        adam_step(self.params[i], grad_fp32(grad), self.exp_avg[i],
                  self.exp_avg_sq[i], self.state_step, self._lr, d["betas"],
                  d["eps"], d["weight_decay"], d["adamw_mode"],
                  d["bias_correction"], bf16_out)

    def step(self, grads: Sequence[Any],
             bf16_out: Optional[Sequence[torch.Tensor]] = None,
             lr: Optional[float] = None) -> None:
        """One step over every slot; ``grads[i]`` matches ``params[i]``."""
        self.begin_step(lr)
        for i in range(len(self.params)):
            self.step_slot(i, grads[i],
                           None if bf16_out is None else bf16_out[i])
