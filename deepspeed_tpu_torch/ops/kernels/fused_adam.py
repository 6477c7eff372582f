"""Multi-tensor gradient norm and fused Adam: two hand-written CUDA kernels
for Hopper beside their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/
fused_optimizer.py``: ``leaf_sqsum`` (by the kernel behind
:func:`tree_sqsum`) and ``fused_adam_leaf`` (by the kernel behind
:func:`fused_adam`).  The CUDA source is
``deepspeed_tpu_torch/csrc/fused_adam.cu``.

The engine's fused step (``runtime/engine.py``, ``kernels.fused_adam``) is
two passes over the fp32 lists instead of the plain step's several sweeps:

1. :func:`tree_sqsum` reads the still-scaled gradients once and returns
   ``Σ g²``, a 0-dim fp32 tensor on the device; a NaN or Inf anywhere
   reaches it, which is the fp16 overflow signal;
2. :func:`fused_adam` reads p, g, m, v once and writes p, m, v in place:
   ``g · mult`` (unscale × clip × overflow zero, folded into one scalar),
   both moments, bias correction, weight decay and the update, in the
   operation order of ``optax.scale_by_adam`` (the TPU kernel's order).

Bound on the card: the bytes (the norm reads 4 bytes an element, Adam 28).
One launch covers a whole list: the tensors are cut into chunks of
:data:`CHUNK` elements, one thread block a chunk, and a
:class:`MultiTensorPlan` holds the chunk table on the device, built once
for a list of shapes (the masters do not move).  The step's scalars
``[lr, mult, bc1, bc2]`` sit in a 4-float device tensor, as the TPU
kernel's ``sc_ref`` sat in SMEM: ``mult`` comes from the on-device norm,
and a bf16 or fp32 step never reads the norm on the host.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels and raise on any failure.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import op_builder

Tensor = torch.Tensor
Scalar = Union[float, Tensor]

#: elements per thread block (a multiple of 4: chunks start on 16 bytes)
CHUNK = 16384


class FusedAdamConfig(NamedTuple):
    """The step's fixed hyperparameters (JAX ``FusedAdamConfig``)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    #: True: AdamW (decay added to the update direction); False with a
    #: weight decay: L2 (decay added to the gradient before the moments)
    decoupled_wd: bool = True


def bias_corrections(cfg: FusedAdamConfig,
                     count_inc: int) -> Tuple[float, float]:
    """``1 - b^count_inc`` for both moments, in float32 (as the JAX step
    computes them on the device), returned as Python floats."""
    n = np.float32(count_inc)
    one = np.float32(1.0)
    return (float(one - np.float32(cfg.b1) ** n),
            float(one - np.float32(cfg.b2) ** n))


# -- plain versions ---------------------------------------------------------

def reference_sqsum(tensors: Sequence[Tensor]) -> Tensor:
    """``Σ g²`` over every tensor, fp32, 0-dim."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([t.float().square().sum() for t in tensors]).sum()


#: elements per group of tensors the plain step updates together: bounds
#: its temporaries (about three groups of fp32 at a time)
PLAIN_GROUP = 1 << 27


def _groups(numels: Sequence[int]) -> List[Tuple[int, int]]:
    """Consecutive ``[lo, hi)`` index ranges of at most
    :data:`PLAIN_GROUP` elements (a larger tensor alone)."""
    out, lo, size = [], 0, 0
    for i, n in enumerate(numels):
        if i > lo and size + n > PLAIN_GROUP:
            out.append((lo, i))
            lo, size = i, 0
        size += n
    if lo < len(numels):
        out.append((lo, len(numels)))
    return out


@torch.no_grad()
def reference_adam(params: Sequence[Tensor], grads: Sequence[Tensor],
                   ms: Sequence[Tensor], vs: Sequence[Tensor],
                   count_inc: int, lr: Scalar, mult: Scalar = 1.0,
                   cfg: FusedAdamConfig = FusedAdamConfig()) -> None:
    """One Adam step, in place, in the kernel's operation order (JAX
    ``reference_adam_tree``, ``optax.scale_by_adam``): each operation a
    ``torch._foreach_*`` call of one multiply, add, division or root, so
    every result rounds on its own, as the kernel's ``__fmul_rn`` /
    ``__fadd_rn`` do, over groups of tensors of at most
    :data:`PLAIN_GROUP` elements.  The bias corrections are float32
    values and divide truly, so the moments and parameters equal the
    kernel's bit for bit."""
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1, bc2 = bias_corrections(cfg, count_inc)
    params, grads, ms, vs = (list(x) for x in (params, grads, ms, vs))
    for lo, hi in _groups([p.numel() for p in params]):
        p, m, v = params[lo:hi], ms[lo:hi], vs[lo:hi]
        g = [x.float() for x in grads[lo:hi]]
        if isinstance(mult, Tensor) or mult != 1.0:
            g = torch._foreach_mul(g, mult)
        if wd and not cfg.decoupled_wd:
            g = torch._foreach_add(g, torch._foreach_mul(p, wd))
        torch._foreach_mul_(m, b1)                      # (1-b1) g + b1 m
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        gg = torch._foreach_mul(g, g)                   # (1-b2) g² + b2 v
        torch._foreach_mul_(gg, 1.0 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        del gg, g
        # m̂ / (√v̂ + eps); a scalar list, not a scalar: the card divides
        # a foreach list by one scalar as a product with its reciprocal
        direction = torch._foreach_div(m, [bc1] * len(m))
        denom = torch._foreach_div(v, [bc2] * len(v))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(direction, denom)
        del denom
        if wd and cfg.decoupled_wd:
            torch._foreach_add_(direction, torch._foreach_mul(p, wd))
        torch._foreach_mul_(direction, -lr)            # p + (-lr) direction
        torch._foreach_add_(p, direction)


# -- the chunk table --------------------------------------------------------

def _upload(values: Union[List[int], np.ndarray],
            device: torch.device) -> Tensor:
    """int64 values to the device through pinned memory, without making the
    host wait for the device (the pinned block is not reused before the
    copy has run)."""
    host = torch.from_numpy(np.asarray(values, dtype=np.int64)).pin_memory()
    return host.to(device, non_blocking=True)


def chunk_table(numels: Sequence[int]) -> np.ndarray:
    """int64 ``[3, num_chunks]``: for each chunk of :data:`CHUNK` elements
    (the last of a tensor shorter), its tensor index, start and length."""
    index, start, length = [], [], []
    for i, n in enumerate(numels):
        s = np.arange(0, n, CHUNK, dtype=np.int64)
        index.append(np.full_like(s, i))
        start.append(s)
        length.append(np.minimum(n - s, CHUNK))
    return np.stack([np.concatenate(c) for c in (index, start, length)])


class MultiTensorPlan:
    """The chunk table of a list of fp32 tensor shapes on one CUDA device:
    int64 ``[3, num_chunks]`` rows (tensor index, start, length), every
    start a multiple of :data:`CHUNK`, and the fp32 scratch of one partial
    sum a chunk.  It depends on the shapes only, so one plan serves the
    parameters, their gradients and both moments, step after step."""

    def __init__(self, tensors: Sequence[Tensor]):
        if not tensors:
            raise ValueError("a multi-tensor plan needs at least one tensor")
        self.device = tensors[0].device
        self.numels = tuple(int(t.numel()) for t in tensors)
        table = chunk_table(self.numels)
        self.num_chunks = table.shape[1]
        if self.num_chunks >= 2 ** 31:
            raise ValueError(f"{self.num_chunks} chunks exceed one launch")
        self.chunks = _upload(table, self.device)
        self.partials = torch.empty(self.num_chunks, dtype=torch.float32,
                                    device=self.device)

    def pointers(self, *lists: Sequence[Tensor]) -> Tensor:
        """int64 ``[len(lists), num_tensors]`` device table of the lists'
        addresses, after checking each tensor against the plan."""
        rows = []
        for tensors in lists:
            if tuple(int(t.numel()) for t in tensors) != self.numels:
                raise ValueError("the tensors do not match the plan's shapes")
            for t in tensors:
                _check_fp32(t, self.device)
            rows.extend(t.data_ptr() for t in tensors)
        return _upload(rows, self.device)


def _check_fp32(t: Tensor, device: torch.device) -> None:
    """What the kernels need of a tensor: fp32, contiguous, on the plan's
    device, starting on a 16-byte boundary."""
    if t.dtype != torch.float32:
        raise TypeError(f"fused Adam takes fp32 tensors, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"a tensor is on {t.device}, the plan on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"tensor of shape {tuple(t.shape)} must be "
                         "contiguous and 16-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on_cpu(tensors: Sequence[Tensor]) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds - {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(f"unsupported or mixed devices: {sorted(kinds)}")
    return kinds == {"cpu"}


# -- the kernels' wrappers --------------------------------------------------

def tree_sqsum(grads: Sequence[Tensor],
               plan: Optional[MultiTensorPlan] = None) -> Tensor:
    """``Σ g²`` over a gradient list as a 0-dim fp32 tensor: one launch of
    the sqsum kernel on CUDA tensors (two deterministic stages, no float
    atomics: the result repeats bit for bit), :func:`reference_sqsum` on
    CPU tensors.  ``plan`` is the list's :class:`MultiTensorPlan` (built
    here when not given)."""
    grads = list(grads)
    if not grads or _on_cpu(grads):
        return reference_sqsum(grads)
    plan = plan if plan is not None else MultiTensorPlan(grads)
    ptrs = plan.pointers(grads)
    out = torch.empty((), dtype=torch.float32, device=plan.device)
    status = op_builder.load_library().ds_multi_tensor_sqsum(
        ptrs.data_ptr(), plan.chunks.data_ptr(), plan.num_chunks,
        plan.partials.data_ptr(), out.data_ptr(), _stream(plan.device))
    op_builder.check(status, "multi_tensor_sqsum")
    tree_sqsum.launches += 1
    return out


def adam_scalars(lr: float, mult: Scalar, bc1: float, bc2: float,
                 device: torch.device) -> Tensor:
    """The kernel's fp32 ``[lr, mult, bc1, bc2]`` on ``device``, written by
    fills and a device copy (no host-to-device copy that would make the
    host wait)."""
    sc = torch.empty(4, dtype=torch.float32, device=device)
    for i, x in ((0, lr), (2, bc1), (3, bc2)):
        sc[i].fill_(float(x))
    if isinstance(mult, Tensor):
        sc[1].copy_(mult.reshape(()))
    else:
        sc[1].fill_(float(mult))
    return sc


def fused_adam(params: Sequence[Tensor], grads: Sequence[Tensor],
               ms: Sequence[Tensor], vs: Sequence[Tensor], count_inc: int,
               lr: float, mult: Scalar = 1.0,
               cfg: FusedAdamConfig = FusedAdamConfig(),
               plan: Optional[MultiTensorPlan] = None) -> None:
    """One Adam step over fp32 lists, updating ``params``, ``ms`` and ``vs``
    in place (JAX ``fused_adam_tree`` / ``apply_fused_adam``).
    ``count_inc`` is the step count after this step (bias corrections
    ``1 - b^count_inc``), ``lr`` the rate, ``mult`` the gradient multiplier
    (a float or a 0-dim fp32 device tensor).  One launch of the Adam kernel
    on CUDA tensors; :func:`reference_adam` on CPU tensors."""
    params, grads, ms, vs = (list(x) for x in (params, grads, ms, vs))
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError("params, grads and both moments must pair up")
    if not params:
        return
    if _on_cpu(params + grads + ms + vs):
        reference_adam(params, grads, ms, vs, count_inc, lr, mult, cfg)
        return
    plan = plan if plan is not None else MultiTensorPlan(params)
    ptrs = plan.pointers(params, grads, ms, vs)
    bc1, bc2 = bias_corrections(cfg, count_inc)
    scalars = adam_scalars(lr, mult, bc1, bc2, plan.device)
    status = op_builder.load_library().ds_fused_adam(
        ptrs.data_ptr(), len(params), plan.chunks.data_ptr(),
        plan.num_chunks, scalars.data_ptr(), cfg.b1, cfg.b2, 1.0 - cfg.b1,
        1.0 - cfg.b2, cfg.eps, cfg.weight_decay, int(cfg.decoupled_wd),
        _stream(plan.device))
    op_builder.check(status, "fused_adam")
    fused_adam.launches += 1


#: kernel launches since the last reset (CPU calls never count)
tree_sqsum.launches = 0
fused_adam.launches = 0
