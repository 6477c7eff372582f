"""MoE token dispatch and combine in index form: two hand-written CUDA
kernels for Hopper beside their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/
moe_dispatch.py``: ``_pallas_dispatch_fwd`` (by the kernel behind
:func:`moe_dispatch`) and ``_pallas_combine_fwd`` (by the kernel behind
:func:`moe_combine`).  The CUDA source is
``deepspeed_tpu_torch/csrc/moe_dispatch.cu``.

The routing decision arrives as indices (:func:`routing_to_indices`):

* dispatch: ``src_idx [E, C]`` names the token that fills slot ``c`` of
  expert ``e`` (``EMPTY_SLOT`` for an unfilled slot), and
  ``expert_in[e, c] = tokens[src]`` is a row copy, zero for an empty slot;
* combine: ``flat_idx [T, K]`` addresses the flattened ``[E·C, H]`` expert
  output (``E·C`` for a dropped assignment) with renormalised ``gates [T,
  K]``: ``y[t] = Σ_k gates[t, k] · out[flat_idx[t, k]]``.

Bound on the card: the bytes.  Dispatch moves each expert slot's row once
in and once out; combine reads K rows per token and writes one.

Each wrapper is a ``torch.autograd.Function``: its forward is the CUDA
kernel on a CUDA tensor and the plain version on a CPU tensor; its backward
is plain PyTorch (``index_add_``), exactly as the JAX ``custom_vjp``
backward is jnp.  A token receives at most K dispatch cotangents and a kept
combine slot at most one, so the atomic adds of ``index_add_`` on the card
sum at most two terms into a zero: the result does not depend on their
order.  Nothing falls back to the plain version on a CUDA tensor: a failed
build or launch raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import op_builder
from .common import DTYPE_CODES

Tensor = torch.Tensor

#: src_idx value marking an unfilled expert slot
EMPTY_SLOT = -1

#: ``auto`` keeps the dense einsum at or below this T·E·C volume (kept at
#: the JAX package's value so that configs resolve to the same rung)
DENSE_CROSSOVER_TEC = 1 << 16


# -- index construction -----------------------------------------------------

def routing_to_indices(expert_idx: Tensor, slot: Tensor, keep: Tensor,
                       num_experts: int, capacity: int
                       ) -> Tuple[Tensor, Tensor]:
    """Per-choice routing ``(expert_idx [K, T], slot [K, T], keep [K, T])``
    → ``(src_idx [E, C], flat_idx [T, K])``, both int32.  Kept ``(e, c)``
    pairs are unique (a slot is a running count within its expert), so
    only dropped assignments collide, on the pad entry ``E·C``."""
    E, C = num_experts, capacity
    K, T = expert_idx.shape
    tid = torch.arange(T, dtype=torch.int32,
                       device=expert_idx.device).expand(K, T)
    flat_ec = torch.where(keep, expert_idx.long() * C + slot.long(),
                          torch.full_like(expert_idx, E * C,
                                          dtype=torch.long))
    src = torch.full((E * C + 1,), EMPTY_SLOT, dtype=torch.int32,
                     device=expert_idx.device)
    src[flat_ec.reshape(-1)] = tid.reshape(-1)
    src_idx = src[:E * C].reshape(E, C)
    flat_idx = flat_ec.t().to(torch.int32).contiguous()
    return src_idx, flat_idx


# -- plain versions ---------------------------------------------------------

def dispatch_reference(tokens: Tensor, src_idx: Tensor) -> Tensor:
    """``tokens [T, H]`` gathered into ``[E, C, H]``; empty slots are zero.
    Clamp-and-mask, as the JAX reference (no zero-padded token copy)."""
    T, H = tokens.shape
    E, C = src_idx.shape
    idx = src_idx.clamp(0, T - 1).reshape(-1).long()
    out = tokens[idx].reshape(E, C, H)
    return out * (src_idx >= 0)[..., None].to(tokens.dtype)


def combine_reference(expert_out: Tensor, flat_idx: Tensor,
                      gates: Tensor) -> Tensor:
    """``expert_out [E, C, H]`` + ``flat_idx / gates [T, K]`` → ``y [T, H]
    = Σ_k gates[t, k] · expert_out.flat[flat_idx[t, k]]``, in
    ``expert_out``'s dtype; an index ``E·C`` contributes nothing."""
    E, C, H = expert_out.shape
    flat = expert_out.reshape(E * C, H)
    valid = flat_idx < E * C
    idx = flat_idx.clamp(0, E * C - 1).reshape(-1).long()
    picked = flat[idx].reshape(*flat_idx.shape, H)
    w = torch.where(valid, gates, torch.zeros_like(gates))[..., None].to(
        expert_out.dtype)
    return (w * picked).sum(dim=1)


# -- the kernels' wrappers --------------------------------------------------

def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(name: str, t: Tensor) -> None:
    """What the CUDA kernels need of a row-major operand: a supported
    dtype, contiguity, rows of whole 16-byte vectors on a 16-byte
    boundary."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} has no CUDA kernel "
                        "(fp32, bf16 or fp16)")
    if not t.is_contiguous():
        raise ValueError(f"{name} of shape {tuple(t.shape)} must be "
                         "contiguous")
    if (t.shape[-1] * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {t.shape[-1]} x "
                         f"{t.element_size()} bytes are not whole, aligned "
                         "16-byte vectors")


def _check_device(*tensors: Tensor) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all arguments must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe dispatch: unsupported device "
                         f"{tensors[0].device}")


def moe_dispatch_fwd(tokens: Tensor, src_idx: Tensor) -> Tensor:
    """``[E, C, H]`` expert buffers: the dispatch kernel on a CUDA tensor,
    :func:`dispatch_reference` on a CPU tensor."""
    if tokens.dim() != 2 or src_idx.dim() != 2 or \
            src_idx.dtype != torch.int32:
        raise ValueError(f"tokens must be [T, H] and src_idx int32 [E, C], "
                         f"got {tuple(tokens.shape)}, {src_idx.dtype} "
                         f"{tuple(src_idx.shape)}")
    _check_device(tokens, src_idx)
    if tokens.device.type == "cpu":
        return dispatch_reference(tokens, src_idx)
    _check_rows("tokens", tokens)
    T, H = tokens.shape
    E, C = src_idx.shape
    src_idx = src_idx.contiguous()
    out = torch.empty(E, C, H, dtype=tokens.dtype, device=tokens.device)
    status = op_builder.load_library().ds_moe_dispatch(
        tokens.data_ptr(), src_idx.data_ptr(), out.data_ptr(), T, E * C,
        H * tokens.element_size(), _stream(tokens))
    op_builder.check(status, "moe_dispatch")
    moe_dispatch_fwd.launches += 1
    return out


def moe_combine_fwd(expert_out: Tensor, flat_idx: Tensor, gates: Tensor
                    ) -> Tensor:
    """``y [T, H]`` in ``expert_out``'s dtype: the combine kernel (fp32
    accumulation) on a CUDA tensor, :func:`combine_reference` on a CPU
    tensor."""
    if expert_out.dim() != 3 or flat_idx.dim() != 2 or \
            flat_idx.dtype != torch.int32 or gates.shape != flat_idx.shape:
        raise ValueError(f"expert_out must be [E, C, H], flat_idx int32 "
                         f"[T, K] and gates [T, K], got "
                         f"{tuple(expert_out.shape)}, {flat_idx.dtype} "
                         f"{tuple(flat_idx.shape)}, {tuple(gates.shape)}")
    _check_device(expert_out, flat_idx, gates)
    if expert_out.device.type == "cpu":
        return combine_reference(expert_out, flat_idx, gates)
    _check_rows("expert_out", expert_out)
    E, C, H = expert_out.shape
    T, K = flat_idx.shape
    flat_idx = flat_idx.contiguous()
    gates = gates.float().contiguous()
    y = torch.empty(T, H, dtype=expert_out.dtype, device=expert_out.device)
    status = op_builder.load_library().ds_moe_combine(
        expert_out.data_ptr(), flat_idx.data_ptr(), gates.data_ptr(),
        y.data_ptr(), T, K, E * C, H, DTYPE_CODES[expert_out.dtype],
        _stream(expert_out))
    op_builder.check(status, "moe_combine")
    moe_combine_fwd.launches += 1
    return y


#: kernel launches since the last reset (CPU calls never count)
moe_dispatch_fwd.launches = 0
moe_combine_fwd.launches = 0


class _Dispatch(torch.autograd.Function):
    """Forward: the dispatch kernel; backward: the gather's transpose, a
    scatter-add of each slot's cotangent to its token (JAX
    ``_pallas_dispatch_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, tokens, src_idx):
        ctx.save_for_backward(src_idx)
        ctx.num_tokens = tokens.shape[0]
        return moe_dispatch_fwd(tokens, src_idx)

    @staticmethod
    def backward(ctx, g):
        src_idx, = ctx.saved_tensors
        T, H = ctx.num_tokens, g.shape[-1]
        idx = torch.where(src_idx >= 0, src_idx,
                          torch.full_like(src_idx, T)).reshape(-1).long()
        d_tokens = torch.zeros(T + 1, H, dtype=g.dtype, device=g.device)
        d_tokens.index_add_(0, idx, g.reshape(-1, H))
        return d_tokens[:T], None


class _Combine(torch.autograd.Function):
    """Forward: the combine kernel; backward: ``d_gates`` in fp32 from the
    picked rows, and the weighted cotangent scatter-added into the expert
    output (JAX ``_pallas_combine_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, expert_out, flat_idx, gates):
        ctx.save_for_backward(expert_out, flat_idx, gates)
        return moe_combine_fwd(expert_out, flat_idx, gates)

    @staticmethod
    def backward(ctx, g):
        expert_out, flat_idx, gates = ctx.saved_tensors
        E, C, H = expert_out.shape
        T, K = flat_idx.shape
        flat = expert_out.reshape(E * C, H)
        valid = (flat_idx < E * C)[..., None]
        idx = flat_idx.clamp(0, E * C - 1).reshape(-1).long()
        picked = flat[idx].reshape(T, K, H)
        d_gates = torch.einsum(
            "th,tkh->tk", g.float(),
            torch.where(valid, picked, torch.zeros_like(picked)).float()
        ).to(gates.dtype)
        weighted = gates[..., None].to(g.dtype) * g[:, None, :]  # [T, K, H]
        d_flat = torch.zeros(E * C + 1, H, dtype=g.dtype, device=g.device)
        d_flat.index_add_(0, flat_idx.reshape(-1).long(),
                          weighted.reshape(-1, H))
        return d_flat[:E * C].reshape(E, C, H), None, d_gates


def moe_dispatch(tokens: Tensor, src_idx: Tensor) -> Tensor:
    """Token dispatch with a gradient: ``tokens [T, H]`` + ``src_idx [E,
    C]`` → ``[E, C, H]`` (JAX ``pallas_dispatch``)."""
    return _Dispatch.apply(tokens, src_idx)


def moe_combine(expert_out: Tensor, flat_idx: Tensor, gates: Tensor
                ) -> Tensor:
    """Token combine with a gradient: ``expert_out [E, C, H]`` +
    ``flat_idx / gates [T, K]`` → ``y [T, H]`` (JAX ``pallas_combine``)."""
    return _Combine.apply(expert_out, flat_idx, gates)


def choose_dispatch_impl(impl: str, num_tokens: int, num_experts: int,
                         capacity: int,
                         device: Optional[torch.device] = None) -> str:
    """Resolve ``auto | dense | sparse | pallas`` to a rung.  ``pallas``
    names the hand-written kernel rung.  ``auto``: T·E·C at or below
    :data:`DENSE_CROSSOVER_TEC` keeps the dense einsum; above it a CUDA
    ``device`` takes the kernels and anything else the plain sparse path.
    The port has no expert-sharded mesh yet, so JAX's sharded branch has
    no counterpart here."""
    if impl not in ("auto", "dense", "sparse", "pallas"):
        raise ValueError(f"unknown moe dispatch impl {impl!r} "
                         "(expected auto|dense|sparse|pallas)")
    if impl != "auto":
        return impl
    if num_tokens * num_experts * capacity <= DENSE_CROSSOVER_TEC:
        return "dense"
    if device is None or torch.device(device).type != "cuda":
        return "sparse"
    return "pallas"
