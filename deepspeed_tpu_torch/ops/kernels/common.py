"""Argument checks shared by the two decode-attention wrappers, and the
dtype codes and head dims every CUDA kernel of the port takes."""

from __future__ import annotations

from typing import Optional

import torch

#: dtype → the code the C entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: dtypes the attention kernels are instantiated for
ATTENTION_DTYPES = (torch.float32, torch.bfloat16)
#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128)


def check_decode_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, window: Optional[int],
                      tables: Optional[torch.Tensor] = None) -> None:
    """Raise on anything either path does not take: ``q [B, h, d]``, K/V
    ``[*, *, kv_h, d]`` in q's dtype (bf16 or fp32) with ``kv_h | h``,
    int32 ``lengths [B]`` (and int32 ``tables [B, max_blocks]``), all on one
    device, and a window of at least one key."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be [B, h, d] and K/V 4-d, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.dtype not in ATTENTION_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (bf16 or fp32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype} must match")
    B, h, d = q.shape
    kv_h = k.shape[2]
    if k.shape[3] != d:
        raise ValueError(f"head dim: q has {d}, k has {k.shape[3]}")
    if kv_h == 0 or h % kv_h:
        raise ValueError(f"kv heads {kv_h} must divide query heads {h}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{B}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if tables is not None and (tables.dim() != 2 or tables.shape[0] != B
                               or tables.dtype != torch.int32):
        raise ValueError(f"block_tables must be int32 [{B}, max_blocks], got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    tensors = [q, k, v, lengths] + ([tables] if tables is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all arguments must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *index_tensors: torch.Tensor) -> None:
    """What the CUDA kernel needs on top of :func:`check_decode_args`: a
    supported head dim, contiguous tensors, and q, K and V starting on
    16-byte boundaries (the kernel reads them with 16-byte vector loads)."""
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} has no CUDA kernel "
                         f"(supported: {KERNEL_HEAD_DIMS})")
    for t in (q, k, v, *index_tensors):
        if not t.is_contiguous():
            raise ValueError(f"tensor of shape {tuple(t.shape)} must be "
                             "contiguous")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"tensor of shape {tuple(t.shape)} is not "
                             "16-byte aligned")
