"""One-token GQA decode attention over a padded KV cache.

Replaces the Pallas TPU kernel ``decode_attention`` (``_decode_kernel``) of
``deepspeed_tpu/ops/pallas/decode_attention.py``; the CUDA kernel is
``deepspeed_tpu_torch/csrc/decode_attention.cu`` (entry point
``ds_decode_attention``), hand-written for Hopper.

Bound on the card: the K/V bytes.  Each call reads every live key and value
once (``B * len * kv_h * d * 2`` elements), at about ``2 * n_rep`` flops per
byte, far below the H100's ~295 flops per byte.  The kernel's answer: one
thread block per (sequence, kv head) that holds all the query heads of its
GQA group, so each K/V byte is read once per kv head; 16-byte vector loads;
an fp32 online softmax; no work before the window's first key or past the
sequence's length.  The JAX function routed a window and ``Smax % block_k``
to its reference; this kernel takes both natively.

On a CPU tensor the wrapper runs :func:`decode_attention_plain`; on a CUDA
tensor it launches the kernel and raises on any failure.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import op_builder
from .common import DTYPE_CODES, check_decode_args, check_kernel_args


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Transcription of the JAX reference ``_reference_decode``:
    ``q [B, h, d]`` over ``[B, Smax, kv_h, d]`` caches with ``lengths [B]``.
    K/V are repeated over the GQA group, scores are fp32 times the scale,
    masked keys get -1e30, and p is cast to q's dtype before p·V."""
    n_rep = q.shape[1] // k_cache.shape[2]
    if n_rep > 1:
        k_cache = k_cache.repeat_interleave(n_rep, dim=2)
        v_cache = v_cache.repeat_interleave(n_rep, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,bkhd->bhk", q, k_cache).float() * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
    lens = lengths.to(torch.int64)[:, None, None]
    mask = pos < lens
    if window is not None:
        mask = mask & (pos >= lens - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhk,bkhd->bhd", p, v_cache)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """``q [B, h, d]`` one-token queries over padded caches
    ``[B, Smax, kv_h, d]`` (``kv_h`` divides ``h``; query head ``i`` reads kv
    head ``i // n_rep``) with int32 ``lengths [B]`` counting the key just
    written; ``window`` keeps only the last ``window`` keys."""
    check_decode_args(q, k_cache, v_cache, lengths, window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    check_kernel_args(q, k_cache, v_cache, lengths)
    lib = op_builder.load_library()
    B, h, d = q.shape
    out = torch.empty_like(q)
    status = lib.ds_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, h, k_cache.shape[2], d,
        k_cache.shape[1], int(window) if window is not None else 0,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
decode_attention.launches = 0
