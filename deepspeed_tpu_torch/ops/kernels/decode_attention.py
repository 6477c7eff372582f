"""One-token GQA decode attention over a padded KV cache.

Replaces the Pallas TPU kernel ``decode_attention`` (``_decode_kernel``) of
``deepspeed_tpu/ops/pallas/decode_attention.py``; the CUDA kernel is
``deepspeed_tpu_torch/csrc/decode_attention.cu`` (entry point
``ds_decode_attention``), hand-written for Hopper.

Bound on the card: the K/V bytes.  Each call reads every live key and value
once (``B * len * kv_h * d * 2`` elements), at about ``2 * n_rep`` flops per
byte, far below the H100's ~295 flops per byte.  The kernel's answer:
split-K over the sequence (one block per chunk of :data:`SPLIT_CHUNK` keys,
sequence and kv head, holding all the query heads of its GQA group, so
each K/V byte is read once per kv head and every SM has work); K/V staged
through shared memory by ``cp.async`` and scored on the tensor cores in
bf16 and fp16; an fp32 online softmax; the splits merged in split order in
the same launch; no work before the window's first key or past the
sequence's length.  The JAX function routed a window and ``Smax % block_k``
to its reference; this kernel takes both natively.

On a CPU tensor the wrapper runs :func:`decode_attention_plain`; on a CUDA
tensor it launches the kernel and raises on any failure.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

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


#: keys one split-K block walks: a multiple of 64 (so whole pages of 16),
#: fixed, so the partition depends on a sequence's length and window alone.
#: 256 beat 128 on an H100 at the 2048-key shape and at a serve decode
#: step, and lost at v1 ``generate``'s 257-288 keys (``PERF.md`` §6)
SPLIT_CHUNK = 256


class SplitLayout(NamedTuple):
    """How a decode call splits: ``splits`` chunks of ``chunk`` keys cover
    the cache of ``seq_cap`` keys; the workspace holds ``partial_floats``
    fp32 values (each query head's ``(acc[d], m, l)`` per split, padded to
    16 bytes) and
    ``counters`` int32 arrival counters (one per sequence and query head)."""
    chunk: int
    splits: int
    partial_floats: int
    counters: int


def split_layout(batch: int, heads: int, head_dim: int,
                 seq_cap: int) -> SplitLayout:
    """The split of a call over ``[batch, heads, head_dim]`` queries and a
    cache of ``seq_cap`` keys.  The split count depends on ``seq_cap`` and
    :data:`SPLIT_CHUNK` only; ``batch`` and ``heads`` size the
    workspace."""
    splits = max(1, -(-int(seq_cap) // SPLIT_CHUNK))
    return SplitLayout(SPLIT_CHUNK, splits,
                       batch * heads * splits * (head_dim + 4),
                       batch * heads)


_WORKSPACES: Dict[Tuple[torch.device, int], Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}


def workspace(device: torch.device, stream: int,
              layout: SplitLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(partials fp32, counters int32)`` for calls on ``stream``, cached
    per (device, stream) and grown as needed.  The counters are zeroed once
    when allocated; the kernel leaves them at 0."""
    key = (device, stream)
    parts, counters = _WORKSPACES.get(key, (None, None))
    if parts is None or parts.numel() < layout.partial_floats:
        parts = torch.empty(layout.partial_floats, dtype=torch.float32,
                            device=device)
    if counters is None or counters.numel() < layout.counters:
        counters = torch.zeros(layout.counters, dtype=torch.int32,
                               device=device)
    _WORKSPACES[key] = (parts, counters)
    return parts, counters


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
    smax = k_cache.shape[1]
    split = split_layout(B, h, d, smax)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    parts, counters = workspace(q.device, stream, split)
    out = torch.empty_like(q)
    status = lib.ds_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), parts.data_ptr(),
        counters.data_ptr(), B, h, k_cache.shape[2], d, smax,
        int(window) if window is not None else 0, split.chunk, split.splits,
        DTYPE_CODES[q.dtype], stream)
    op_builder.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
decode_attention.launches = 0
