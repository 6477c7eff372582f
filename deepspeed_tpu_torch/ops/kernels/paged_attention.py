"""Paged decode attention for the v2 serving engine.

Replaces the Pallas TPU kernel ``paged_decode_attention``
(``_paged_kernel``) of ``deepspeed_tpu/ops/pallas/paged_attention.py``; the
CUDA kernel is ``deepspeed_tpu_torch/csrc/decode_attention.cu`` (entry point
``ds_paged_decode_attention``), hand-written for Hopper.
:func:`paged_decode_attention_tp` replaces the head-sharded
``paged_decode_attention_tp`` of the same file: the JAX version is a
``shard_map`` over the ``tensor`` mesh axis whose body runs the paged
kernel on each rank's heads; here each rank is a process, so the body alone
remains, launching the same CUDA kernel on the rank's ``h/tp`` query heads
and its ``kv_h/tp`` slice of the pool.

Bound on the card: the K/V bytes of the live pages, read once per call.
The kernel is the padded-cache kernel's (split-K over chunks of
``SPLIT_CHUNK`` keys at absolute positions, one block per chunk, sequence
and kv head holding the whole GQA group, the splits merged in split order
in the same launch); each chunk reads its page ids from ``block_tables``
once a page, and with a window the walk starts at the window's first key,
so pages before it are never read.  The partition does not depend on the
heads, so a rank's shard of :func:`paged_decode_attention_tp` is bit-equal
to those heads of the unsharded call.

On a CPU tensor the wrapper runs :func:`paged_decode_attention_plain`; on a
CUDA tensor it launches the kernel and raises on any failure.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from .. import op_builder
from .common import DTYPE_CODES, check_decode_args, check_kernel_args
from .decode_attention import split_layout, workspace


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Transcription of the JAX reference ``paged_decode_reference``:
    gather each sequence's pages into a padded ``[B, max_blocks*bs, kv_h,
    d]`` cache, repeat over GQA, fp32 scores times the scale, -1e30 masking,
    and p cast to q's dtype before p·V."""
    B = q.shape[0]
    _, bs, kv_h, d = k_pool.shape
    max_blocks = block_tables.shape[1]
    idx = block_tables.to(torch.int64)
    k = k_pool[idx].reshape(B, max_blocks * bs, kv_h, d)
    v = v_pool[idx].reshape(B, max_blocks * bs, kv_h, d)
    n_rep = q.shape[1] // kv_h
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhd,bkhd->bhk", q, k).float() * scale
    pos = torch.arange(max_blocks * bs, device=q.device)[None, None, :]
    lens = lengths.to(torch.int64)[:, None, None]
    mask = pos < lens
    if window is not None:
        mask = mask & (pos >= lens - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhk,bkhd->bhd", p, v)


def _launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
            block_tables: torch.Tensor, lengths: torch.Tensor,
            window: Optional[int], what: str) -> torch.Tensor:
    """The CUDA paged kernel on ``q``'s heads; raises on any failure."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    check_kernel_args(q, k_pool, v_pool, block_tables, lengths)
    lib = op_builder.load_library()
    B, h, d = q.shape
    num_pages, bs, kv_h, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    split = split_layout(B, h, d, max_blocks * bs)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    parts, counters = workspace(q.device, stream, split)
    out = torch.empty_like(q)
    status = lib.ds_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        parts.data_ptr(), counters.data_ptr(), B, h, kv_h, d, num_pages, bs,
        max_blocks, int(window) if window is not None else 0, split.chunk,
        split.splits, DTYPE_CODES[q.dtype], stream)
    op_builder.check(status, what)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token queries ``q [B, h, d]`` over a shared page pool
    ``[N, block_size, kv_h, d]`` addressed by int32 ``block_tables [B,
    max_blocks]``, with int32 ``lengths [B]`` counting the key just written
    and an optional sliding ``window``."""
    check_decode_args(q, k_pool, v_pool, lengths, window, tables=block_tables)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, window)
    out = _launch(q, k_pool, v_pool, block_tables, lengths, window,
                  "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count)
paged_decode_attention.launches = 0


def paged_decode_attention_tp(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor, mesh: Any,
                              window: Optional[int] = None) -> torch.Tensor:
    """Tensor-parallel paged decode on this rank's shard: ``q [B, h/tp,
    d]`` and the local pool ``[N, bs, kv_h/tp, d]`` (contiguous head
    blocks, so every GQA group lies on one rank), with the block tables and
    lengths that every rank holds alike.  Heads are independent, so no rank
    talks to another; the result is this rank's heads of the unsharded
    call.  ``mesh`` is the process mesh (``utils.groups``) whose ``tensor``
    axis splits the heads."""
    # the local heads form whole GQA groups (kv_h/tp | h/tp) when tp
    # divides kv_h, which the model checks against this mesh
    check_decode_args(q, k_pool, v_pool, lengths, window, tables=block_tables)
    if mesh is None or int(mesh.shape.get("tensor", 0)) < 1:
        raise ValueError("paged_decode_attention_tp: needs a mesh with a "
                         "tensor axis")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, window)
    out = _launch(q, k_pool, v_pool, block_tables, lengths, window,
                  "paged_decode_attention_tp")
    paged_decode_attention_tp.launches += 1
    return out


#: kernel launches since the last reset (CPU calls never count), apart
#: from the unsharded wrapper's
paged_decode_attention_tp.launches = 0
