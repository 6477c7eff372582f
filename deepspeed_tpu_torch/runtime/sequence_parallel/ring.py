"""Ring attention: sequence parallelism past the head-count limit.

Counterpart of ``deepspeed_tpu/runtime/sequence_parallel/ring.py``
(arXiv 2310.01889 / blockwise 2305.19370).  Ulysses needs at least one
head a ``seq`` rank; the ring keeps the sequence cut through the whole
attention, so its degree is bounded by the sequence alone.  Each rank
holds one contiguous block of Q/K/V; the K/V blocks travel around the ring
(``comm.ppermute``: rank ``i`` sends to ``i + 1``) while each rank folds
the visiting block into its queries' online-softmax state (m, l, acc), the
flash accumulator across ranks.  The JAX package runs the same fold as a
``lax.scan`` inside a ``shard_map`` and differentiates through it; here
autograd runs through the loop, and each ``ppermute``'s backward sends the
gradient back along the inverse permutation.  Plain PyTorch, as JAX's is
plain jnp: a correct ring, not a fast one (no overlap of the exchange with
the products; the last visit does not rotate).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ...comm import comm
from ...ops.masks import local_attention_mask
from .ulysses_sp import seq_group_of

Tensor = torch.Tensor


def _ring_attention_local(q: Tensor, k: Tensor, v: Tensor, *, group: Any,
                          sp: int, causal: bool,
                          window: Optional[int] = None) -> Tensor:
    """This rank's ``q [B, Sl, h, d]`` against every rank's ``k, v [B, Sl,
    kv_h, d]`` (``kv_h | h``): GQA groups rotate at their stored width and
    are expanded at each visit.  Masks use global positions: this rank's
    queries sit at ``my·Sl + i``, visit ``r``'s keys at ``src·Sl + j``."""
    B, Sl, h, d = q.shape
    n_rep = h // k.shape[2]
    my = comm.get_rank(group)
    qf = q.float() * (1.0 / math.sqrt(d))
    ring = [(i, (i + 1) % sp) for i in range(sp)]
    iq = my * Sl + torch.arange(Sl, device=q.device)
    m = torch.full((B, h, Sl), -math.inf, device=q.device)
    l = torch.zeros((B, h, Sl), device=q.device)
    acc = torch.zeros((B, h, Sl, d), device=q.device)
    kb, vb = k, v
    for r in range(sp):
        src = (my - r) % sp  # whose block is visiting this round
        kbf, vbf = kb.float(), vb.float()
        if n_rep > 1:
            kbf = kbf.repeat_interleave(n_rep, dim=2)
            vbf = vbf.repeat_interleave(n_rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kbf)
        if causal or window is not None:
            ik = src * Sl + torch.arange(Sl, device=q.device)
            mask = local_attention_mask(iq, ik, causal=causal, window=window)
            s = torch.where(mask, s, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row with no live key yet keeps m = -inf: shift it by 0 instead
        shift = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        p = torch.exp(s - shift[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                            torch.ones_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    vbf)
        m = m_new
        if r < sp - 1:  # rotate K/V to the next rank
            kb = comm.ppermute(kb, ring, group)
            vb = comm.ppermute(vb, ring, group)
    out = acc / l.clamp(min=1e-20)[..., None]               # [B, h, Sl, d]
    return out.transpose(1, 2).to(q.dtype)


def _plain_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                     window: Optional[int] = None) -> Tensor:
    """Dense attention with GQA expanded (JAX ``_reference_attention``):
    fp32 scores, -1e30 on masked keys, the softmax cast to q's dtype before
    p·V."""
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(
        q.shape[-1])
    if causal or window is not None:
        pos = torch.arange(q.shape[1], device=q.device)
        keep = local_attention_mask(pos, pos, causal=causal, window=window)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def ring_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                   mesh: Any = None, window: Optional[int] = None,
                   group: Any = None) -> Tensor:
    """Sequence-parallel attention over the ``seq`` group (``group``, else
    ``mesh``'s, default the active mesh's).

    ``q [B, S/sp, h, d]``, ``k, v [B, S/sp, kv_h, d]``: this rank's block
    of a sequence cut into ``sp`` equal blocks in rank order (the cut, and
    its ``S % sp`` check, are the caller's: ``LlamaModel.loss``,
    :class:`~.ulysses_sp.UlyssesSPDataLoaderAdapter`); returns this rank's
    block of the output.  No head-count bound.  Positions are global, so
    RoPE must be applied before the call.  At sp 1 it is plain attention."""
    group, sp = seq_group_of(mesh, group)
    if sp == 1:
        return _plain_attention(q, k, v, causal, window)
    return _ring_attention_local(q, k, v, group=group, sp=sp, causal=causal,
                                 window=window)
