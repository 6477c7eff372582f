"""Flash attention for training: forward (out + lse) and backward (dq pass,
dk/dv pass), each a hand-written CUDA kernel for Hopper beside its plain
PyTorch version.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/
flash_attention.py``: the resident forward ``_flash_call`` and the streamed
forward ``_flash_fwd_stream`` (both by the kernels behind :func:`flash_fwd`),
the resident backward ``_flash_bwd_pallas`` and the streamed backward
``_flash_bwd_stream`` (both by the kernels behind :func:`flash_bwd_dq` and
:func:`flash_bwd_dkv`).  Each pass has two kernel families, chosen by the
dtype alone: bf16 and fp16 run on the tensor cores
(``deepspeed_tpu_torch/csrc/flash_attention_mma.cu``, ``mma.sync`` with fp32
accumulators), fp32 on fp32 FMAs (``csrc/flash_attention.cu``, the parity
dtype, which TF32 products would not keep).

Bound on the card: the operations.  A causal forward does ``4 d`` flops per
live (q, k) pair and reads each of q, K, V once; at S 2048 that is hundreds
of flops per byte, far above the H100's ~295 in bf16.  The dq pass does
``6 d`` per live pair and the dk/dv pass ``8 d`` (each recomputes the
scores).  The kernels' answers, and what they leave for later, are in the
CUDA sources.

Semantics (``[B, S, h, d]`` layout, scale ``1/sqrt(d)``, causal/window as
``ops/masks.py``, ``segment_ids [B, S]`` masking cross-segment pairs):

* the forward's lse ``[B, h, S]`` is fp32, in units of scaled scores;
* a row with no live key gives output 0 and lse ``1e30`` (as the TPU
  kernel's ``l > 0`` guard), and masked probabilities are exactly 0;
* the backward's ``delta = sum_d do * o`` is plain PyTorch, as JAX computed
  it outside its kernels.

The fp32 kernels keep p in fp32 before p·V (the TPU kernel did too); the
16-bit kernels round p to the inputs' dtype as an ``mma`` operand, as the
plain forward casts p to q's dtype first, like the JAX reference, and
multiply dS in two 16-bit parts (hi + lo), which keeps it to about 2^-16
relative, as the JAX kernel's fp32 ``ds``.  The JAX function sent blocks
under 64 and S not a multiple of its block to the dense reference; on the
card these kernels take every S (the tail tile is masked) and every mask.
A head dim other than 64 or 128 raises; nothing falls back to the plain
version on a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import op_builder
from ..masks import local_attention_mask
from .common import ATTENTION_DTYPES, DTYPE_CODES, KERNEL_HEAD_DIMS

Tensor = torch.Tensor


# -- plain versions ---------------------------------------------------------

def _full_mask(S: int, causal: bool, window: Optional[int],
               segment_ids: Optional[Tensor], device) -> Optional[Tensor]:
    """``[B or 1, 1, S, S]`` keep mask (positions and segments), or None."""
    if not causal and window is None and segment_ids is None:
        return None
    pos = torch.arange(S, device=device)
    m = local_attention_mask(pos, pos, causal=causal, window=window)[None,
                                                                     None]
    if segment_ids is not None:
        m = m & (segment_ids[:, None, :, None]
                 == segment_ids[:, None, None, :])
    return m


def flash_attention_fwd_plain(q: Tensor, k: Tensor, v: Tensor,
                              causal: bool = True,
                              window: Optional[int] = None,
                              segment_ids: Optional[Tensor] = None
                              ) -> Tuple[Tensor, Tensor]:
    """Transcription of ``_reference_fwd_with_lse``: fp32 scores times the
    scale, -1e30 on masked keys, ``p = exp(s - lse)`` cast to q's dtype
    before p·V.  Rows with no live key follow the kernel (out 0, lse
    1e30)."""
    S = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _full_mask(S, causal, window, segment_ids, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1)                        # [B, h, S]
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if mask is not None:
        dead = ~mask.any(dim=-1)                             # [B|1, 1, S]
        lse = torch.where(dead, torch.full_like(lse, 1e30), lse)
        out = torch.where(dead.permute(0, 2, 1)[..., None],
                          torch.zeros_like(out), out)
    return out.contiguous(), lse


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                              lse: Tensor, do: Tensor, causal: bool = True,
                              window: Optional[int] = None,
                              segment_ids: Optional[Tensor] = None,
                              block_k: int = 512
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Transcription of the JAX chunked-scan backward
    (``_flash_inner_bwd`` off the TPU): fp32 throughout, the keys walked in
    chunks of ``block_k``, ``p = exp(s - lse)`` from the saved lse, ``ds = p
    (dp - delta)``; dq and dk carry the scale once."""
    B, S, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32, do32 = q.float(), do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", do32, out.float())
    q_pos = torch.arange(S, device=q.device)
    dq = torch.zeros(B, S, h, d, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, S, block_k):
        k1 = min(k0 + block_k, S)
        kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        if causal or window is not None or segment_ids is not None:
            m = local_attention_mask(q_pos, q_pos[k0:k1], causal,
                                     window)[None, None]
            if segment_ids is not None:
                m = m & (segment_ids[:, None, :, None]
                         == segment_ids[:, None, None, k0:k1])
            s = torch.where(m, s, torch.full_like(s, -1e30))
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do32))
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, vb)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale)
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


# -- the kernels' wrappers --------------------------------------------------

def check_attention_args(q: Tensor, k: Tensor, v: Tensor,
                         segment_ids: Optional[Tensor], window: Optional[int],
                         *more: Tensor) -> None:
    """Raise on anything the two paths do not take: q, K, V ``[B, S, h,
    d]`` of one shape and one dtype (fp32, bf16 or fp16; GQA is repeated to
    the query heads before the call), int32 ``segment_ids [B, S]``, a window
    of at least one key, all on one device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, S, h, d] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in ATTENTION_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype of fp32, bf16 or fp16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if segment_ids is not None and (segment_ids.shape != q.shape[:2]
                                    or segment_ids.dtype != torch.int32):
        raise ValueError(f"segment_ids must be int32 {tuple(q.shape[:2])}, "
                         f"got {segment_ids.dtype} "
                         f"{tuple(segment_ids.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    tensors = [q, k, v, *more] + ([segment_ids] if segment_ids is not None
                                  else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all arguments must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.device.type == "cuda":
        if q.shape[-1] not in KERNEL_HEAD_DIMS:
            raise ValueError(f"head dim {q.shape[-1]} has no CUDA kernel "
                             f"(supported: {KERNEL_HEAD_DIMS})")
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"tensor of shape {tuple(t.shape)} must be "
                                 "contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"tensor of shape {tuple(t.shape)} is not "
                                 "16-byte aligned")


def _kernel_window(window: Optional[int], S: int) -> int:
    """The C entry points' window: 0 for none; a window of S or more masks
    nothing, so it is passed as none (no int overflow in the bounds)."""
    return 0 if window is None or int(window) >= S else int(window)


def _seg_ptr(segment_ids: Optional[Tensor]) -> Optional[int]:
    return None if segment_ids is None else segment_ids.data_ptr()


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
              window: Optional[int] = None,
              segment_ids: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    """``(out [B, S, h, d], lse [B, h, S] fp32)``: the forward kernel on a
    CUDA tensor, :func:`flash_attention_fwd_plain` on a CPU tensor."""
    check_attention_args(q, k, v, segment_ids, window)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, window,
                                         segment_ids)
    B, S, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, h, S, dtype=torch.float32, device=q.device)
    status = op_builder.load_library().ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids),
        out.data_ptr(), lse.data_ptr(), B, S, h, d, int(causal),
        _kernel_window(window, S), DTYPE_CODES[q.dtype], _stream(q))
    op_builder.check(status, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def attention_delta(out: Tensor, do: Tensor) -> Tensor:
    """``delta [B, h, S] = sum_d do * o`` in fp32 (outside the kernels, as
    in JAX)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(),
                        out.float()).contiguous()


def check_bwd_args(q, k, v, out, lse, do, delta, segment_ids, window):
    """Check the backward's arguments; returns delta (computed from out and
    do when not given; the kernels read delta, never out)."""
    if out.shape != q.shape or do.shape != q.shape or out.device != q.device:
        raise ValueError("out and do must have q's shape and device")
    if q.device.type == "cuda" and delta is None:
        delta = attention_delta(out, do)
    stats = (lse,) if delta is None else (lse, delta)
    check_attention_args(q, k, v, segment_ids, window, do, *stats)
    for name, t in zip(("lse", "delta"), stats):
        if t.shape != (q.shape[0], q.shape[2], q.shape[1]) or \
                t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [B, h, S], got {t.dtype} "
                             f"{tuple(t.shape)}")
    return delta


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                 do: Tensor, causal: bool = True,
                 window: Optional[int] = None,
                 segment_ids: Optional[Tensor] = None,
                 delta: Optional[Tensor] = None) -> Tensor:
    """``dq``: the dq-pass kernel on a CUDA tensor (``delta`` computed if
    not given), the plain backward's dq on a CPU tensor."""
    delta = check_bwd_args(q, k, v, out, lse, do, delta, segment_ids, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         window, segment_ids)[0]
    B, S, h, d = q.shape
    dq = torch.empty_like(q)
    status = op_builder.load_library().ds_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _seg_ptr(segment_ids),
        dq.data_ptr(), B, S, h, d, int(causal), _kernel_window(window, S),
        DTYPE_CODES[q.dtype], _stream(q))
    op_builder.check(status, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                  do: Tensor, causal: bool = True,
                  window: Optional[int] = None,
                  segment_ids: Optional[Tensor] = None,
                  delta: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """``(dk, dv)``: the dk/dv-pass kernel on a CUDA tensor, the plain
    backward's dk, dv on a CPU tensor."""
    delta = check_bwd_args(q, k, v, out, lse, do, delta, segment_ids, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         window, segment_ids)[1:]
    B, S, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = op_builder.load_library().ds_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _seg_ptr(segment_ids),
        dk.data_ptr(), dv.data_ptr(), B, S, h, d, int(causal),
        _kernel_window(window, S), DTYPE_CODES[q.dtype], _stream(q))
    op_builder.check(status, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


#: kernel launches since the last reset (CPU calls never count)
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        lse: Tensor, do: Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        segment_ids: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dq, dk, dv)``: delta once, then the dq and dk/dv kernels on a
    CUDA tensor; the plain backward once on a CPU tensor."""
    if q.device.type == "cpu":
        check_bwd_args(q, k, v, out, lse, do, None, segment_ids, window)
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         window, segment_ids)
    delta = attention_delta(out, do)
    dq = flash_bwd_dq(q, k, v, out, lse, do, causal, window, segment_ids,
                      delta)
    dk, dv = flash_bwd_dkv(q, k, v, out, lse, do, causal, window,
                           segment_ids, delta)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; the backward reads the saved out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window):
        out, lse = flash_fwd(q, k, v, causal, window, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal, ctx.window, segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    block_q: int = 0, block_k: int = 0,
                    window: Optional[int] = None,
                    segment_ids: Optional[Tensor] = None) -> Tensor:
    """``[B, S, h, d]`` attention with a gradient, the JAX
    ``flash_attention``'s signature.  ``block_q`` / ``block_k`` are accepted
    for that signature and do not change the result: the Hopper kernels
    fix their tile at 64 x 64 (``lattice.TILE``)."""
    del block_q, block_k
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal),
                                 None if window is None else int(window))
