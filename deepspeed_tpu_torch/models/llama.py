"""Llama-family decoder in PyTorch: inference and training.

Counterpart of ``deepspeed_tpu/models/llama.py``: the config and its
presets, the seeded init, RMSNorm, RoPE, the SwiGLU FFN, the LM head, the
KV-cache path (``init_cache`` / ``prefill`` / ``decode_step``) that
``init_inference(...).generate`` runs, a no-grad ``forward``, and the
training loss (``loss``, ``batch_labels``, :func:`masked_cross_entropy`)
with per-layer remat.  The FFN is a hook (``_ffn``) that returns its
output and an aux loss: the dense SwiGLU here, the routed experts in
``models/mixtral.py``; ``loss`` adds ``aux_loss_coef`` times the layers'
summed aux losses, as the JAX model does.

Weights live in per-layer modules (``nn.Linear`` weights are ``[out, in]``)
stored in ``config.param_dtype`` (default: ``config.dtype``) and are cast to
``config.dtype`` at every use, as the JAX model casts its fp32 masters.
Serving stores bf16 weights (the cast is then a no-op); training builds the
model with ``param_dtype=torch.float32`` so the engine updates fp32 masters
while the model computes in ``config.dtype``.  ``models/convert.py`` carries
a JAX parameter tree across.  The attention kernels are hand-written CUDA:
decode attention (``ops/kernels/decode_attention.py``) on the KV-cache path
and flash attention (``ops/kernels/flash_attention.py``) in the training
loss under ``attn_impl="flash"``; everything else is plain PyTorch, as the
JAX package left it to XLA.  Sharding, pipeline and sequence parallelism
and ``loss_tiles`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import flash_attention
from ..ops.masks import local_attention_mask
from ..utils.device import DeviceLike, resolve_device

#: a layer's router aux loss: a 0-dim fp32 tensor, or 0.0 without a router
AuxLoss = Union[torch.Tensor, float]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    #: Mistral-style sliding window: each token attends at most this many
    #: positions back (None = full causal)
    sliding_window: Optional[int] = None
    #: compute dtype: every weight is cast to it at use
    dtype: torch.dtype = torch.bfloat16
    #: storage dtype of the weights (None: ``dtype``); training keeps fp32
    #: masters
    param_dtype: Optional[torch.dtype] = None
    #: recompute each layer in the backward, saving only the weight
    #: matmuls' outputs (JAX: ``jax.checkpoint`` with
    #: ``dots_with_no_batch_dims_saveable``)
    remat: bool = True
    #: training attention: "flash" runs the CUDA flash kernels, "xla" the
    #: plain einsum + softmax (the JAX config's flash block sizes have no
    #: counterpart: the Hopper kernels fix their own 64 x 64 tile)
    attn_impl: str = "xla"
    #: weight of the routers' load-balancing loss in ``loss`` (the JAX
    #: model's ``aux_loss_coef``; a dense model has no router)
    aux_loss_coef: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.hidden_size // self.num_heads)

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.param_dtype if self.param_dtype is not None else self.dtype

    # presets (sizes follow the public Llama/Llama-3/Mistral configs)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        d = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
                 num_layers=4, num_heads=8, num_kv_heads=4, max_seq_len=256)
        d.update(kw)
        return cls(**d)

    @classmethod
    def mistral_7b(cls, **kw) -> "LlamaConfig":
        d = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8,
                 max_seq_len=8192, rope_theta=10000.0, sliding_window=4096)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        d = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8,
                 max_seq_len=8192, rope_theta=500000.0)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama3_70b(cls, **kw) -> "LlamaConfig":
        d = dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
                 num_layers=80, num_heads=64, num_kv_heads=8,
                 max_seq_len=8192, rope_theta=500000.0)
        d.update(kw)
        return cls(**d)

    def num_params(self) -> int:
        H, I, V, L = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        hd, nh, nkv = self.hd, self.num_heads, self.num_kv_heads
        per_layer = (H * nh * hd + 2 * H * nkv * hd + nh * hd * H
                     + 3 * H * I + 2 * H)
        head = H if self.tie_embeddings else H + H * V
        return V * H + L * per_layer + head


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in fp32, cast back to x's dtype, then scale by ``w`` (cast
    to x's dtype at use)."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def masked_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in fp32 with -100 ignore positions (HF
    convention)."""
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    return (torch.where(valid, nll, torch.zeros_like(nll)).sum()
            / valid.sum().clamp(min=1))


#: forward ops whose outputs remat keeps: the weight matmuls (F.linear lowers
#: to mm/addmm); the attention's batched products are recomputed
_SAVED_UNDER_REMAT = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_UNDER_REMAT
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding on ``[..., S, h, D]`` with positions ``[..., S]``:
    the two halves rotate together (not interleaved), angles in fp32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Reference attention on ``[B, S, h, D]``: fp32 scores and softmax,
    -1e30 on masked keys, probabilities cast to q's dtype before p·V."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: kv head ``g`` serves query heads ``g*n_rep .. g*n_rep+n_rep-1``
    (``jnp.repeat`` on the head axis)."""
    return x.repeat_interleave(n_rep, dim=-2) if n_rep > 1 else x


#: ``normal_(weight, fan_in)``: draw ``N(0, 1/fan_in)`` into ``weight``
Init = Callable[[torch.Tensor, int], None]


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, device: DeviceLike):
        super().__init__()
        H, hd = c.hidden_size, c.hd
        self.compute_dtype = c.dtype
        kw = dict(bias=False, device=device, dtype=c.storage_dtype)
        self.attn_norm = nn.Parameter(torch.empty(H, device=device,
                                                  dtype=c.storage_dtype))
        self.q_proj = nn.Linear(H, c.num_heads * hd, **kw)
        self.k_proj = nn.Linear(H, c.num_kv_heads * hd, **kw)
        self.v_proj = nn.Linear(H, c.num_kv_heads * hd, **kw)
        self.o_proj = nn.Linear(c.num_heads * hd, H, **kw)
        self.mlp_norm = nn.Parameter(torch.empty(H, device=device,
                                                 dtype=c.storage_dtype))
        self._build_ffn(c, device)

    def _build_ffn(self, c: LlamaConfig, device: DeviceLike) -> None:
        """The dense SwiGLU's three projections."""
        H, I = c.hidden_size, c.intermediate_size
        kw = dict(bias=False, device=device, dtype=c.storage_dtype)
        self.gate_proj = nn.Linear(H, I, **kw)
        self.up_proj = nn.Linear(H, I, **kw)
        self.down_proj = nn.Linear(I, H, **kw)

    def reset_parameters(self, normal_: Init) -> None:
        """Every matrix from ``normal_`` (attention first, then the FFN, one
        tensor at a time), the norms at one."""
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.o_proj):
            normal_(lin.weight, lin.in_features)
        self._reset_ffn(normal_)
        self.attn_norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)

    def _reset_ffn(self, normal_: Init) -> None:
        for lin in (self.gate_proj, self.up_proj, self.down_proj):
            normal_(lin.weight, lin.in_features)

    def proj(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``x @ W.T`` with the weight cast to the compute dtype at use."""
        return F.linear(x, lin.weight.to(self.compute_dtype))

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        """Dense SwiGLU."""
        return self.proj(self.down_proj,
                         F.silu(self.proj(self.gate_proj, h))
                         * self.proj(self.up_proj, h))


class LlamaModel(nn.Module):
    """Llama decoder with a KV cache.  ``device`` defaults to ``"cuda"``
    and raises without a CUDA device; weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` (see :meth:`init_params`)."""

    layer_cls = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        # built on the meta device and materialised once: the init below
        # writes every weight, so a default init would be wasted work
        self.embed = nn.Embedding(c.vocab_size, c.hidden_size,
                                  device="meta", dtype=c.storage_dtype)
        self.layers = nn.ModuleList(self.layer_cls(c, "meta")
                                    for _ in range(c.num_layers))
        self.final_norm = nn.Parameter(torch.empty(c.hidden_size,
                                                   device="meta",
                                                   dtype=c.storage_dtype))
        self.lm_head = (None if c.tie_embeddings else
                        nn.Linear(c.hidden_size, c.vocab_size, bias=False,
                                  device="meta", dtype=c.storage_dtype))
        self.to_empty(device=dev)
        self.init_params(seed)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> None:
        """Norms at one; every matrix ``N(0, 1/fan_in)``, drawn in fp32 from a
        seeded generator on the model's device and stored in
        ``config.storage_dtype`` (the JAX model's init distribution; its
        numbers differ, since the two generators differ)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def normal_(w: torch.Tensor, fan_in: int) -> None:
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device,
                                dtype=torch.float32).div_(math.sqrt(fan_in)))

        c = self.config
        normal_(self.embed.weight, c.hidden_size)
        for layer in self.layers:
            layer.reset_parameters(normal_)
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            normal_(self.lm_head.weight, c.hidden_size)

    # -- pieces shared with the v2 adapter -------------------------------

    def head_weight(self) -> torch.Tensor:
        """``[V, H]`` output projection (the embedding when tied)."""
        return (self.embed.weight if self.config.tie_embeddings
                else self.lm_head.weight)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """``ids [...]`` → ``[..., H]`` in the compute dtype."""
        return F.embedding(ids.long(),
                           self.embed.weight.to(self.config.dtype))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """LM head in the model dtype, returned as fp32."""
        return F.linear(x, self.head_weight().to(self.config.dtype)).float()

    def qkv(self, layer: LlamaDecoderLayer, x: torch.Tensor,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x [..., S, H]`` → RoPE'd q ``[..., S, h, d]`` and k, v
        ``[..., S, kv_h, d]``; ``positions [..., S]`` (broadcastable)."""
        c = self.config
        h = _rms_norm(x, layer.attn_norm, c.rms_norm_eps)
        shape = x.shape[:-1]
        q = layer.proj(layer.q_proj, h).view(*shape, c.num_heads, c.hd)
        k = layer.proj(layer.k_proj, h).view(*shape, c.num_kv_heads, c.hd)
        v = layer.proj(layer.v_proj, h).view(*shape, c.num_kv_heads, c.hd)
        return (_rope(q, positions, c.rope_theta),
                _rope(k, positions, c.rope_theta), v)

    def _ffn(self, layer: LlamaDecoderLayer, h: torch.Tensor
             ) -> Tuple[torch.Tensor, AuxLoss]:
        """The FFN over ``h [..., H]``: ``(out, aux loss)``.  Dense SwiGLU
        here, with no aux loss; Mixtral routes it through its experts."""
        return layer.ffn(h), 0.0

    def _post_attn(self, layer: LlamaDecoderLayer, x: torch.Tensor,
                   attn: torch.Tensor) -> Tuple[torch.Tensor, AuxLoss]:
        """Output projection + residual + FFN block + residual, and the
        FFN's aux loss; ``attn [..., h, d]``."""
        x = x + layer.proj(layer.o_proj, attn.flatten(-2))
        h = _rms_norm(x, layer.mlp_norm, self.config.rms_norm_eps)
        out, l_aux = self._ffn(layer, h)
        return x + out, l_aux

    def post_attn(self, layer: LlamaDecoderLayer, x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
        """:meth:`_post_attn` for the serving paths, which drop the aux
        loss."""
        return self._post_attn(layer, x, attn)[0]

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, self.final_norm, self.config.rms_norm_eps)

    # -- full forward (no cache) -----------------------------------------

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` token ids → ``[B, S, V]`` fp32 logits."""
        c = self.config
        S = input_ids.shape[1]
        pos = torch.arange(S, device=self.device)
        mask = local_attention_mask(pos, pos, causal=True,
                                    window=c.sliding_window)
        n_rep = c.num_heads // c.num_kv_heads
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            q, k, v = self.qkv(layer, x, pos[None])
            attn = _attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                              mask)
            x = self.post_attn(layer, x, attn)
        return self.logits(self.finalize(x))

    # -- KV-cache inference path (used by inference/engine.py) -----------

    def init_cache(self, batch_size: int, max_len: int
                   ) -> Dict[str, torch.Tensor]:
        """Decode cache ``[L, B, max_len, kv_h, d]`` in the GQA layout: only
        the kv heads are stored; the decode kernel expands the groups."""
        c = self.config
        shape = (c.num_layers, batch_size, max_len, c.num_kv_heads, c.hd)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=c.dtype, device=self.device),
                "lengths": torch.zeros(batch_size, dtype=torch.int32,
                                       device=self.device)}

    @torch.no_grad()
    def prefill(self, input_ids: torch.Tensor, cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process the prompt ``[B, S]``; returns (last-token logits
        ``[B, V]`` fp32, the cache).  The cache's K/V are written in place."""
        c = self.config
        B, S = input_ids.shape
        n_rep = c.num_heads // c.num_kv_heads
        pos = torch.arange(S, device=self.device)
        mask = local_attention_mask(pos, pos, causal=True,
                                    window=c.sliding_window)
        x = self.embed_tokens(input_ids)
        for li, layer in enumerate(self.layers):
            q, k, v = self.qkv(layer, x, pos[None])
            cache["k"][li, :, :S] = k
            cache["v"][li, :, :S] = v
            attn = _attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                              mask)
            x = self.post_attn(layer, x, attn)
        x = self.finalize(x)
        cache["lengths"] = torch.full((B,), S, dtype=torch.int32,
                                      device=self.device)
        return self.logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One generation step: ``tokens [B]`` → (logits ``[B, V]`` fp32,
        the cache).  Each sequence's new K/V are written in place at its
        length; attention is the decode kernel over ``lengths + 1`` keys."""
        c = self.config
        B = tokens.shape[0]
        lengths = cache["lengths"]
        rows = torch.arange(B, device=self.device)
        wpos = lengths.long()
        x = self.embed_tokens(tokens)  # [B, H]
        for li, layer in enumerate(self.layers):
            q, k, v = self.qkv(layer, x[:, None], lengths[:, None])
            k_cache, v_cache = cache["k"][li], cache["v"][li]
            k_cache[rows, wpos] = k[:, 0]
            v_cache[rows, wpos] = v[:, 0]
            attn = decode_attention(q[:, 0], k_cache, v_cache, lengths + 1,
                                    window=c.sliding_window)
            x = self.post_attn(layer, x, attn)
        x = self.finalize(x)
        cache["lengths"] = lengths + 1
        return self.logits(x), cache

    # -- training (loss with a gradient) -----------------------------------

    def _train_layer(self, layer: LlamaDecoderLayer, x: torch.Tensor,
                     pos: torch.Tensor) -> Tuple[torch.Tensor, AuxLoss]:
        """One decoder layer over ``x [B, S, H]`` → ``(x, aux loss)``: GQA
        K/V repeated to the query heads before attention, as the JAX model
        does (the gradient of the repeat sums back into the kv heads)."""
        c = self.config
        q, k, v = self.qkv(layer, x, pos[None])
        n_rep = c.num_heads // c.num_kv_heads
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        if c.attn_impl == "flash":
            attn = flash_attention(q, k, v, True, window=c.sliding_window)
        elif c.attn_impl == "xla":
            attn = _attention(q, k, v, local_attention_mask(
                pos, pos, causal=True, window=c.sliding_window))
        else:
            raise ValueError(f"attn_impl {c.attn_impl!r} is not ported "
                             "(use 'flash' or 'xla')")
        return self._post_attn(layer, x, attn)

    def hidden_states(self, input_ids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, S]`` ids → (final-norm'd ``[B, S, H]``, the layers' aux
        losses summed, fp32), with a gradient.  Under ``config.remat`` each
        layer is recomputed in the backward, keeping only its weight
        matmuls' outputs."""
        c = self.config
        pos = torch.arange(input_ids.shape[1], device=self.device)
        x = self.embed_tokens(input_ids)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        remat = c.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x, l_aux = checkpoint(
                    self._train_layer, layer, x, pos, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=functools.partial(
                        create_selective_checkpoint_contexts,
                        _save_weight_matmuls))
            else:
                x, l_aux = self._train_layer(layer, x, pos)
            aux = aux + l_aux
        return self.finalize(x), aux

    @staticmethod
    def batch_labels(batch: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(input_ids, labels)`` from ``{"input_ids"[, "labels"]}`` or an
        ids tensor; labels default to the inputs shifted left, -100 at the
        end (HF convention: -100 is ignored)."""
        if isinstance(batch, dict):
            input_ids, labels = batch["input_ids"], batch.get("labels")
        else:
            input_ids, labels = batch, None
        if labels is None:
            labels = torch.cat([input_ids[:, 1:],
                                torch.full_like(input_ids[:, :1], -100)], 1)
        return input_ids, labels

    def loss(self, batch: Any) -> torch.Tensor:
        """Next-token cross entropy plus ``aux_loss_coef`` times the summed
        router aux losses (fp32 scalar), with a gradient."""
        input_ids, labels = self.batch_labels(batch)
        hidden, aux = self.hidden_states(input_ids)
        ce = masked_cross_entropy(self.logits(hidden), labels)
        return ce + self.config.aux_loss_coef * aux
