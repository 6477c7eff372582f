"""BERT-family masked-LM encoder in PyTorch: training (ZeRO-1/2 rung).

Counterpart of ``deepspeed_tpu/models/bert.py``: the config and its presets
(``tiny``, ``bert_large``), the seeded init, the post-LN encoder block
(biased projections, exact GELU), word + position + token-type embeddings,
the MLM head whose decoder is tied to the word embedding plus its own fp32
bias, and the masked-LM loss over :func:`.llama.masked_cross_entropy`
(-100 = not masked).

``attn_impl="flash"`` runs the hand-written CUDA flash kernels
(``ops/kernels/flash_attention.py``) non-causal, with the padding mask as
segment ids: real tokens are segment 1, pads segment 0, so a pad query
attends only pads.  ``"xla"`` is JAX's masked softmax in plain PyTorch,
which masks keys only, so a pad query sees the real keys there.  The two
differ on pad query rows, as they do in JAX; those rows carry -100 labels.

:func:`_layer_norm` keeps JAX's order: statistics in fp32, the normalised
value cast to the compute dtype, then scaled by ``w`` and shifted by ``b``
in that dtype (``F.layer_norm`` in bf16 rounds elsewhere).  Weights live in
``config.param_dtype`` and are read through
``runtime/zero/sharder.compute_weight`` (a cast; a gather under ZeRO-3),
as in ``models/llama.py``; remat keeps the weight matmuls' outputs and
recomputes the rest, the JAX ``dots_with_no_batch_dims_saveable``.

Not ported: random-LTD (JAX ``ltd_keep``, ROADMAP Queue 1 item 10) and the
compression activation quantizer (``act_quant_bits``, item 10); each raises
when set.  The numerics probes are telemetry (item 12) and are left out.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.kernels.flash_attention import flash_attention
from ..runtime.zero.init_ctx import active as zero_init_active
from ..runtime.zero.init_ctx import materialize
from ..runtime.zero.sharder import compute_weight
from ..utils.device import DeviceLike, resolve_device
from .llama import _attention, _save_weight_matmuls, masked_cross_entropy


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024          # BERT-large defaults
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    #: storage dtype of the weights (None: ``dtype``); training keeps fp32
    #: masters
    param_dtype: Optional[torch.dtype] = None
    remat: bool = True
    #: "flash": the CUDA flash kernels, non-causal, padding as segment ids;
    #: "xla": the masked softmax in plain PyTorch
    attn_impl: str = "xla"

    @property
    def hd(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.param_dtype if self.param_dtype is not None else self.dtype

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        d = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                 num_layers=4, num_heads=8, max_seq_len=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def bert_large(cls, **kw) -> "BertConfig":
        return cls(**kw)

    def num_params(self) -> int:
        H, I, V, L = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        per_layer = 4 * H * H + 4 * H + 2 * H * I + I + H + 4 * H
        embeds = (V + self.max_seq_len + self.type_vocab_size) * H + 2 * H
        return embeds + L * per_layer + H * H + 3 * H + V  # MLM head


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """JAX's LayerNorm: fp32 statistics (population variance), the
    normalised value cast to x's dtype, then ``* w + b`` in that dtype
    (``w`` and ``b`` read in x's dtype)."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (((x32 - mu) * torch.rsqrt(var + eps)).to(dt)
            * compute_weight(w, dt) + compute_weight(b, dt))


def linear(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` in ``dt``: the product rounded to ``dt`` before the
    bias is added, as the JAX models' ``einsum(...) + b``."""
    out = F.linear(x, compute_weight(lin.weight, dt))
    return out + compute_weight(lin.bias, dt) if lin.bias is not None else out


def remat(fn: Callable[..., Any], *args: Any) -> Any:
    """``fn(*args)`` recomputed in the backward, keeping only the weight
    matmuls' outputs (the JAX ``dots_with_no_batch_dims_saveable``)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _save_weight_matmuls))


def refuse_unported(model: nn.Module) -> None:
    """Raise when the JAX engine's random-LTD or the compression
    activation quantizer has been armed on ``model``."""
    if getattr(model, "ltd_keep", None) is not None:
        raise NotImplementedError("random-LTD (ltd_keep) is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
    if getattr(model, "act_quant_bits", None):
        raise NotImplementedError("activation quantization "
                                  "(act_quant_bits) is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")


def _linear(i: int, o: int, device: DeviceLike, dtype: torch.dtype
            ) -> nn.Linear:
    return nn.Linear(i, o, bias=True, device=device, dtype=dtype)


def _vector(n: int, device: DeviceLike, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(n, device=device, dtype=dtype))


class BertLayer(nn.Module):
    """One post-LN encoder block; ``nn.Linear`` weights are ``[out, in]``."""

    def __init__(self, c: BertConfig, device: DeviceLike):
        super().__init__()
        H, I, dt = c.hidden_size, c.intermediate_size, c.storage_dtype
        self.q_proj = _linear(H, H, device, dt)
        self.k_proj = _linear(H, H, device, dt)
        self.v_proj = _linear(H, H, device, dt)
        self.o_proj = _linear(H, H, device, dt)
        self.attn_ln_w = _vector(H, device, dt)
        self.attn_ln_b = _vector(H, device, dt)
        self.fc_in = _linear(H, I, device, dt)
        self.fc_out = _linear(I, H, device, dt)
        self.mlp_ln_w = _vector(H, device, dt)
        self.mlp_ln_b = _vector(H, device, dt)


class BertModel(nn.Module):
    """BERT masked-LM encoder.  ``device`` defaults to ``"cuda"`` and raises
    without a CUDA device; weights are drawn from a ``torch.Generator``
    seeded with ``seed``."""

    #: random-LTD's kept tokens and the activation quantizer's bits: the
    #: JAX engine arms them; here either raises (:func:`refuse_unported`)
    ltd_keep: Optional[int] = None
    act_quant_bits: Optional[int] = None

    def __init__(self, config: BertConfig, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        if c.attn_impl not in ("flash", "xla"):
            raise ValueError(f"attn_impl {c.attn_impl!r} is not ported (use "
                             "'flash' or 'xla')")
        H, dt = c.hidden_size, c.storage_dtype
        self.word_embed = nn.Embedding(c.vocab_size, H, device="meta",
                                       dtype=dt)
        self.pos_embed = nn.Embedding(c.max_seq_len, H, device="meta",
                                      dtype=dt)
        self.type_embed = nn.Embedding(c.type_vocab_size, H, device="meta",
                                       dtype=dt)
        self.embed_ln_w = _vector(H, "meta", dt)
        self.embed_ln_b = _vector(H, "meta", dt)
        self.layers = nn.ModuleList(BertLayer(c, "meta")
                                    for _ in range(c.num_layers))
        self.mlm_dense = _linear(H, H, "meta", dt)
        self.mlm_ln_w = _vector(H, "meta", dt)
        self.mlm_ln_b = _vector(H, "meta", dt)
        self.mlm_bias = _vector(c.vocab_size, "meta", dt)
        if zero_init_active() is None:
            self.to_empty(device=dev)
        self.init_params(seed, dev)

    @property
    def device(self) -> torch.device:
        return self.embed_ln_w.device

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    device: Optional[torch.device] = None) -> None:
        """The JAX model's distribution: every matrix ``N(0, 1/fan_in)``
        (fan-in H, ``I`` for the FFN's output), biases 0, norms' scales 1,
        drawn in fp32 from a generator seeded with ``seed`` (its numbers
        differ from JAX's)."""
        dev = device if device is not None else self.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal_(w: torch.Tensor, fan_in: int) -> None:
            full = torch.randn(w.shape, generator=gen, device=dev,
                               dtype=torch.float32).div_(math.sqrt(fan_in))
            materialize(w, dev, lambda t: t.copy_(full))

        def fill_(w: torch.Tensor, value: float) -> None:
            materialize(w, dev, lambda t: t.fill_(value))

        H = self.config.hidden_size
        for emb in (self.word_embed, self.pos_embed, self.type_embed):
            normal_(emb.weight, H)
        linears = [self.mlm_dense]
        for layer in self.layers:
            linears += [layer.q_proj, layer.k_proj, layer.v_proj,
                        layer.o_proj, layer.fc_in, layer.fc_out]
        for lin in linears:
            normal_(lin.weight, lin.in_features)
            fill_(lin.bias, 0.0)
        for name, p in self.named_parameters():
            if name.endswith("_ln_w"):
                fill_(p, 1.0)
            elif name.endswith("_ln_b") or name == "mlm_bias":
                fill_(p, 0.0)

    # -- forward ------------------------------------------------------------

    def encoder_layer(self, layer: BertLayer, x: torch.Tensor,
                      pad_mask: torch.Tensor) -> torch.Tensor:
        """One post-LN block ``[B, S, H] → [B, S, H]``; ``pad_mask [B, S]``
        True at real tokens."""
        c = self.config
        dt = c.dtype
        B, S, _ = x.shape
        q, k, v = (linear(lin, x, dt).view(B, S, c.num_heads, c.hd)
                   for lin in (layer.q_proj, layer.k_proj, layer.v_proj))
        if c.attn_impl == "flash":
            attn = flash_attention(q, k, v, causal=False,
                                   segment_ids=pad_mask.to(torch.int32))
        else:
            attn = _attention(q, k, v, pad_mask[:, None, None, :])
        out = linear(layer.o_proj, attn.reshape(B, S, -1), dt)
        x = _layer_norm(x + out, layer.attn_ln_w, layer.attn_ln_b,
                        c.layer_norm_eps)
        h = F.gelu(linear(layer.fc_in, x, dt))
        h = linear(layer.fc_out, h, dt)
        return _layer_norm(x + h, layer.mlp_ln_w, layer.mlp_ln_b,
                           c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``[B, S]`` ids → ``[B, S, V]`` fp32 MLM logits (with a gradient
        when grad is enabled; under ``config.remat`` each layer is
        recomputed in the backward)."""
        refuse_unported(self)
        c = self.config
        dt = c.dtype
        B, S = input_ids.shape
        if S > c.max_seq_len:
            raise ValueError(f"sequence length {S} exceeds max_seq_len "
                             f"{c.max_seq_len} (learned position table)")
        if attention_mask is None:
            pad_mask = torch.ones(B, S, dtype=torch.bool, device=self.device)
        else:
            pad_mask = attention_mask.to(torch.bool)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (F.embedding(input_ids.long(),
                         compute_weight(self.word_embed.weight, dt))
             + compute_weight(self.pos_embed.weight, dt)[None, :S]
             + F.embedding(token_type_ids.long(),
                           compute_weight(self.type_embed.weight, dt)))
        x = _layer_norm(x, self.embed_ln_w, self.embed_ln_b,
                        c.layer_norm_eps)
        use_remat = c.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if use_remat:
                x = remat(self.encoder_layer, layer, x, pad_mask)
            else:
                x = self.encoder_layer(layer, x, pad_mask)
        h = F.gelu(linear(self.mlm_dense, x, dt))
        h = _layer_norm(h, self.mlm_ln_w, self.mlm_ln_b, c.layer_norm_eps)
        # the decoder is the word embedding; its bias stays fp32 (JAX adds
        # the fp32 leaf uncast)
        return (F.linear(h, compute_weight(self.word_embed.weight, dt))
                .float() + compute_weight(self.mlm_bias, torch.float32))

    def loss(self, batch: Any) -> torch.Tensor:
        """Masked-LM cross entropy; ``batch = {"input_ids", "labels"[,
        "attention_mask", "token_type_ids"]}`` with -100 = not masked."""
        logits = self.forward(batch["input_ids"], batch.get("attention_mask"),
                              batch.get("token_type_ids"))
        return masked_cross_entropy(logits, batch["labels"])
