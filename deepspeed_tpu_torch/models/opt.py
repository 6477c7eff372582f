"""OPT-family decoder in PyTorch: serving and training.

Counterpart of ``deepspeed_tpu/models/opt.py``: learned absolute position
embeddings (HF's table keeps two legacy rows, so positions start at
``POSITION_OFFSET``), pre-LN blocks with LayerNorm (fp32 statistics,
:func:`.bert._layer_norm`), biased projections, a ReLU MLP, a final norm
and the head tied to the token embedding.  ``forward`` / ``loss`` run the
causal LM (per-layer remat under a gradient); ``init_cache`` / ``prefill``
/ ``decode_step`` are the KV-cache path that ``init_inference(...)
.generate`` runs, its decode attention the hand-written CUDA kernel
(``ops/kernels/decode_attention.py``, multi-head: ``num_kv_heads ==
num_heads``); ``inference/v2/adapters.OPTV2Adapter`` serves it over the
paged pool.  Prefill and training attend with the plain masked softmax, as
the JAX model's ``_attention``.

Tensor parallelism is not ported for OPT (ROADMAP Queue 1 item 6b): the
model has no ``shard_``, so ``init_inference`` with a ``tp_size`` above 1
raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.decode_attention import decode_attention
from ..runtime.zero.init_ctx import active as zero_init_active
from ..runtime.zero.init_ctx import materialize
from ..runtime.zero.sharder import compute_weight
from ..utils.device import DeviceLike, resolve_device
from .bert import (_layer_norm, _linear, _vector, linear, refuse_unported,
                   remat)
from .llama import LlamaModel, _attention, masked_cross_entropy

#: HF OPT reserves positions 0/1 (pad/bos legacy): positions start here
POSITION_OFFSET = 2


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 2048
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    #: storage dtype of the weights (None: ``dtype``)
    param_dtype: Optional[torch.dtype] = None
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads  # multi-head attention

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.param_dtype if self.param_dtype is not None else self.dtype

    @classmethod
    def tiny(cls, **kw) -> "OPTConfig":
        d = dict(vocab_size=512, hidden_size=128, ffn_dim=256,
                 num_layers=4, num_heads=8, max_seq_len=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def opt_1_3b(cls, **kw) -> "OPTConfig":
        d = dict(hidden_size=2048, ffn_dim=8192, num_layers=24,
                 num_heads=32)
        d.update(kw)
        return cls(**d)

    def num_params(self) -> int:
        H, Fd, V, L = (self.hidden_size, self.ffn_dim, self.vocab_size,
                       self.num_layers)
        per_layer = 4 * H * H + 4 * H + 2 * H * Fd + Fd + H + 4 * H
        return (V + self.max_seq_len + POSITION_OFFSET) * H + \
            L * per_layer + 2 * H


class OPTLayer(nn.Module):
    """One pre-LN decoder block; ``nn.Linear`` weights are ``[out, in]``."""

    def __init__(self, c: OPTConfig, device: DeviceLike):
        super().__init__()
        H, dt = c.hidden_size, c.storage_dtype
        self.attn_ln_w = _vector(H, device, dt)
        self.attn_ln_b = _vector(H, device, dt)
        self.q_proj = _linear(H, H, device, dt)
        self.k_proj = _linear(H, H, device, dt)
        self.v_proj = _linear(H, H, device, dt)
        self.o_proj = _linear(H, H, device, dt)
        self.mlp_ln_w = _vector(H, device, dt)
        self.mlp_ln_b = _vector(H, device, dt)
        self.fc_in = _linear(H, c.ffn_dim, device, dt)
        self.fc_out = _linear(c.ffn_dim, H, device, dt)


class OPTModel(nn.Module):
    """OPT causal LM with a KV cache.  ``device`` defaults to ``"cuda"``
    and raises without a CUDA device; weights are drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    #: the compression activation quantizer's bits (JAX arms them; here
    #: they raise, :func:`.bert.refuse_unported`)
    act_quant_bits: Optional[int] = None
    #: the engines' tensor-parallel facts: OPT is served whole
    tp = 1
    mesh = None

    def __init__(self, config: OPTConfig, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        H, dt = c.hidden_size, c.storage_dtype
        self.embed = nn.Embedding(c.vocab_size, H, device="meta", dtype=dt)
        self.pos_embed = nn.Embedding(c.max_seq_len + POSITION_OFFSET, H,
                                      device="meta", dtype=dt)
        self.layers = nn.ModuleList(OPTLayer(c, "meta")
                                    for _ in range(c.num_layers))
        self.final_ln_w = _vector(H, "meta", dt)
        self.final_ln_b = _vector(H, "meta", dt)
        if zero_init_active() is None:
            self.to_empty(device=dev)
        self.init_params(seed, dev)

    @property
    def device(self) -> torch.device:
        return self.final_ln_w.device

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    device: Optional[torch.device] = None) -> None:
        """The JAX model's distribution: every matrix ``N(0, 1/fan_in)``,
        biases 0, norms' scales 1, drawn in fp32 from a generator seeded
        with ``seed``."""
        dev = device if device is not None else self.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal_(w: torch.Tensor, fan_in: int) -> None:
            full = torch.randn(w.shape, generator=gen, device=dev,
                               dtype=torch.float32).div_(math.sqrt(fan_in))
            materialize(w, dev, lambda t: t.copy_(full))

        H = self.config.hidden_size
        normal_(self.embed.weight, H)
        normal_(self.pos_embed.weight, H)
        for layer in self.layers:
            for lin in (layer.q_proj, layer.k_proj, layer.v_proj,
                        layer.o_proj, layer.fc_in, layer.fc_out):
                normal_(lin.weight, lin.in_features)
        for name, p in self.named_parameters():
            if name.endswith("_ln_w"):
                materialize(p, dev, lambda t: t.fill_(1.0))
            elif name.endswith(("_ln_b", ".bias")):
                materialize(p, dev, lambda t: t.fill_(0.0))

    # -- pieces shared with the v2 adapter ---------------------------------

    def _check_len(self, S: int) -> None:
        # the learned position table has a hard bound
        if S > self.config.max_seq_len:
            raise ValueError(f"sequence length {S} exceeds max_seq_len "
                             f"{self.config.max_seq_len} (learned position "
                             "table)")

    def embed_tokens(self, ids: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        """Token plus learned position embeddings ``[..., H]``; a position
        past the table reads its last row (JAX's clamp)."""
        dt = self.config.dtype
        pos = (positions.long() + POSITION_OFFSET).clamp(
            max=self.pos_embed.num_embeddings - 1)
        return (F.embedding(ids.long(), compute_weight(self.embed.weight, dt))
                + F.embedding(pos, compute_weight(self.pos_embed.weight, dt)))

    def qkv(self, layer: OPTLayer, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x [..., H]`` → q, k, v ``[..., h, d]`` after the attention
        norm."""
        c = self.config
        h = _layer_norm(x, layer.attn_ln_w, layer.attn_ln_b, c.layer_norm_eps)
        shape = x.shape[:-1] + (c.num_heads, c.hd)
        return tuple(linear(lin, h, c.dtype).view(shape)
                     for lin in (layer.q_proj, layer.k_proj, layer.v_proj))

    def post_attn(self, layer: OPTLayer, x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
        """Output projection + residual, then the ReLU MLP block +
        residual; ``attn [..., h, d]``."""
        c = self.config
        x = x + linear(layer.o_proj, attn.flatten(-2), c.dtype)
        h = _layer_norm(x, layer.mlp_ln_w, layer.mlp_ln_b, c.layer_norm_eps)
        h = F.relu(linear(layer.fc_in, h, c.dtype))
        return x + linear(layer.fc_out, h, c.dtype)

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self.final_ln_w, self.final_ln_b,
                           self.config.layer_norm_eps)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied head in the model dtype, returned as fp32 ``[..., V]``."""
        return F.linear(x, compute_weight(self.embed.weight,
                                          self.config.dtype)).float()

    # -- full forward and training -------------------------------------------

    def _layer(self, layer: OPTLayer, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(layer, x)
        return self.post_attn(layer, x, _attention(q, k, v, mask))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids → ``[B, S, V]`` fp32 logits (with a gradient when
        grad is enabled; under ``config.remat`` each layer is recomputed in
        the backward)."""
        refuse_unported(self)
        S = input_ids.shape[1]
        self._check_len(S)
        pos = torch.arange(S, device=self.device)
        mask = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                     device=self.device))
        x = self.embed_tokens(input_ids, pos[None])
        use_remat = self.config.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (remat(self._layer, layer, x, mask) if use_remat
                 else self._layer(layer, x, mask))
        return self.logits(self.finalize(x))

    def loss(self, batch: Any) -> torch.Tensor:
        """Next-token cross entropy (labels default to the inputs shifted
        left, ``LlamaModel.batch_labels``)."""
        input_ids, labels = LlamaModel.batch_labels(batch)
        return masked_cross_entropy(self.forward(input_ids), labels)

    # -- KV-cache inference path (inference/engine.py) ---------------------

    def init_cache(self, batch_size: int, max_len: int
                   ) -> Dict[str, torch.Tensor]:
        c = self.config
        shape = (c.num_layers, batch_size, max_len, c.num_heads, c.hd)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=c.dtype, device=self.device),
                "lengths": torch.zeros(batch_size, dtype=torch.int32,
                                       device=self.device)}

    @torch.no_grad()
    def prefill(self, input_ids: torch.Tensor, cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process the prompt ``[B, S]``; returns (last-token logits ``[B,
        V]`` fp32, the cache, whose K/V are written in place)."""
        B, S = input_ids.shape
        self._check_len(S)
        pos = torch.arange(S, device=self.device)
        mask = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                     device=self.device))
        x = self.embed_tokens(input_ids, pos[None])
        for li, layer in enumerate(self.layers):
            q, k, v = self.qkv(layer, x)
            cache["k"][li, :, :S] = k
            cache["v"][li, :, :S] = v
            x = self.post_attn(layer, x, _attention(q, k, v, mask))
        cache["lengths"] = torch.full((B,), S, dtype=torch.int32,
                                      device=self.device)
        return self.logits(self.finalize(x[:, -1])), cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One generation step: ``tokens [B]`` → (logits ``[B, V]`` fp32,
        the cache); attention is the decode kernel over ``lengths + 1``
        keys."""
        B = tokens.shape[0]
        lengths = cache["lengths"]
        rows = torch.arange(B, device=self.device)
        wpos = lengths.long()
        x = self.embed_tokens(tokens, lengths)
        for li, layer in enumerate(self.layers):
            q, k, v = self.qkv(layer, x)
            k_cache, v_cache = cache["k"][li], cache["v"][li]
            k_cache[rows, wpos] = k
            v_cache[rows, wpos] = v
            attn = decode_attention(q, k_cache, v_cache, lengths + 1)
            x = self.post_attn(layer, x, attn)
        cache["lengths"] = lengths + 1
        return self.logits(self.finalize(x)), cache
