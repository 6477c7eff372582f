"""OPT-family decoder in PyTorch: serving and training.

Counterpart of ``deepspeed_tpu/models/opt.py``: learned absolute position
embeddings (HF's table keeps two legacy rows, so positions start at
``POSITION_OFFSET``), pre-LN blocks with LayerNorm (fp32 statistics,
:func:`.bert._layer_norm`), biased projections, a ReLU MLP, a final norm
and the head tied to the token embedding.  ``forward`` / ``loss`` run the
causal LM (per-layer remat under a gradient; ``attn_impl="flash"`` runs
the hand-written CUDA flash kernels, causal at head dim 64 for OPT-1.3B,
where JAX's model keeps the plain masked softmax); ``init_cache`` /
``prefill`` / ``decode_step`` are the KV-cache path that ``init_inference(...)
.generate`` runs, its decode attention the hand-written CUDA kernel
(``ops/kernels/decode_attention.py``, multi-head: ``num_kv_heads ==
num_heads``); ``inference/v2/adapters.OPTV2Adapter`` serves it over the
paged pool.  Prefill and training attend with the plain masked softmax, as
the JAX model's ``_attention``.

Tensor parallelism (serving and training; JAX ``param_specs``
:123-143): built on a
process mesh (``OPTModel(config, mesh=...)``) whose ``tensor`` axis has
size ``tp``, or split in place by :meth:`OPTModel.shard_`
(``init_inference(tensor_parallel={"tp_size": tp})`` does it), each rank
holds ``q_proj`` / ``k_proj`` / ``v_proj`` / ``fc_in`` and their biases by
a block of output rows (its ``h/tp`` heads, ``F/tp`` of the MLP), and
``o_proj`` / ``fc_out`` by the matching block of input columns; their
biases, the tied embedding and head, the positions and the norms are
whole.  The row-parallel outputs are summed over ``tensor`` (Megatron's
*g*, after *f* before the column-parallel products) and their biases
added once, after the sum.  Training under tensor parallelism
(``initialize`` with ``tensor_parallel.autotp_size``) computes the whole
logits and the loss on every rank from the whole tied head; the
embedding's gradient is then equal on the tensor ranks (*f* summed it
into the residual stream) and is not reduced again, and so are the
row-parallel biases', which count as whole leaves.

Sequence parallelism (training; JAX's ``(DP, seq)`` constraints at
:166-168, 184, 204): on a mesh whose ``seq`` axis has size ``sp`` above
1, :meth:`OPTModel.loss` makes the labels from the whole rows, keeps this
rank's ``S/sp`` chunk, reads the position table at the chunk's global
positions (plus ``POSITION_OFFSET``), runs each attention through Ulysses
(causal over the full sequence on ``h/sp`` heads) and returns the chunk's
Σ nll over the valid count summed over ``seq`` (``bert.seq_share``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import flash_attention
from ..parallel.mesh import AXIS_TENSOR, ProcessMesh
from ..runtime.zero.init_ctx import active as zero_init_active
from ..runtime.zero.init_ctx import materialize
from ..runtime.zero.sharder import TensorShard, compute_weight
from ..utils.device import DeviceLike, resolve_device
from .bert import (SeqSplit, _layer_norm, _linear, _vector,
                   biased_tp_split_dim, linear, refuse_unported, remat,
                   seq_share)
from .llama import LlamaModel, TensorSplit, _attention, split_block

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
    #: training attention: "xla" the plain masked softmax (JAX's),
    #: "flash" the CUDA flash kernels, causal
    attn_impl: str = "xla"

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


def shard_opt_params(state_dict: Dict[str, torch.Tensor], tp: int,
                     rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s ``state_dict`` of an OPT split over ``tp`` ranks
    (:data:`.bert.BIASED_TP_DIMS`, the JAX ``param_specs``; the rest
    whole)."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} out of range for tp={tp}")
    out = {}
    for name, t in state_dict.items():
        dim = biased_tp_split_dim(name)
        out[name] = t if dim is None else split_block(t, dim, tp, rank, name)
    return out


class OPTLayer(nn.Module):
    """One pre-LN decoder block; ``nn.Linear`` weights are ``[out, in]``;
    under tensor parallelism (``tp > 1``) this rank's ``1/tp`` of the
    heads and of the MLP."""

    def __init__(self, c: OPTConfig, device: DeviceLike, tp: int = 1):
        super().__init__()
        H, Fd, dt = c.hidden_size, c.ffn_dim, c.storage_dtype
        self.attn_ln_w = _vector(H, device, dt)
        self.attn_ln_b = _vector(H, device, dt)
        self.q_proj = _linear(H, H // tp, device, dt)
        self.k_proj = _linear(H, H // tp, device, dt)
        self.v_proj = _linear(H, H // tp, device, dt)
        self.o_proj = _linear(H // tp, H, device, dt)
        self.mlp_ln_w = _vector(H, device, dt)
        self.mlp_ln_b = _vector(H, device, dt)
        self.fc_in = _linear(H, Fd // tp, device, dt)
        self.fc_out = _linear(Fd // tp, H, device, dt)


class OPTModel(TensorSplit, SeqSplit, nn.Module):
    """OPT causal LM with a KV cache.  ``device`` defaults to ``"cuda"``
    and raises without a CUDA device; weights are drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    #: the compression activation quantizer's bits (JAX arms them; here
    #: they raise, :func:`.bert.refuse_unported`)
    act_quant_bits: Optional[int] = None
    #: trains on a mesh whose ``tensor`` axis is above 1
    tensor_parallel_training = True

    def __init__(self, config: OPTConfig, device: DeviceLike = "cuda",
                 seed: int = 0, mesh: Optional[ProcessMesh] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        if c.attn_impl not in ("flash", "xla"):
            raise ValueError(f"attn_impl {c.attn_impl!r} is not ported (use "
                             "'flash' or 'xla')")
        self._set_mesh(mesh)
        H, dt = c.hidden_size, c.storage_dtype
        self.embed = nn.Embedding(c.vocab_size, H, device="meta", dtype=dt)
        self.pos_embed = nn.Embedding(c.max_seq_len + POSITION_OFFSET, H,
                                      device="meta", dtype=dt)
        self.layers = nn.ModuleList(OPTLayer(c, "meta", self.tp)
                                    for _ in range(c.num_layers))
        self.final_ln_w = _vector(H, "meta", dt)
        self.final_ln_b = _vector(H, "meta", dt)
        if zero_init_active() is None:
            self.to_empty(device=dev)
        self.init_params(seed, dev)
        self._mark_tensor()

    def _set_mesh(self, mesh: Optional[ProcessMesh]) -> None:
        """Take ``mesh``'s tensor axis: this rank's split sizes and
        place (the engines read ``tp``, ``mesh`` and the local heads)."""
        c = self.config
        tp = int(mesh.shape[AXIS_TENSOR]) if mesh is not None else 1
        for what, n in (("heads", c.num_heads), ("ffn dim", c.ffn_dim)):
            if n % tp:
                raise ValueError(f"tensor size {tp} must divide the {what} "
                                 f"({n})")
        self.mesh = mesh
        self.tp = tp
        self.tp_rank = mesh.axis_rank(AXIS_TENSOR) if tp > 1 else 0
        self.num_local_heads = self.num_local_kv_heads = c.num_heads // tp

    def _mark_tensor(self) -> None:
        if self.tp == 1:
            return
        for name, p in self.named_parameters():
            dim = biased_tp_split_dim(name)
            if dim is not None:
                p.ds_tensor = TensorShard(dim, self.tp, self.tp_rank)

    @torch.no_grad()
    def shard_(self, mesh: ProcessMesh) -> "OPTModel":
        """Keep this rank's tensor-parallel slice of a whole model's
        weights, in place (the reference's AutoTP on a loaded module)."""
        if self.tp != 1:
            raise ValueError(f"the model is already split over {self.tp} "
                             "ranks")
        self._set_mesh(mesh)
        for name, p in self.named_parameters():
            dim = biased_tp_split_dim(name)
            if dim is not None:
                p.data = split_block(p.data, dim, self.tp, self.tp_rank, name)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.out_features, module.in_features = module.weight.shape
        self._mark_tensor()
        return self

    @property
    def device(self) -> torch.device:
        return self.final_ln_w.device

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    device: Optional[torch.device] = None) -> None:
        """The JAX model's distribution: every matrix ``N(0, 1/fan_in)``,
        biases 0, norms' scales 1, drawn in fp32 from a generator seeded
        with ``seed``; on a tensor axis each whole weight is drawn and this
        rank's block kept (a slice of the one-process model)."""
        dev = device if device is not None else self.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal_(w: torch.Tensor, fan_in: int,
                    dim: Optional[int] = None) -> None:
            shape = list(w.shape)
            if dim is not None:
                shape[dim] *= self.tp
            full = torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).div_(math.sqrt(fan_in))
            if dim is not None:
                n = w.shape[dim]
                full = full.narrow(dim, self.tp_rank * n, n)
            materialize(w, dev, lambda t: t.copy_(full))

        H, Fd = self.config.hidden_size, self.config.ffn_dim
        normal_(self.embed.weight, H)
        normal_(self.pos_embed.weight, H)
        tp = None if self.tp == 1 else 0
        for layer in self.layers:
            for lin, fan_in, dim in (
                    (layer.q_proj, H, tp), (layer.k_proj, H, tp),
                    (layer.v_proj, H, tp),
                    (layer.o_proj, H, None if tp is None else 1),
                    (layer.fc_in, H, tp),
                    (layer.fc_out, Fd, None if tp is None else 1)):
                normal_(lin.weight, fan_in, dim)
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
        """``x [..., H]`` → q, k, v ``[..., h, d]`` (this rank's heads)
        after the attention norm."""
        c = self.config
        h = self._tp_copy(_layer_norm(x, layer.attn_ln_w, layer.attn_ln_b,
                                      c.layer_norm_eps))
        shape = x.shape[:-1] + (self.num_local_heads, c.hd)
        return tuple(linear(lin, h, c.dtype).view(shape)
                     for lin in (layer.q_proj, layer.k_proj, layer.v_proj))

    def post_attn(self, layer: OPTLayer, x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
        """Output projection + residual, then the ReLU MLP block +
        residual; ``attn [..., h, d]``."""
        c = self.config
        x = x + self._row_parallel(layer.o_proj, attn.flatten(-2))
        h = self._tp_copy(_layer_norm(x, layer.mlp_ln_w, layer.mlp_ln_b,
                                      c.layer_norm_eps))
        h = F.relu(linear(layer.fc_in, h, c.dtype))
        return x + self._row_parallel(layer.fc_out, h)

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self.final_ln_w, self.final_ln_b,
                           self.config.layer_norm_eps)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied head in the model dtype, returned as fp32 ``[..., V]``."""
        return F.linear(x, compute_weight(self.embed.weight,
                                          self.config.dtype)).float()

    # -- full forward and training -------------------------------------------

    def _layer(self, layer: OPTLayer, x: torch.Tensor) -> torch.Tensor:
        """One block over ``x [B, S, H]`` (under ``seq`` this rank's
        chunk), its attention causal over the whole sequence."""
        q, k, v = self.qkv(layer, x)
        return self.post_attn(layer, x, self._seq_attention(
            self._attend, q, k, v))

    def _attend(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """Causal attention over a whole sequence ``[B, S, h, d]``."""
        if self.config.attn_impl == "flash":
            return flash_attention(q, k, v, True)
        S = q.shape[1]
        return _attention(q, k, v, torch.tril(torch.ones(
            S, S, dtype=torch.bool, device=q.device)))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids → ``[B, S, V]`` fp32 logits (with a gradient when
        grad is enabled; under ``config.remat`` each layer is recomputed in
        the backward)."""
        return self._logits(input_ids, 0)

    def _logits(self, input_ids: torch.Tensor, lo: int) -> torch.Tensor:
        """The logits of ``input_ids`` at positions ``lo ..`` (under
        ``seq``: this rank's chunk of the rows)."""
        refuse_unported(self)
        n = input_ids.shape[1]
        self._check_len(lo + n)
        pos = lo + torch.arange(n, device=self.device)
        x = self.embed_tokens(input_ids, pos[None])
        use_remat = self.config.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (remat(self._layer, layer, x) if use_remat
                 else self._layer(layer, x))
        return self.logits(self.finalize(x))

    def loss(self, batch: Any) -> torch.Tensor:
        """Next-token cross entropy (labels default to the inputs shifted
        left, ``LlamaModel.batch_labels``); under ``seq`` this rank's share
        of it, the labels made from the whole rows."""
        input_ids, labels = LlamaModel.batch_labels(batch)
        group, sp = self._seq()
        lo = 0
        if sp > 1:
            lo, n = self._seq_span(input_ids.shape[1], sp)
            input_ids, labels = (input_ids[:, lo:lo + n],
                                 labels[:, lo:lo + n])
        return seq_share(self._logits(input_ids, lo), labels, group)

    # -- KV-cache inference path (inference/engine.py) ---------------------

    def init_cache(self, batch_size: int, max_len: int
                   ) -> Dict[str, torch.Tensor]:
        c = self.config
        shape = (c.num_layers, batch_size, max_len, self.num_local_heads,
                 c.hd)
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
