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
JAX package left it to XLA.

Tensor parallelism: built on a process mesh (``LlamaModel(config,
mesh=...)``) whose ``tensor`` axis has size ``tp``, or split in place by
:meth:`LlamaModel.shard_`, each rank holds Megatron's split of every layer,
the JAX model's ``param_specs``: ``q_proj``, ``k_proj``, ``v_proj``,
``gate_proj`` and ``up_proj`` keep a contiguous block of their output
rows, ``o_proj`` and ``down_proj`` the matching block of their input
columns, ``lm_head`` a block of the vocabulary (unless the embeddings are
tied); the embedding and the norms are whole.  Every split parameter
carries ``ds_tensor`` (``runtime/zero/sharder.TensorShard``).  Rank ``r``
owns query heads ``[r·h/tp, (r+1)·h/tp)`` and kv heads ``[r·kv/tp, ...)``,
so every GQA group stays on one rank.  The layers follow JAX's
``decoder_layer_manual_tp``: Megatron's *f* (``comm.tp_copy``: identity,
the gradient summed over ``tensor``) before the column-parallel
projections, *g* (``comm.tp_reduce``: the partial outputs summed over
``tensor``, the gradient passed through) after ``o_proj`` and
``down_proj``; without a gradient (serving) *g* is an in-place all-reduce.
Serving all-gathers the logits' vocabulary blocks; training never does:
the loss is JAX's ``head_loss_manual_tp``, the vocabulary-parallel cross
entropy (local ``[B, s, V/tp]`` fp32 logits, the max shift over
``tensor`` by ``comm.tp_max``, ``lse = log(g(Σ exp)) + m``, the gold
logit from the one rank that owns it, summed by *g*), tiled by
``config.loss_tiles``.  Under remat the recompute re-runs a layer's *g*:
every tensor rank issues them in the same order.  With a ``seq`` axis
too (JAX's ``(DP, seq, tensor)`` constraints around ``ulysses_attention``)
a rank holds its ``h/tp`` heads of its ``S/sp`` chunk: Ulysses exchanges
them over the rank's ``seq`` group (``h/(tp·sp)`` heads at the full
sequence; the ring runs on the ``h/tp`` heads), and the
vocabulary-parallel loss of the chunk is summed over ``tensor``, its
share of the token mean over ``seq``.  The layer-streaming protocol runs
the same split layers (ZeRO-Infinity under tensor parallelism).
Pipeline parallelism is not ported yet (ROADMAP Queue 1 item 8).

Sequence parallelism (training; ``runtime/sequence_parallel``): on a mesh
whose ``seq`` axis has size ``sp`` above 1 (``initialize`` hands the model
its mesh), :meth:`LlamaModel.loss` takes the rank's full-sequence rows,
makes the labels from the whole sequence, and keeps its own ``S/sp``
chunk from the embedding to the loss, RoPE at global positions.  At each
attention the Ulysses all-to-all gives the rank the full sequence on
``h/sp`` heads (GQA K/V repeated first, as the JAX model does), or, under
``attn_impl="ring"``, the K/V blocks travel the ring at their kv width.
The loss is the rank's Σ nll over the valid-label count summed over
``seq``, so the ranks' losses (and, summed by the engine, their
gradients) add up to the token mean of the whole sequence.
``config.loss_tiles`` above 1 forms the logits and the loss a tile of the
sequence at a time (:func:`~..runtime.sequence_parallel.ulysses_sp.
sequence_tiled_nll`), with or without a ``seq`` axis.

Data parallelism (``runtime/engine.py``): every read of a weight goes
through ``runtime/zero/sharder.compute_weight``, a cast to the compute
dtype; under ZeRO-3 it also gathers the weight's chunks from the
data-parallel ranks (and reduce-scatters its gradient), again in the
recompute under remat.  A model built inside ``zero.Init`` is born cut:
:meth:`LlamaModel.init_params` draws one weight at a time through
``runtime/zero/init_ctx.materialize``.
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

from ..comm import comm
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import flash_attention
from ..ops.masks import local_attention_mask
from ..parallel.mesh import AXIS_SEQ, AXIS_TENSOR, ProcessMesh
from ..runtime.sequence_parallel.ring import ring_attention
from ..runtime.sequence_parallel.ulysses_sp import (seq_group_of,
                                                    sequence_tiled_nll,
                                                    ulysses_attention)
from ..runtime.zero.init_ctx import active as zero_init_active
from ..runtime.zero.init_ctx import materialize
from ..runtime.zero.sharder import TensorShard, compute_weight
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
    #: plain einsum + softmax, "ring" ring attention over a ``seq`` axis
    #: above 1 (plain attention without one); the JAX config's flash block
    #: sizes have no counterpart: the Hopper kernels fix their own 64 x 64
    #: tile
    attn_impl: str = "xla"
    #: above 1: the final projection and the loss run a tile of
    #: ``S/loss_tiles`` positions at a time, so the ``[B, S, V]`` logits are
    #: never whole (ALST's sequence-tiled loss; S % loss_tiles: one tile)
    loss_tiles: int = 1
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
    return (x32 * torch.rsqrt(var + eps)).to(dt) * compute_weight(w, dt)


def masked_nll(logits: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σ nll, valid count)`` in fp32 with -100 ignore positions (HF
    convention); the count carries no gradient."""
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


def masked_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in fp32 with -100 ignore positions."""
    total, count = masked_nll(logits, labels)
    return total / count.clamp(min=1)


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


#: ``normal_(weight, fan_in, tp_dim=None, ep_dim=None)``: draw ``N(0,
#: 1/fan_in)`` into ``weight``, this rank's slice along ``tp_dim`` (the
#: tensor axis) and ``ep_dim`` (the expert axis) of the whole weight;
#: ``ones_(weight)`` sets it to one
Init = Callable[..., None]

#: a layer's ``nn.Linear`` → the dim of its ``[out, in]`` weight that tensor
#: parallelism splits: 0, the output rows (column-parallel), or 1, the
#: input columns (row-parallel); the JAX ``param_specs``' ``tensor`` entries
LAYER_TP_DIMS = {"q_proj": 0, "k_proj": 0, "v_proj": 0, "o_proj": 1,
                 "gate_proj": 0, "up_proj": 0, "down_proj": 1}

#: a Mixtral layer's expert stacks (``[E, H, I]``, ``[E, I, H]``) → the
#: dim tensor parallelism splits, the FFN dim (JAX ``P(pipe, "expert",
#: None, "tensor")`` and ``P(pipe, "expert", "tensor", None)``); expert
#: parallelism splits dim 0, the experts
EXPERT_TP_DIMS = {"w_gate": 2, "w_up": 2, "w_down": 1}


def tp_split_dim(name: str) -> Optional[int]:
    """The dim of state-dict entry ``name`` that tensor parallelism splits;
    None for a weight every rank holds whole."""
    if name == "lm_head.weight":
        return 0  # the vocabulary
    parts = name.split(".")
    if len(parts) == 4 and parts[0] == "layers" and parts[3] == "weight":
        return LAYER_TP_DIMS.get(parts[2])
    if len(parts) == 3 and parts[0] == "layers":
        return EXPERT_TP_DIMS.get(parts[2])
    return None


def is_expert_leaf(name: str) -> bool:
    """Whether state-dict entry ``name`` is an expert stack (expert
    parallelism cuts its dim 0)."""
    parts = name.split(".")
    return len(parts) == 3 and parts[0] == "layers" and \
        parts[2] in EXPERT_TP_DIMS


def split_block(t: torch.Tensor, dim: int, parts: int, rank: int,
                what: str) -> torch.Tensor:
    """Block ``rank`` of ``parts`` contiguous blocks of ``t`` along
    ``dim``, a copy (``t`` itself for one part)."""
    if parts == 1:
        return t
    if t.shape[dim] % parts:
        raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} does not "
                         f"split over {parts} ranks")
    n = t.shape[dim] // parts
    return t.narrow(dim, rank * n, n).clone()


def tp_shard(name: str, t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of state-dict entry ``name`` along
    its split dim (``t`` itself when every rank holds it whole)."""
    dim = tp_split_dim(name)
    if dim is None:
        return t
    return split_block(t, dim, tp, rank, name)


class LlamaDecoderLayer(nn.Module):
    """One decoder layer; under tensor parallelism (``tp > 1``) it holds
    this rank's ``1/tp`` of the heads and of the FFN's intermediate dim
    (and a Mixtral layer ``1/ep`` of the experts)."""

    def __init__(self, c: LlamaConfig, device: DeviceLike, tp: int = 1,
                 ep: int = 1):
        super().__init__()
        H, hd = c.hidden_size, c.hd
        self.compute_dtype = c.dtype
        self.tp = tp
        self.ep = ep
        kw = dict(bias=False, device=device, dtype=c.storage_dtype)
        self.attn_norm = nn.Parameter(torch.empty(H, device=device,
                                                  dtype=c.storage_dtype))
        self.q_proj = nn.Linear(H, c.num_heads // tp * hd, **kw)
        self.k_proj = nn.Linear(H, c.num_kv_heads // tp * hd, **kw)
        self.v_proj = nn.Linear(H, c.num_kv_heads // tp * hd, **kw)
        self.o_proj = nn.Linear(c.num_heads // tp * hd, H, **kw)
        self.mlp_norm = nn.Parameter(torch.empty(H, device=device,
                                                 dtype=c.storage_dtype))
        self._build_ffn(c, device)

    def _build_ffn(self, c: LlamaConfig, device: DeviceLike) -> None:
        """The dense SwiGLU's three projections."""
        H, I = c.hidden_size, c.intermediate_size // self.tp
        kw = dict(bias=False, device=device, dtype=c.storage_dtype)
        self.gate_proj = nn.Linear(H, I, **kw)
        self.up_proj = nn.Linear(H, I, **kw)
        self.down_proj = nn.Linear(I, H, **kw)

    def reset_parameters(self, normal_: Init, ones_: Init) -> None:
        """Every matrix from ``normal_`` (attention first, then the FFN, one
        tensor at a time), the norms at one."""
        self._normal_linears(normal_, "q_proj", "k_proj", "v_proj", "o_proj")
        self._reset_ffn(normal_)
        ones_(self.attn_norm)
        ones_(self.mlp_norm)

    def _reset_ffn(self, normal_: Init) -> None:
        self._normal_linears(normal_, "gate_proj", "up_proj", "down_proj")

    def _normal_linears(self, normal_: Init, *names: str) -> None:
        for name in names:
            lin, dim = getattr(self, name), LAYER_TP_DIMS[name]
            # a row-parallel weight holds 1/tp of its inputs; the fan-in
            # is the whole weight's
            normal_(lin.weight, lin.in_features * (self.tp if dim == 1
                                                   else 1), dim)

    def proj(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``x @ W.T`` with the weight cast to the compute dtype at use
        (gathered under ZeRO-3)."""
        return F.linear(x, compute_weight(lin.weight, self.compute_dtype))

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        """Dense SwiGLU."""
        return self.proj(self.down_proj,
                         F.silu(self.proj(self.gate_proj, h))
                         * self.proj(self.up_proj, h))


class TensorSplit:
    """Megatron's *f* and *g* over a model's ``tensor`` group (the
    identity at ``tp`` 1); the model sets ``tp`` and ``mesh``."""

    tp: int
    mesh: Optional[ProcessMesh]

    def _tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        """*f* before a column-parallel product: ``x``, its gradient
        summed over the tensor group."""
        if self.tp == 1:
            return x
        return comm.tp_copy(x, self.mesh.group(AXIS_TENSOR))

    def _tp_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """*g*: the row-parallel partial outputs summed over the tensor
        group in their dtype (without a gradient in place)."""
        if self.tp == 1:
            return x
        return comm.tp_reduce(x, self.mesh.group(AXIS_TENSOR))

    def _row_parallel(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product in the model's compute dtype summed over
        ``tensor`` (*g*), its bias (whole) added once after the sum (at
        ``tp`` 1: ``x @ W.T + b``, the product rounded before the bias)."""
        dt = self.config.dtype
        out = self._tp_reduce(F.linear(x, compute_weight(lin.weight, dt)))
        return out if lin.bias is None else \
            out + compute_weight(lin.bias, dt)


class LlamaModel(TensorSplit, nn.Module):
    """Llama decoder with a KV cache.  ``device`` defaults to ``"cuda"``
    and raises without a CUDA device; weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` (see :meth:`init_params`).
    ``mesh`` (a process mesh of ``utils.groups``) makes the model this
    rank's tensor-parallel shard.  Built inside ``zero.Init``, the model
    holds this rank's ZeRO-3 chunks.  ``init_device`` draws the weights
    with that device's generator (one weight at a time) and stores them on
    ``device``: a model for ZeRO-Infinity lives in host memory and may
    draw on the card (the same weights as a model built there)."""

    layer_cls = LlamaDecoderLayer
    #: the model's expert-parallel split (a Mixtral's experts): 1, no experts
    ep = 1
    ep_rank = 0
    #: trains on a mesh whose ``seq`` axis is above 1 (``initialize``
    #: refuses such a mesh for a model without this), and on one whose
    #: ``tensor`` axis is above 1 too
    sequence_parallel = True
    sequence_tensor_parallel = True
    #: trains on a mesh whose ``tensor`` axis is above 1 (``initialize``
    #: refuses such a mesh for a model without this)
    tensor_parallel_training = True
    #: trains under ZeRO++ (``initialize`` refuses qwZ, qgZ and hpZ for a
    #: model without this); :meth:`qwz_view` gives qwZ each leaf's groups
    zero_pp = True

    def __init__(self, config: LlamaConfig, device: DeviceLike = "cuda",
                 seed: int = 0, mesh: Optional[ProcessMesh] = None,
                 init_device: Optional[DeviceLike] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        self._set_mesh(mesh)
        # built on the meta device and materialised once: the init below
        # writes every weight, so a default init would be wasted work
        self.embed = nn.Embedding(c.vocab_size, c.hidden_size,
                                  device="meta", dtype=c.storage_dtype)
        self.layers = nn.ModuleList(self.layer_cls(c, "meta", self.tp,
                                                   self.ep)
                                    for _ in range(c.num_layers))
        self.final_norm = nn.Parameter(torch.empty(c.hidden_size,
                                                   device="meta",
                                                   dtype=c.storage_dtype))
        self.lm_head = (None if c.tie_embeddings else
                        nn.Linear(c.hidden_size, c.vocab_size // self.tp,
                                  bias=False, device="meta",
                                  dtype=c.storage_dtype))
        if zero_init_active() is None:
            self.to_empty(device=dev)
        self.init_params(seed, dev if init_device is None
                         else resolve_device(init_device))
        self._mark_tensor()

    def _mark_tensor(self) -> None:
        """Mark each parameter tensor parallelism splits with its
        ``ds_tensor`` (nothing without a tensor axis)."""
        if self.tp == 1:
            return
        for name, p in self.named_parameters():
            dim = tp_split_dim(name)
            if dim is not None:
                p.ds_tensor = TensorShard(dim, self.tp, self.tp_rank)

    def _set_mesh(self, mesh: Optional[ProcessMesh]) -> None:
        """Take ``mesh``'s tensor axis: this rank's split sizes and place."""
        c = self.config
        tp = int(mesh.shape[AXIS_TENSOR]) if mesh is not None else 1
        if tp > 1:
            for what, n in (("kv heads", c.num_kv_heads),
                            ("intermediate size", c.intermediate_size),
                            ("vocab size", None if c.tie_embeddings
                             else c.vocab_size)):
                if n is not None and n % tp:
                    raise ValueError(f"tensor size {tp} must divide the "
                                     f"{what} ({n})")
        self.mesh = mesh
        self.tp = tp
        self.tp_rank = mesh.axis_rank(AXIS_TENSOR) if tp > 1 else 0
        #: this rank's query and kv heads
        self.num_local_heads = c.num_heads // tp
        self.num_local_kv_heads = c.num_kv_heads // tp

    @torch.no_grad()
    def shard_(self, mesh: ProcessMesh) -> "LlamaModel":
        """Keep this rank's tensor-parallel slice of a whole model's
        weights (and a Mixtral's expert-parallel slice of its experts), in
        place (the reference's AutoTP on a loaded module)."""
        if self.tp != 1 or self.ep != 1:
            raise ValueError(f"the model is already split over "
                             f"{self.tp * self.ep} ranks")
        self._set_mesh(mesh)
        for name, p in self.named_parameters():
            t = tp_shard(name, p.data, self.tp, self.tp_rank)
            if is_expert_leaf(name):
                t = split_block(t, 0, self.ep, self.ep_rank, name)
            p.data = t
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.out_features, module.in_features = module.weight.shape
        for layer in self.layers:
            layer.tp, layer.ep = self.tp, self.ep
        self._mark_tensor()
        return self

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def qwz_view(self, name: str) -> Tuple[int, int, int]:
        """qwZ's view of parameter ``name`` in the JAX model's layout
        (``models/convert.py``): ``(the port dim along which the JAX
        leaf's last dim runs, that dim's length, the JAX leaf's
        elements)``; a layer's leaf counts every layer of JAX's stack.
        ``q_proj.weight [nh·hd, H]`` is ``wq [L, H, nh, hd]``: its last dim
        ``hd`` runs along dim 0, inside each head."""
        c = self.config
        L, H, V, I, hd = (c.num_layers, c.hidden_size, c.vocab_size,
                          c.intermediate_size, c.hd)
        leaf = name.split(".")[-2] if name.endswith(".weight") \
            else name.split(".")[-1]
        whole = {"embed": (1, H, V * H), "lm_head": (0, V, H * V),
                 "final_norm": (0, H, H)}
        if leaf in whole:
            return whole[leaf]
        heads = {"q_proj": c.num_heads, "k_proj": c.num_kv_heads,
                 "v_proj": c.num_kv_heads}
        if leaf in heads:
            return 0, hd, L * H * heads[leaf] * hd
        return {"attn_norm": (0, H, L * H), "mlp_norm": (0, H, L * H),
                "o_proj": (0, H, L * c.num_heads * hd * H),
                "gate_proj": (0, I, L * H * I), "up_proj": (0, I, L * H * I),
                "down_proj": (0, H, L * I * H)}[leaf]

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    device: Optional[torch.device] = None) -> None:
        """Norms at one; every matrix ``N(0, 1/fan_in)``, drawn in fp32 from a
        seeded generator on ``device`` (the model's) and stored in
        ``config.storage_dtype`` (the JAX model's init distribution; its
        numbers differ, since the two generators differ).  Parameters still
        on the meta device (a model built inside ``zero.Init``) are
        materialised one at a time."""
        dev = device if device is not None else self.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal_(w: torch.Tensor, fan_in: int,
                    tp_dim: Optional[int] = None,
                    ep_dim: Optional[int] = None) -> None:
            # the whole weight is drawn, so a rank's shard is exactly that
            # slice of the unsplit model from the same seed
            splits = [(d, parts, rank) for d, parts, rank in (
                (tp_dim, self.tp, self.tp_rank),
                (ep_dim, self.ep, self.ep_rank)) if d is not None]
            shape = list(w.shape)
            for d, parts, _ in splits:
                shape[d] *= parts
            full = torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).div_(math.sqrt(fan_in))
            for d, _, rank in splits:
                n = w.shape[d]
                full = full.narrow(d, rank * n, n)
            materialize(w, dev, lambda t: t.copy_(full))

        def ones_(w: torch.Tensor) -> None:
            materialize(w, dev, lambda t: t.fill_(1.0))

        c = self.config
        normal_(self.embed.weight, c.hidden_size)
        for layer in self.layers:
            layer.reset_parameters(normal_, ones_)
        ones_(self.final_norm)
        if self.lm_head is not None:
            normal_(self.lm_head.weight, c.hidden_size, 0)

    # -- pieces shared with the v2 adapter -------------------------------

    def head_weight(self) -> torch.Tensor:
        """``[V, H]`` output projection (the embedding when tied)."""
        return (self.embed.weight if self.config.tie_embeddings
                else self.lm_head.weight)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """``ids [...]`` → ``[..., H]`` in the compute dtype."""
        return F.embedding(ids.long(),
                           compute_weight(self.embed.weight,
                                          self.config.dtype))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """LM head in the model dtype, returned as fp32 ``[..., V]`` (under
        tensor parallelism the ranks' vocabulary blocks, all-gathered)."""
        out = F.linear(x, compute_weight(self.head_weight(),
                                         self.config.dtype)).float()
        if self.lm_head is None or self.tp == 1:
            return out
        return comm.all_gather(out, group=self.mesh.group(AXIS_TENSOR),
                               dim=-1)

    def qkv(self, layer: LlamaDecoderLayer, x: torch.Tensor,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x [..., S, H]`` → RoPE'd q ``[..., S, h, d]`` and k, v
        ``[..., S, kv_h, d]``; ``positions [..., S]`` (broadcastable)."""
        c = self.config
        h = self._tp_copy(_rms_norm(x, layer.attn_norm, c.rms_norm_eps))
        shape = x.shape[:-1]
        nh, nkv = self.num_local_heads, self.num_local_kv_heads
        q = layer.proj(layer.q_proj, h).view(*shape, nh, c.hd)
        k = layer.proj(layer.k_proj, h).view(*shape, nkv, c.hd)
        v = layer.proj(layer.v_proj, h).view(*shape, nkv, c.hd)
        return (_rope(q, positions, c.rope_theta),
                _rope(k, positions, c.rope_theta), v)

    def _ffn(self, layer: LlamaDecoderLayer, h: torch.Tensor
             ) -> Tuple[torch.Tensor, AuxLoss]:
        """The FFN over ``h [..., H]``: ``(out, aux loss)``.  Dense SwiGLU
        here (*f* before its column-parallel products), with no aux loss;
        Mixtral routes it through its experts."""
        return layer.ffn(self._tp_copy(h)), 0.0

    def _post_attn(self, layer: LlamaDecoderLayer, x: torch.Tensor,
                   attn: torch.Tensor) -> Tuple[torch.Tensor, AuxLoss]:
        """Output projection + residual + FFN block + residual, and the
        FFN's aux loss; ``attn [..., h, d]`` (this rank's heads)."""
        x = x + self._tp_reduce(layer.proj(layer.o_proj, attn.flatten(-2)))
        h = _rms_norm(x, layer.mlp_norm, self.config.rms_norm_eps)
        out, l_aux = self._ffn(layer, h)
        return x + self._tp_reduce(out), l_aux

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
        shape = (c.num_layers, batch_size, max_len, self.num_local_kv_heads,
                 c.hd)
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

    def _seq(self) -> Tuple[Any, int]:
        """``(the seq group or None, sp)`` of the model's mesh."""
        if self.mesh is None:
            return None, 1
        return seq_group_of(self.mesh)

    def _attention(self, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
        """Causal attention over a whole sequence ``[B, S, h, d]``
        (positions 0 .. S-1): the flash kernels or the plain einsum."""
        c = self.config
        if c.attn_impl == "flash":
            return flash_attention(q, k, v, True, window=c.sliding_window)
        if c.attn_impl in ("xla", "ring"):
            pos = torch.arange(q.shape[1], device=q.device)
            return _attention(q, k, v, local_attention_mask(
                pos, pos, causal=True, window=c.sliding_window))
        raise ValueError(f"attn_impl {c.attn_impl!r} is not ported (use "
                         "'flash', 'xla' or 'ring')")

    def _train_layer(self, layer: LlamaDecoderLayer, x: torch.Tensor,
                     pos: torch.Tensor) -> Tuple[torch.Tensor, AuxLoss]:
        """One decoder layer over ``x [B, S, H]`` (under a ``seq`` axis
        this rank's chunk, ``pos`` its global positions) → ``(x, aux
        loss)``.  GQA K/V are repeated to the query heads before attention
        and before the Ulysses all-to-all, as the JAX model does (the
        gradient of the repeat sums back into the kv heads); the ring
        rotates them at their kv width."""
        c = self.config
        q, k, v = self.qkv(layer, x, pos[None])
        group, sp = self._seq()
        if c.attn_impl == "ring" and sp > 1:
            attn = ring_attention(q, k, v, True, window=c.sliding_window,
                                  group=group)
        else:
            n_rep = c.num_heads // c.num_kv_heads
            k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
            attn = (ulysses_attention(self._attention, q, k, v, group=group,
                                      tp=self.tp)
                    if sp > 1 else self._attention(q, k, v))
        return self._post_attn(layer, x, attn)

    def hidden_states(self, input_ids: torch.Tensor, offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, S]`` ids at positions ``offset ..`` → (final-norm'd
        ``[B, S, H]``, the layers' aux losses summed, fp32), with a
        gradient.  Under ``config.remat`` each layer is recomputed in the
        backward, keeping only its weight matmuls' outputs (the recompute
        re-runs the layer's all-to-alls: every ``seq`` rank issues them in
        the same order, and so does every tensor rank with its *g*)."""
        c = self.config
        pos = offset + torch.arange(input_ids.shape[1], device=self.device)
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

    # -- the layer-streaming protocol (ZeRO-Infinity) ----------------------
    #
    # Counterparts of the JAX model's ``embed_fwd`` (:527), ``decoder_layer``
    # (:358) and ``head_loss`` (:755): pure functions of the weights they
    # are handed, so ``runtime/swap_tensor/infinity_engine.py`` can run one
    # layer at a time on weights streamed from the host.  ``params`` is a
    # dict of the resident leaves by state-dict name (``embed.weight``,
    # ``final_norm``, ``lm_head.weight``); ``layer_params`` one layer's by
    # its local name (``q_proj.weight``, ...).  A layer runs without remat:
    # the streaming engine's backward recomputes it once from its input.
    # Under a ``seq`` axis ``x`` and the batch are this rank's chunk
    # (``_seq_chunk``): the layer runs at the chunk's global positions,
    # with Ulysses (or the ring) inside it, and ``head_loss`` returns the
    # chunk's share of the token mean.

    def embed_fwd(self, params: Dict[str, torch.Tensor],
                  input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids → ``[B, S, H]`` in the compute dtype."""
        return F.embedding(input_ids.long(), compute_weight(
            params["embed.weight"], self.config.dtype))

    def decoder_layer(self, layer_params: Dict[str, torch.Tensor],
                      x: torch.Tensor) -> Tuple[torch.Tensor, AuxLoss]:
        """One decoder layer on ``layer_params`` over ``x [B, S, H]`` →
        ``(x, aux loss)`` (``torch.func.functional_call`` of a layer of the
        model's on the weights handed in)."""
        caller = _LayerCall(self, self.layers[0])
        return torch.func.functional_call(
            caller, {f"layer.{k}": v for k, v in layer_params.items()},
            (x,))

    def head_loss(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                  batch: Any) -> torch.Tensor:
        """The loss tail: the last layer's output → final norm → LM head →
        cross entropy (fp32 scalar); under ``seq`` the chunk's Σ nll over
        the valid count summed over ``seq`` (as :meth:`loss`)."""
        c = self.config
        _, labels = self.batch_labels(batch)
        hidden = _rms_norm(x, params["final_norm"], c.rms_norm_eps)
        head = params["embed.weight" if c.tie_embeddings
                      else "lm_head.weight"]
        total, count = self._nll(head, hidden, labels)
        group, sp = self._seq()
        if sp > 1:
            count = comm.all_reduce(count, group=group)
        return total / count.clamp(min=1)

    def _nll(self, head: torch.Tensor, hidden: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(Σ nll, valid count)`` of the LM head ``head [V, H]`` (cast at
        use) over final-norm'd ``hidden``; tiled over the sequence when
        ``config.loss_tiles`` is above 1 (JAX ``_ce_from_hidden``); the
        vocabulary-parallel loss when the head is this rank's ``V/tp``
        rows."""
        c = self.config
        w = compute_weight(head, c.dtype)
        if self.tp > 1 and not c.tie_embeddings:
            return sequence_tiled_nll(None, hidden, labels, c.loss_tiles,
                                      nll_fn=functools.partial(
                                          self._vocab_parallel_nll, w))

        def logits(h: torch.Tensor) -> torch.Tensor:
            return F.linear(h, w)

        if c.loss_tiles > 1:
            return sequence_tiled_nll(logits, hidden, labels, c.loss_tiles)
        return masked_nll(logits(hidden), labels)

    def _vocab_parallel_nll(self, w: torch.Tensor, hidden: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
        """Σ nll over the valid labels of ``hidden [B, s, H]`` from this
        rank's head rows ``w [V/tp, H]`` (JAX ``head_loss_manual_tp``'s
        ``chunk_nll``): local fp32 logits from *f*(hidden), the max shift
        over ``tensor`` (zero gradient), ``lse = log(g(Σ exp)) + m``, the
        gold logit taken on the rank that owns it and summed by *g*."""
        group = self.mesh.group(AXIS_TENSOR)
        vshard = w.shape[0]
        logits = F.linear(self._tp_copy(hidden), w).float()
        valid = labels != -100
        m = comm.tp_max(logits.max(dim=-1).values, group)
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        lse = torch.log(comm.tp_reduce(se, group)) + m
        off = torch.where(valid, labels, torch.zeros_like(labels)).long() \
            - self.tp_rank * vshard
        mine = (off >= 0) & (off < vshard)
        gold = logits.gather(-1, off.clamp(0, vshard - 1)[..., None])[..., 0]
        gold = comm.tp_reduce(torch.where(mine, gold, torch.zeros_like(gold)),
                              group)
        nll = lse - gold
        return torch.where(valid, nll, torch.zeros_like(nll)).sum()

    def _seq_chunk(self, input_ids: torch.Tensor, labels: torch.Tensor,
                   sp: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """This ``seq`` rank's ``S/sp`` positions of the ids and of the
        labels made from the whole sequence (a chunk's last label is the
        next chunk's first token), and the chunk's first position."""
        c = self.config
        S = input_ids.shape[1]
        if S % sp:
            raise ValueError(f"sequence length {S} not divisible by sp={sp}")
        if c.attn_impl != "ring" and self.num_local_heads % sp:
            heads = (f"num_heads {c.num_heads}" if self.tp == 1 else
                     f"h/tp = {c.num_heads}/{self.tp} = "
                     f"{self.num_local_heads} heads")
            raise ValueError(f"{heads} not divisible by sp={sp}: Ulysses "
                             "gives each seq rank a share of them; use "
                             "attn_impl='ring'")
        n = S // sp
        lo = self.mesh.axis_rank(AXIS_SEQ) * n
        return input_ids[:, lo:lo + n], labels[:, lo:lo + n], lo

    def loss(self, batch: Any) -> torch.Tensor:
        """Next-token cross entropy plus ``aux_loss_coef`` times the summed
        router aux losses (fp32 scalar), with a gradient.  ``batch`` holds
        whole rows; under a ``seq`` axis this rank's share: its chunk's Σ
        nll over the valid labels of the whole sequence (the count summed
        over ``seq``, without a gradient), and ``1/sp`` of the aux losses,
        which are the global micro-batch's and equal on every ``seq``
        rank: the engine sums the shares over ``seq``, so the aux loss
        counts once in the loss and its gradient, as JAX's one ``l_aux``
        of the global micro-batch does."""
        input_ids, labels = self.batch_labels(batch)
        group, sp = self._seq()
        offset = 0
        if sp > 1:
            input_ids, labels, offset = self._seq_chunk(input_ids, labels,
                                                        sp)
        hidden, aux = self.hidden_states(input_ids, offset)
        total, count = self._nll(self.head_weight(), hidden, labels)
        if sp > 1:
            count = comm.all_reduce(count, group=group)
        return (total / count.clamp(min=1)
                + self.config.aux_loss_coef * aux / sp)


class _LayerCall(nn.Module):
    """``forward(x)``: the model's training layer on ``layer`` (whose
    weights ``functional_call`` swaps in) at ``x``'s global positions: from
    0, or under a ``seq`` axis from this rank's chunk's first."""

    def __init__(self, model: LlamaModel, layer: LlamaDecoderLayer):
        super().__init__()
        self.layer = layer
        object.__setattr__(self, "_model", model)  # not a submodule

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, AuxLoss]:
        model, n = self._model, x.shape[1]
        _, sp = model._seq()
        lo = model.mesh.axis_rank(AXIS_SEQ) * n if sp > 1 else 0
        pos = lo + torch.arange(n, device=x.device)
        return model._train_layer(self.layer, x, pos)
