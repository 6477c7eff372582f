"""Ulysses / ALST sequence parallelism over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/runtime/sequence_parallel/ulysses_sp.py``
(arXiv 2309.14509 / 2506.13996): activations stay cut along the sequence
everywhere except in attention; there an all-to-all over the ``seq`` group
turns a rank's ``[B, S/sp, h, d]`` chunk into the full sequence on ``h/sp``
heads, the attention runs on those heads, and a second all-to-all turns
the result back.  The JAX package writes the exchanges as
``jax.lax.all_to_all`` inside a ``shard_map``; here each is
``comm.all_to_all_in_graph``, an autograd Function whose backward is the
inverse exchange (the reference's ``_SeqAllToAll``).  Tiled compute (the
MLP, the logits and the loss chunked over the sequence) recomputes each
chunk in the backward with ``torch.utils.checkpoint`` where JAX has
``lax.scan`` and ``jax.checkpoint``, so activation memory is one tile's.

Also here: the dataloader adapter that hands each ``seq`` rank its slice
of every batch, and the registration facade with the reference's
classmethod signature.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ...comm import comm
from ...parallel.mesh import AXIS_SEQ
from ...utils import groups as groups_mod

Tensor = torch.Tensor


def seq_group_of(mesh: Any = None, group: Any = None) -> Tuple[Any, int]:
    """``(the seq group or None, its size)``: ``group`` when given, else
    ``mesh``'s ``seq`` axis (default: the active mesh; none means sp 1)."""
    if group is not None:
        return group, comm.get_world_size(group)
    mesh = mesh if mesh is not None else groups_mod.current_mesh()
    sp = int(mesh.shape.get(AXIS_SEQ, 1)) if mesh is not None else 1
    return (mesh.group(AXIS_SEQ) if sp > 1 else None), sp


def ulysses_attention(attn_fn: Callable[[Tensor, Tensor, Tensor], Tensor],
                      q: Tensor, k: Tensor, v: Tensor, mesh: Any = None,
                      group: Any = None, tp: int = 1) -> Tensor:
    """All-to-all seq↔heads around ``attn_fn`` (the Ulysses core).

    ``q, k, v``: this rank's ``[B, S/sp, h, d]`` chunks (K/V at the query
    heads: GQA is repeated first).  ``attn_fn`` receives the full sequence
    on ``h/sp`` heads, contiguous, and must be position-exact over it.  The
    ``seq`` group is ``group``, else ``mesh``'s (default: the active
    mesh); at sp 1 this is ``attn_fn(q, k, v)``.  Under tensor
    parallelism (``tp`` above 1) ``q`` holds the rank's ``h/tp`` heads and
    each ``seq`` rank attends ``h/(tp·sp)`` of them."""
    group, sp = seq_group_of(mesh, group)
    if sp == 1:
        return attn_fn(q, k, v)
    if q.shape[2] % sp:
        heads = (f"{q.shape[2]} heads" if tp == 1 else
                 f"h/tp = {q.shape[2] * tp}/{tp} = {q.shape[2]} heads")
        raise ValueError(f"{heads} do not split over sp={sp}: Ulysses "
                         "gives each seq rank a share of them; use "
                         "attn_impl='ring'")

    def exchange(t: Tensor, split_axis: int, concat_axis: int) -> Tensor:
        return comm.all_to_all_in_graph(t, group, split_axis=split_axis,
                                        concat_axis=concat_axis).contiguous()

    # local [B, S/sp, h, d] -> [B, S, h/sp, d], and back after attention
    out = attn_fn(*(exchange(t, 2, 1) for t in (q, k, v)))
    return exchange(out, 1, 2)


# -- tiled compute (ALST memory reducers) -------------------------------------

class SequenceTiledCompute:
    """Chunk a sequence-wise function over ``tiles`` pieces, each
    recomputed in the backward: activation memory becomes one tile's (the
    reference's ``SequenceTiledCompute`` autograd function)."""

    @staticmethod
    def apply(fn: Callable[[Tensor], Tensor], x: Tensor, tiles: int,
              seq_axis: int = 1) -> Tensor:
        if tiles <= 1:
            return fn(x)
        S = x.shape[seq_axis]
        if S % tiles:
            raise ValueError(f"seq len {S} not divisible by tiles={tiles}")
        return torch.cat([checkpoint(fn, xt, use_reentrant=False)
                          for xt in x.chunk(tiles, dim=seq_axis)],
                         dim=seq_axis)


class TiledMLP:
    """Sequence-tiled token-wise function (an MLP block, a norm + MLP
    residual...): the reference's ``TiledMLP``."""

    @staticmethod
    def apply(mlp_fn: Callable[[Tensor], Tensor], x: Tensor,
              tiles: int) -> Tensor:
        return SequenceTiledCompute.apply(mlp_fn, x, tiles, seq_axis=1)


def _tile_nll(logits_fn: Callable[[Tensor], Tensor], h: Tensor,
              labels: Tensor) -> Tensor:
    """Σ nll over one tile's valid labels, from its fp32 logits."""
    logits = logits_fn(h).float()
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum()


def sequence_tiled_nll(logits_fn: Optional[Callable[[Tensor], Tensor]],
                       hidden: Tensor, labels: Tensor, tiles: int,
                       nll_fn: Optional[Callable[[Tensor, Tensor], Tensor]]
                       = None) -> Tuple[Tensor, Tensor]:
    """``(Σ nll, valid count)`` of the labels (-100 ignored) over
    ``hidden [B, S, H]``, the logits formed one tile of ``S/tiles`` positions
    at a time and recomputed in the backward: the full ``[B, S, V]`` logits
    never exist.  ``S % tiles`` falls back to one tile.  The count carries
    no gradient; under sequence parallelism the model sums it over ``seq``
    before dividing.  ``nll_fn(h, labels)``, when given, is a tile's Σ nll
    in place of ``logits_fn``'s softmax (the vocabulary-parallel loss)."""
    S = hidden.shape[1]
    if tiles <= 1 or S % tiles:
        tiles = 1
    fn = nll_fn if nll_fn is not None else functools.partial(_tile_nll,
                                                             logits_fn)
    total = hidden.new_zeros((), dtype=torch.float32)
    for h, lab in zip(hidden.chunk(tiles, dim=1), labels.chunk(tiles, dim=1)):
        total = total + checkpoint(fn, h, lab, use_reentrant=False)
    return total, (labels != -100).sum()


def sequence_tiled_loss(logits_fn: Callable[[Tensor], Tensor], hidden: Tensor,
                        labels: Tensor, tiles: int) -> Tensor:
    """Tiled final projection + cross entropy: the masked token mean
    (fp32), never holding more than one tile's ``[B, S/tiles, V]``
    logits."""
    total, count = sequence_tiled_nll(logits_fn, hidden, labels, tiles)
    return total / count.clamp(min=1)


# -- dataloader adapter and registration ---------------------------------------

class UlyssesSPDataLoaderAdapter:
    """Hand each ``seq`` rank its sequence slice of every batch: every
    tensor (or array) of two or more dims is cut along dim 1 into
    ``sp_world_size`` chunks and chunk ``sp_rank`` kept.  ``sp_rank`` and
    ``sp_world_size`` default to ``sp_group``'s (else the mesh's ``seq``
    axis); ``device`` is recorded, as in the reference."""

    def __init__(self, dl: Any, sp_rank: Optional[int] = None,
                 sp_group: Any = None, sp_world_size: Optional[int] = None,
                 device: Any = None):
        self.dl = dl
        if sp_world_size is None:
            sp_world_size = (
                comm.get_world_size(sp_group) if sp_group is not None
                else groups_mod.get_sequence_parallel_world_size())
        if sp_rank is None:
            sp_rank = (comm.get_rank(sp_group) if sp_group is not None
                       else groups_mod.get_sequence_parallel_rank())
        self.sp_world_size, self.sp_rank = int(sp_world_size), int(sp_rank)
        self.device = device

    def _slice(self, x: Any) -> Any:
        if isinstance(x, dict):
            return {k: self._slice(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self._slice(v) for v in x)
        if getattr(x, "ndim", 0) < 2:
            return x
        S = x.shape[1]
        if S % self.sp_world_size:
            raise ValueError(
                f"sequence length {S} not divisible by sp={self.sp_world_size}")
        chunk = S // self.sp_world_size
        return x[:, self.sp_rank * chunk:(self.sp_rank + 1) * chunk]

    def __iter__(self) -> Iterator[Any]:
        for batch in self.dl:
            yield self._slice(batch)

    def __len__(self) -> int:
        return len(self.dl)


class _MPU:
    """The three sequence-parallel getters accelerate and HF consume."""

    get_sequence_parallel_group = staticmethod(
        groups_mod.get_sequence_parallel_group)
    get_sequence_parallel_world_size = staticmethod(
        groups_mod.get_sequence_parallel_world_size)
    get_sequence_parallel_rank = staticmethod(
        groups_mod.get_sequence_parallel_rank)


class UlyssesSPAttentionHF:
    """Registration facade with the reference's classmethod signature.

    The reference patches HF's torch attention; the port's models run
    Ulysses themselves (``LlamaModel`` on a mesh with a ``seq`` axis), so
    this checks the geometry against the mesh and returns an ``mpu`` with
    the three getters (None at sp 1)."""

    @classmethod
    def register_with_transformers(cls, model_name_or_path: Any = None,
                                   core_attn_implementation: str = "sdpa",
                                   sequence_parallel_size: int = 1,
                                   max_length: Optional[int] = None,
                                   micro_batch_size: int = 1,
                                   seq_length_is_variable: bool = True,
                                   **_kwargs: Any) -> Optional[_MPU]:
        if sequence_parallel_size == 1:
            return None
        sp = groups_mod.get_layout().sp
        if sp != sequence_parallel_size:
            raise ValueError(
                f"mesh seq axis is {sp}, requested sp={sequence_parallel_size};"
                " build the mesh with the matching MeshLayout first")
        if max_length and max_length % sp:
            raise ValueError(f"max_length {max_length} not divisible by sp={sp}")
        return _MPU()
