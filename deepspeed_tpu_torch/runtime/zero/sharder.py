"""ZeRO placement: which leaves are cut over the data-parallel ranks, and
the collectives that cut, gather and reduce them.

Counterpart of ``deepspeed_tpu/runtime/zero/sharder.py``.  The JAX package
states ZeRO as sharding annotations that GSPMD lowers to collectives; the
port runs one process per rank, so a placement is explicit: leaf *i* is cut
into ``dp`` equal contiguous chunks along dim *d*, rank *r* holding chunk
*r*, or it is replicated.  The rule is the JAX one
(:func:`dp_shardable_dim`, ``ZeroShardingPolicy._shard_spec_for_shape``):
the largest dim divisible by ``dp`` (ties to the earliest); a leaf of at
most ``stage3_param_persistence_threshold`` elements, or with no divisible
dim, stays replicated.  What a stage cuts:

    stage 0: nothing; gradients all-reduced.
    stage 1: the optimizer state (Adam's m and v) of every cut leaf.
    stage 2: + its fp32 gradient, reduce-scattered as it forms.
    stage 3: + its fp32 master, gathered (in the compute dtype) where the
             model reads it, by :func:`compute_weight`.

:class:`Placement` cuts one rank's chunk and all-gathers or
reduce-scatters along its dim over its group; :func:`all_reduce_flat` and
:func:`all_gather_flat` issue one collective per bucket of
``reduce_bucket_size`` elements rather than one per leaf.

Expert leaves (a Mixtral's expert stacks, marked ``ds_expert`` with their
:class:`ExpertShard`): each expert coordinate holds other experts, so the
base placement already occupies the ``expert`` axis and ZeRO takes the
free DP axis alone, ``data`` (JAX ``_shard_spec_for_shape``: "never reuse
a mesh axis the base already occupies"): such a leaf is cut over the
``data`` group on its largest divisible dim and its gradient is reduced
over that group; every other leaf over the whole data-parallel group.  The
persistence threshold counts the whole leaf, all experts.

Tensor-parallel leaves (marked ``ds_tensor`` with their
:class:`TensorShard`): the tensor axis already cuts one dim, which ZeRO
leaves alone (JAX: the base spec's dim is taken); ZeRO cuts the rank's
block over the data-parallel group of its tensor coordinate, the
threshold counting the whole leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ...comm import comm
from ..config import ZeroConfig

Tensor = torch.Tensor


def dp_shardable_dim(shape: Tuple[int, ...], dp_size: int,
                     taken: Optional[Sequence[Optional[Any]]] = None
                     ) -> Optional[int]:
    """The placement rule: the largest free dim of ``shape`` divisible by
    ``dp_size`` (ties to the earliest), or None when nothing divides (the
    leaf replicates).  ``taken`` marks dims another placement already
    occupies (JAX ``dp_shardable_dim``)."""
    if dp_size <= 1 or not shape:
        return None
    entries = list(taken) if taken is not None else [None] * len(shape)
    entries += [None] * (len(shape) - len(entries))
    candidates = [(dim, i) for i, dim in enumerate(shape)
                  if entries[i] is None and dim % dp_size == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda t: (t[0], -t[1]))[1]


def reshard_layout_report(state_shapes: Sequence[Sequence[Any]],
                          dp_size: int) -> Dict[str, Any]:
    """Which of ``[name, shape]`` pairs the rule would cut at ``dp_size``
    and which would replicate (JAX ``reshard_layout_report``)."""
    sharded: List[str] = []
    replicated: List[str] = []
    for entry in state_shapes or []:
        name, shape = str(entry[0]), tuple(int(d) for d in entry[1])
        (sharded if dp_shardable_dim(shape, dp_size) is not None
         else replicated).append(name)
    return {"dp_size": int(dp_size), "sharded": sharded,
            "replicated": replicated, "sharded_count": len(sharded),
            "replicated_count": len(replicated)}


@dataclasses.dataclass(frozen=True)
class ZeroShardingPolicy:
    """A stage's placement of parameter, gradient and optimizer-state
    leaves over ``dp_size`` ranks: each ``*_dim`` is the dim that leaf is
    cut along, or None (replicated)."""

    stage: int
    dp_size: int
    persistence_threshold: int = 0

    @classmethod
    def from_config(cls, config: ZeroConfig,
                    dp_size: int) -> "ZeroShardingPolicy":
        return cls(stage=int(config.stage), dp_size=int(dp_size),
                   persistence_threshold=config.persistence_threshold)

    def shard_dim(self, shape: Tuple[int, ...],
                  numel: Optional[int] = None,
                  taken: Optional[int] = None) -> Optional[int]:
        """The dim a cut leaf of ``shape`` is cut along (any stage);
        ``numel``: the whole leaf's elements, when ``shape`` is one
        expert or tensor shard of it; ``taken``: a dim the tensor axis
        already cuts."""
        n = numel if numel is not None else math.prod(int(d) for d in shape)
        if self.dp_size <= 1 or not shape or n <= self.persistence_threshold:
            return None
        mask = None if taken is None else [
            "tensor" if i == taken else None for i in range(len(shape))]
        return dp_shardable_dim(tuple(shape), self.dp_size, mask)

    def param_dim(self, shape: Tuple[int, ...],
                  numel: Optional[int] = None,
                  taken: Optional[int] = None) -> Optional[int]:
        return self.shard_dim(shape, numel, taken) if self.stage >= 3 \
            else None

    def grad_dim(self, shape: Tuple[int, ...],
                 numel: Optional[int] = None,
                 taken: Optional[int] = None) -> Optional[int]:
        return self.shard_dim(shape, numel, taken) if self.stage >= 2 \
            else None

    def opt_state_dim(self, shape: Tuple[int, ...],
                      numel: Optional[int] = None,
                      taken: Optional[int] = None) -> Optional[int]:
        return self.shard_dim(shape, numel, taken) if self.stage >= 1 \
            else None


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """An expert stack's place on the ``expert`` axis: block ``rank`` of
    ``ep`` along dim 0 (the experts) of the whole stack."""

    ep: int
    rank: int

    def full_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole stack's shape, every expert."""
        return (int(shape[0]) * self.ep,) + tuple(int(d) for d in shape[1:])


def expert_of(t: Tensor) -> Optional[ExpertShard]:
    """The expert shard of an expert stack (None for any other leaf)."""
    return getattr(t, "ds_expert", None)


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A leaf's place on the ``tensor`` axis: block ``rank`` of ``tp``
    along ``dim`` of the whole leaf."""

    dim: int
    tp: int
    rank: int

    def full_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole leaf's shape, every tensor rank's block."""
        out = [int(d) for d in shape]
        out[self.dim] *= self.tp
        return tuple(out)


def tensor_of(t: Tensor) -> Optional[TensorShard]:
    """The tensor shard of a leaf split over the ``tensor`` axis (None for
    a leaf every tensor rank holds whole)."""
    return getattr(t, "ds_tensor", None)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf of ``full_shape`` cut into ``dp`` equal chunks along ``dim``
    over ``group``; this process holds chunk ``rank``."""

    dim: int
    dp: int
    rank: int
    full_shape: Tuple[int, ...]
    group: Any = None

    @classmethod
    def of(cls, shape: Tuple[int, ...], dim: int, group: Any
           ) -> "Placement":
        return cls(dim=dim, dp=comm.get_world_size(group),
                   rank=comm.get_rank(group), full_shape=tuple(shape),
                   group=group)

    @property
    def chunk_shape(self) -> Tuple[int, ...]:
        s = list(self.full_shape)
        s[self.dim] //= self.dp
        return tuple(s)

    def view(self, full: Tensor) -> Tensor:
        """This rank's chunk of ``full``, a view (strided unless ``dim`` is
        the outermost dim of size above 1)."""
        n = self.full_shape[self.dim] // self.dp
        return full.narrow(self.dim, self.rank * n, n)

    def cut(self, full: Tensor) -> Tensor:
        """This rank's chunk of ``full`` as a tensor of its own."""
        return self.view(full).clone(memory_format=torch.contiguous_format)

    def gather(self, chunk: Tensor) -> Tensor:
        """Every rank's chunk, concatenated along ``dim``: the full leaf."""
        return comm.all_gather(chunk, group=self.group, dim=self.dim)

    def reduce_scatter(self, full: Tensor) -> Tensor:
        """``full`` summed over the group; this rank's chunk of the sum."""
        return comm.reduce_scatter(full, group=self.group, dim=self.dim)


def placement_of(t: Tensor) -> Optional[Placement]:
    """The placement of a parameter cut under ZeRO-3 (None when whole)."""
    return getattr(t, "ds_placement", None)


def refuse_cut(module: torch.nn.Module, what: str) -> None:
    """Raise when ``module`` holds ZeRO-3 chunks: ``what`` (a serving
    engine) computes on whole weights."""
    cut = [n for n, p in module.named_parameters()
           if placement_of(p) is not None]
    if cut:
        raise ValueError(
            f"{what}: {len(cut)} parameters of the model ({cut[0]}, ...) "
            "are ZeRO-3 chunks; build the engine inside `with deepspeed_"
            "tpu_torch.zero.GatheredParameters(model.parameters()):` "
            "or from a model built whole")


class _GatherWeight(torch.autograd.Function):
    """Forward: this rank's fp32 chunk, cast to the compute dtype, then
    all-gathered along its dim.  Backward: the weight's gradient in fp32,
    reduce-scattered (summed over the ranks) into the chunk's gradient."""

    @staticmethod
    def forward(ctx, chunk: Tensor, place: Placement,
                dtype: torch.dtype) -> Tensor:
        ctx.place = place
        return place.gather(chunk.to(dtype))

    @staticmethod
    def backward(ctx, grad: Tensor):
        return ctx.place.reduce_scatter(grad.float()), None, None


def compute_weight(w: Tensor, dtype: torch.dtype) -> Tensor:
    """The model's one read of a weight: ``w`` cast to ``dtype``, or, for
    a chunk cut under ZeRO-3, the whole weight gathered in ``dtype``
    (every rank must read its weights in the same order)."""
    place = placement_of(w)
    if place is None:
        return w.to(dtype)
    return _GatherWeight.apply(w, place, dtype)


def _buckets(numels: Sequence[int], limit: int) -> Iterator[List[int]]:
    """Consecutive index lists of at most ``limit`` elements (a larger
    tensor alone)."""
    out: List[int] = []
    size = 0
    for i, n in enumerate(numels):
        if out and size + n > limit:
            yield out
            out, size = [], 0
        out.append(i)
        size += n
    if out:
        yield out


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[Tensor], group: Any,
                    bucket_elements: int) -> None:
    """Sum each tensor over ``group`` in place, flattened into buckets of
    at most ``bucket_elements`` elements of one dtype: one all-reduce a
    bucket."""
    by_dtype: Dict[torch.dtype, List[Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        for idx in _buckets([t.numel() for t in ts], bucket_elements):
            part = [ts[i] for i in idx]
            flat = torch.cat([t.reshape(-1) for t in part])
            comm.all_reduce(flat, group=group)
            for t, r in zip(part, flat.split([t.numel() for t in part])):
                t.copy_(r.view_as(t))


@torch.no_grad()
def all_gather_flat(chunks: Sequence[Tensor], places: Sequence[Placement],
                    outs: Sequence[Tensor], bucket_elements: int) -> None:
    """Write every rank's chunks into the full tensors ``outs``: the
    chunks (fp32) of each placement group flattened into buckets of at
    most ``bucket_elements`` elements, one all-gather a bucket, each leaf
    then reassembled along its placement's dim."""
    by_group: Dict[Any, List[int]] = {}
    for i, place in enumerate(places):
        by_group.setdefault(place.group, []).append(i)
    for members in by_group.values():
        dp, group = places[members[0]].dp, places[members[0]].group
        for idx in _buckets([chunks[i].numel() for i in members],
                            bucket_elements):
            idx = [members[j] for j in idx]
            flat = torch.cat([chunks[i].reshape(-1) for i in idx])
            got = comm.all_gather(flat, group=group).view(dp, -1)
            off = 0
            for i in idx:
                n, place = chunks[i].numel(), places[i]
                parts = got[:, off:off + n].reshape((dp,) + place.chunk_shape)
                outs[i].copy_(torch.cat(parts.unbind(0), dim=place.dim))
                off += n
