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

ZeRO++ (JAX ``runtime/zero/qwz.py``, ``qgz.py`` and the hpZ branch of
``ZeroShardingPolicy``): under qwZ a parameter carries its
``qwz.QwzAxis`` (``ds_qwz``) and :func:`compute_weight` reads it through
the int8 round trip, straight-through; at stage 3 :class:`_GatherWeight`
gathers the int8 codes and the fp32 scales.  A chunk that cuts a group
takes the group's amax from a max all-reduce of the chunks' partial
amaxes (a small fp32 vector, which then gives every rank every scale)
before it makes its codes, so the weights equal JAX's, which quantizes
the whole leaf.  hpZ (``zero_hpz_partition_size``, stage 3): the master
of a cut leaf is cut over the ``data`` group alone (``hpz`` ranks), its
gradient and optimizer state over the whole data-parallel group (``dp``
ranks), each rank's ``1/dp`` piece inside its ``1/hpz`` chunk (a
:class:`Placement` with an ``order``); JAX cuts its parameters over
``data`` and the rest over ``(expert, data)``, which do not nest, but the
placement is the port's own and the numbers do not depend on it.  A
parameter's ``ds_grad_sink`` (set by the engine under hpZ and qgZ)
receives the whole fp32 gradient of its gathered weight in place of the
reduce-scatter into ``.grad``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...comm import comm
from ..config import ZeroConfig
from .qwz import (QwzAxis, codes_of, dequant_runs, group_amax, qwz,
                  quant_runs, scales_of)

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
    #: hpZ: the ranks a stage-3 master is cut over (the ``data`` axis);
    #: 1 when it is cut over all ``dp_size``
    hpz: int = 1

    @classmethod
    def from_config(cls, config: ZeroConfig, dp_size: int,
                    data_size: Optional[int] = None
                    ) -> "ZeroShardingPolicy":
        """The stage's policy over ``dp_size`` ranks; ``data_size``: the
        mesh's ``data`` axis, which ``zero_hpz_partition_size`` above 1
        must equal at stage 3 (JAX ``from_config``)."""
        hpz = int(config.zero_hpz_partition_size or 1)
        if hpz > 1 and int(config.stage) >= 3:
            inner = int(dp_size if data_size is None else data_size)
            if hpz != inner:
                raise ValueError(
                    f"zero_hpz_partition_size={hpz} must equal the inner "
                    f"'data' mesh axis size ({inner}) — the secondary "
                    "partition maps onto the ICI-local axis (lay the mesh "
                    "out so data=hpz and expert carries the rest of DP)")
        else:
            hpz = 1
        return cls(stage=int(config.stage), dp_size=int(dp_size),
                   persistence_threshold=config.persistence_threshold,
                   hpz=hpz if hpz < dp_size else 1)

    @property
    def secondary(self) -> bool:
        """hpZ is on and differs from plain stage 3 (``hpz < dp``)."""
        return self.hpz > 1

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
    #: the chunk each group rank holds (None: group rank ``r`` holds chunk
    #: ``r``); ``rank`` is this process's chunk
    order: Optional[Tuple[int, ...]] = None

    @classmethod
    def of(cls, shape: Tuple[int, ...], dim: int, group: Any,
           order: Optional[Sequence[int]] = None) -> "Placement":
        r = comm.get_rank(group)
        return cls(dim=dim, dp=comm.get_world_size(group),
                   rank=r if order is None else int(order[r]),
                   full_shape=tuple(shape), group=group,
                   order=None if order is None else tuple(order))

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
        full = comm.all_gather(chunk, group=self.group, dim=self.dim)
        if self.order is None:
            return full
        parts = full.chunk(self.dp, dim=self.dim)
        by_chunk = sorted(range(self.dp), key=self.order.__getitem__)
        return torch.cat([parts[r] for r in by_chunk], dim=self.dim)

    def reduce_scatter(self, full: Tensor) -> Tensor:
        """``full`` summed over the group; this rank's chunk of the sum."""
        if self.order is not None:
            parts = full.chunk(self.dp, dim=self.dim)
            full = torch.cat([parts[k] for k in self.order], dim=self.dim)
        return comm.reduce_scatter(full, group=self.group, dim=self.dim)

    def offset_in(self, outer: "Placement") -> int:
        """Where this chunk starts along ``dim`` inside ``outer``'s chunk
        (the same leaf and dim, ``outer`` cut coarser)."""
        n, m = (self.full_shape[self.dim] // self.dp,
                self.full_shape[self.dim] // outer.dp)
        off = self.rank * n - outer.rank * m
        if self.dim != outer.dim or not 0 <= off <= m - n:
            raise ValueError("the chunk does not lie inside the outer one")
        return off


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


def _qwz_gather(chunk: Tensor, place: Placement, dtype: torch.dtype,
                axis: QwzAxis) -> Tensor:
    """The whole weight in ``dtype`` after the int8 round trip, gathered as
    int8 codes: this rank's chunk cast to ``dtype`` and to fp32 and
    quantized in JAX's groups (runs of ``axis.run`` along ``axis.dim``);
    the codes all-gathered along the chunk's dim, and the scales too,
    unless the chunk cuts a group: then the groups' amaxes are max-reduced
    over the ranks first (every rank then holds every scale)."""
    d, c, run = axis.dim, place.dim, axis.run
    x = chunk.to(dtype).float().movedim(d, -1)
    if c != d or x.shape[-1] % run == 0:
        q, s = quant_runs(x, run)
        # the scales' dim that the chunk cuts, in the moved layout
        sdim = -1 if c == d else (c if c < d else c - 1)
        s_full = comm.all_gather(s, group=place.group, dim=sdim)
    else:
        n = x.shape[-1]
        lo = place.rank * n
        g0, g1 = lo // run, (lo + n - 1) // run
        left = lo - g0 * run
        g = F.pad(x, (left, (g1 + 1) * run - lo - n)).reshape(
            *x.shape[:-1], g1 - g0 + 1, run)
        amax = x.new_zeros(*x.shape[:-1], place.full_shape[c] // run)
        amax[..., g0:g1 + 1] = group_amax(g)
        comm.all_reduce(amax, comm.ReduceOp.MAX, group=place.group)
        s_full = scales_of(amax)
        q = codes_of(g, s_full[..., g0:g1 + 1, None]).reshape(
            *x.shape[:-1], -1)[..., left:left + n]
    q_full = place.gather(q.movedim(-1, d).contiguous())
    return dequant_runs(q_full.movedim(d, -1), s_full, run).movedim(
        -1, d).to(dtype)


class _GatherWeight(torch.autograd.Function):
    """Forward: this rank's fp32 chunk, cast to the compute dtype, then
    all-gathered along its dim (under qwZ as int8 codes and scales,
    :func:`_qwz_gather`).  Backward (straight-through under qwZ): the
    weight's gradient in fp32, reduce-scattered (summed over the ranks)
    into the chunk's gradient, or handed whole to the parameter's
    ``ds_grad_sink``."""

    @staticmethod
    def forward(ctx, chunk: Tensor, place: Placement, dtype: torch.dtype,
                axis: Optional[QwzAxis], sink: Any) -> Tensor:
        ctx.place, ctx.sink = place, sink
        if axis is not None:
            return _qwz_gather(chunk, place, dtype, axis)
        return place.gather(chunk.to(dtype))

    @staticmethod
    def backward(ctx, grad: Tensor):
        g = grad.float()
        if ctx.sink is not None:
            ctx.sink(g)
            return None, None, None, None, None
        return ctx.place.reduce_scatter(g), None, None, None, None


def compute_weight(w: Tensor, dtype: torch.dtype) -> Tensor:
    """The model's one read of a weight: ``w`` cast to ``dtype``, or, for
    a chunk cut under ZeRO-3, the whole weight gathered in ``dtype``
    (every rank must read its weights in the same order); under qwZ
    through the int8 round trip."""
    place, axis = placement_of(w), getattr(w, "ds_qwz", None)
    if place is None:
        out = w.to(dtype)
        return out if axis is None else qwz(out, axis)
    return _GatherWeight.apply(w, place, dtype, axis,
                               getattr(w, "ds_grad_sink", None))


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
