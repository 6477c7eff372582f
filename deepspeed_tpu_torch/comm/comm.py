"""Communication verbs over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` (the reference's
``deepspeed/comm/comm.py``): ``init_distributed`` with the launcher's
environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), the rank queries, ``ReduceOp`` and the eager verbs
``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all_single``,
``broadcast``, ``barrier`` and ``new_group``, and the two collectives the
sequence-parallel layers differentiate through: ``all_to_all_in_graph``
(the Ulysses all-to-all, tiled, along any split and concat axes) and
``ppermute`` (the ring's send/receive pairs), each a
``torch.autograd.Function`` whose backward is the inverse exchange, and
the three that tensor-parallel training differentiates through, Megatron's
*f* and *g* and the vocabulary max (JAX ``models/llama.py`` ``_tp_copy``
:137, ``_tp_reduce`` :160, ``_tp_max`` :184): ``tp_copy`` (identity
forward, the gradient summed over the group), ``tp_reduce`` (the sum
forward, the gradient as it is) and ``tp_max`` (the max forward, a zero
gradient), and AutoTP's two for a split layer without its partner
(``runtime/tensor_parallel.auto_tp``): ``tp_gather`` (a column-parallel
output all-gathered, the backward taking the rank's block) and
``tp_split`` (the rank's block of a whole input, the backward
all-gathering the gradient).  The
JAX package's verbs run XLA collectives over a mesh of one controller;
here every rank is a process and a verb is a ``torch.distributed``
collective over a process group.  A ``group`` is a
``torch.distributed`` group, ``None`` for the whole world, or the name of
a mesh axis (or a tuple of them), resolved through
:mod:`deepspeed_tpu_torch.utils.groups`.

Backends: ``dist_backend`` defaults to ``"nccl"`` on the card and
``"gloo"`` on the CPU, as DeepSpeed takes its accelerator's backend.
``"gloo"`` on CUDA tensors happens only when the caller names it (several
ranks sharing one card, where NCCL refuses); gloo's CUDA support covers
only some collectives and dtypes and goes through the host anyway, so
every verb on a CUDA tensor over a gloo group copies it through pinned
host memory itself.  Asking for NCCL with two ranks on one card raises;
nothing switches backends on its own.

:func:`wire_counts` counts the bytes each collective covers, by verb and
dtype, since :func:`reset_wire` (never for a group of one): the result of
an all-gather, the input of a reduce-scatter and of an all-to-all, the
tensor of a broadcast and of a ppermute's send, and twice the tensor of
an all-reduce (a ring's reduce-scatter and all-gather, the fp32 count of
JAX's ``qgz.wire_bytes``).  The comms logger, the census and
``monitored_barrier`` are not ported yet.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

GroupLike = Union[None, str, Tuple[str, ...], Any]


class ReduceOp:
    """The reference's reduce-op names (strings, as in the JAX package)."""
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


_WIRE: Dict[str, int] = {}


def _count(verb: str, tensor: torch.Tensor, group: Any,
           times: int = 1) -> None:
    if dist.get_world_size(group) > 1:
        key = f"{verb}/{str(tensor.dtype).replace('torch.', '')}"
        _WIRE[key] = _WIRE.get(key, 0) + times * tensor.numel() \
            * tensor.element_size()


def wire_counts() -> Dict[str, int]:
    """Bytes by ``"verb/dtype"`` since the last :func:`reset_wire`."""
    return dict(_WIRE)


def reset_wire() -> None:
    _WIRE.clear()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[float] = None,
                     device: DeviceLike = "cuda") -> None:
    """Join the process group (a no-op when already joined).  The world
    size and rank default to ``WORLD_SIZE`` / ``RANK`` (1 and 0 when
    unset); the rendezvous to ``tcp://MASTER_ADDR:MASTER_PORT``, or an
    in-process store for a world of one.  On the card under NCCL each rank
    takes card ``LOCAL_RANK``.  ``timeout`` (seconds) bounds every
    collective."""
    if is_initialized():
        return
    dev = resolve_device(device)
    backend = dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend {backend!r}: use 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("dist_backend='nccl' needs device='cuda'")
    world = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    local_rank = get_local_rank()
    if backend == "nccl":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL needs one card per rank: local rank {local_rank} but "
                f"{torch.cuda.device_count()} card(s) visible; ranks that "
                "share a card need dist_backend='gloo'")
        torch.cuda.set_device(local_rank)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if init_method is None and "MASTER_ADDR" not in os.environ and world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        if init_method is None:
            init_method = (f"tcp://{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                           f":{os.environ.get('MASTER_PORT', '29500')}")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **kw)
    if backend == "nccl":
        _refuse_shared_cards()


def _refuse_shared_cards() -> None:
    """Raise on every rank when two NCCL ranks hold the same card (NCCL
    itself fails later, at the first collective, with "Duplicate GPU")."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    card = (socket.gethostname(), str(getattr(props, "uuid",
                                              torch.cuda.current_device())))
    cards = [None] * dist.get_world_size()
    host_group = dist.new_group(backend="gloo")
    dist.all_gather_object(cards, card, group=host_group)
    dist.destroy_process_group(host_group)
    if len(set(cards)) < len(cards):
        dist.destroy_process_group()
        raise RuntimeError(
            "NCCL needs one card per rank, but ranks share a card "
            f"({cards}); pass dist_backend='gloo' to run them over the host")


def get_rank(group: GroupLike = None) -> int:
    """This process's rank in ``group`` (the world by default); 0 before
    ``init_distributed``."""
    if not is_initialized():
        return 0
    return dist.get_rank(_resolve(group))


def get_world_size(group: GroupLike = None) -> int:
    if not is_initialized():
        return 1
    return dist.get_world_size(_resolve(group))


def new_group(axes: Sequence[str]) -> Any:
    """The process group over the mesh ``axes`` that holds this rank
    (every rank calls it alike; built once, then cached on the mesh)."""
    from ..utils import groups
    return groups.axes_group(tuple(axes))


def _resolve(group: GroupLike) -> Any:
    if isinstance(group, (str, tuple)):
        axes = (group,) if isinstance(group, str) else group
        from ..utils import groups
        return groups.axes_group(axes)
    return group


def _through_host(tensor: torch.Tensor, group: Any) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def _pinned_copy(tensor: torch.Tensor) -> torch.Tensor:
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    return host.copy_(tensor)


def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM,
               group: GroupLike = None) -> torch.Tensor:
    """Reduce ``tensor`` over the group, in place; returns it."""
    group = _resolve(group)
    if op == ReduceOp.AVG:
        all_reduce(tensor, ReduceOp.SUM, group)
        return tensor.div_(dist.get_world_size(group))
    _count("all_reduce", tensor, group, 2)
    if _through_host(tensor, group):
        host = _pinned_copy(tensor)
        dist.all_reduce(host, _TORCH_OPS[op], group=group)
        return tensor.copy_(host)
    dist.all_reduce(tensor, _TORCH_OPS[op], group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group: GroupLike = None,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes), concatenated along ``dim``
    in group-rank order; a new tensor on ``tensor``'s device."""
    group = _resolve(group)
    n = dist.get_world_size(group)
    src = tensor.contiguous()
    if _through_host(src, group):
        src = _pinned_copy(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    _count("all_gather", src, group, n)
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(tensor.device)


def all_gather_into(out: torch.Tensor, tensor: torch.Tensor,
                    group: GroupLike = None) -> torch.Tensor:
    """Every rank's ``tensor`` (``out.numel() / n`` elements each) written
    into the flat ``out`` in group-rank order, in place; ``tensor`` may be
    this rank's block of ``out`` itself.  Returns ``out``."""
    group = _resolve(group)
    src = tensor.reshape(-1)
    _count("all_gather", out, group)
    if _through_host(out, group):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_gather_into_tensor(host, _pinned_copy(src), group=group)
        return out.copy_(host)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def reduce_scatter(tensor: torch.Tensor, op: str = ReduceOp.SUM,
                   group: GroupLike = None, dim: int = 0) -> torch.Tensor:
    """Reduce ``tensor`` (the same shape on every rank) over the group and
    return this rank's block of the result: the ``rank``-th of ``n`` equal
    contiguous blocks along ``dim`` (JAX ``reduce_scatter``); a new
    contiguous tensor on ``tensor``'s device.  ``dim`` other than 0 is
    moved to the front around the collective."""
    group = _resolve(group)
    n = dist.get_world_size(group)
    if tensor.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of "
                         f"{tuple(tensor.shape)} does not split over {n} "
                         "ranks")
    if op == ReduceOp.AVG:
        return reduce_scatter(tensor, ReduceOp.SUM, group, dim).div_(n)
    src = tensor.movedim(dim, 0).contiguous()
    _count("reduce_scatter", src, group)
    if _through_host(src, group):
        src = _pinned_copy(src)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, _TORCH_OPS[op], group=group)
    return out.movedim(0, dim).to(tensor.device).contiguous()


def all_to_all_single(tensor: torch.Tensor,
                      group: GroupLike = None) -> torch.Tensor:
    """Split ``tensor`` into ``n`` equal blocks along dim 0, send block
    ``j`` to group rank ``j``, and return the blocks received, in group-rank
    order (JAX ``all_to_all_single``; even splits only)."""
    group = _resolve(group)
    n = dist.get_world_size(group)
    if tensor.shape[0] % n:
        raise ValueError(f"all_to_all_single: dim 0 of "
                         f"{tuple(tensor.shape)} does not split over {n} "
                         "ranks")
    src = tensor.contiguous()
    _count("all_to_all", src, group)
    if _through_host(src, group):
        src = _pinned_copy(src)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(tensor.device)


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: GroupLike = None) -> torch.Tensor:
    """``tensor`` from group rank ``src`` to every rank, in place; returns
    it."""
    group = _resolve(group)
    root = src if group is None else dist.get_global_rank(group, src)
    _count("broadcast", tensor, group)
    if _through_host(tensor, group):
        host = _pinned_copy(tensor)
        dist.broadcast(host, root, group=group)
        return tensor.copy_(host)
    dist.broadcast(tensor, root, group=group)
    return tensor


def barrier(group: GroupLike = None) -> None:
    dist.barrier(group=_resolve(group))


def _all_to_all_tiled(tensor: torch.Tensor, group: Any, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
    """Cut ``tensor`` into ``n`` equal blocks along ``split_axis``, send
    block ``j`` to group rank ``j``, and concatenate the blocks received
    along ``concat_axis`` in group-rank order (``jax.lax.all_to_all`` with
    ``tiled=True``)."""
    n = dist.get_world_size(group)
    if tensor.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(tensor.shape)} does not split over {n} "
                         "ranks")
    all_to_all_in_graph.calls += 1
    send = torch.stack(tensor.chunk(n, dim=split_axis))
    return torch.cat(all_to_all_single(send, group).unbind(0),
                     dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """Forward: the tiled all-to-all; backward: the inverse one (split and
    concat axes swapped), the reference's ``_SeqAllToAll``."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all_tiled(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all_tiled(grad.contiguous(), ctx.group, concat_axis,
                                  split_axis), None, None, None)


def all_to_all_in_graph(x: torch.Tensor, group: GroupLike = None,
                        split_axis: int = 0, concat_axis: int = 0,
                        tiled: bool = True) -> torch.Tensor:
    """The Ulysses / MoE all-to-all with a gradient (JAX
    ``all_to_all_in_graph``): ``x`` cut along ``split_axis``, the blocks
    exchanged, and what arrives concatenated along ``concat_axis``; the
    backward sends the gradient back the same way.  Only the tiled form is
    ported.  ``all_to_all_in_graph.calls`` counts the exchanges (backward
    ones included) since the caller last set it to 0."""
    if not tiled:
        raise NotImplementedError("all_to_all_in_graph: only tiled=True is "
                                  "ported")
    group = _resolve(group)
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


all_to_all_in_graph.calls = 0


def _ppermute(tensor: torch.Tensor, perm: Sequence[Tuple[int, int]],
              group: Any) -> torch.Tensor:
    """Each ``(src, dst)`` pair of group ranks: ``src``'s ``tensor`` lands on
    ``dst``; a rank no pair sends to gets zeros (``jax.lax.ppermute``).  The
    pairs run as one batch of ``isend`` / ``irecv``."""
    me = dist.get_rank(group)
    src = tensor.contiguous()
    if any(s == me and d != me for s, d in perm):
        _count("ppermute", src, group)
    if _through_host(src, group):
        src = _pinned_copy(src)
    out = torch.zeros_like(src)

    def peer(r: int) -> int:
        return r if group is None else dist.get_global_rank(group, r)

    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, peer(d), group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, peer(s), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(tensor.device)


class _PPermute(torch.autograd.Function):
    """Forward: the permutation; backward: the gradient along the inverse
    permutation."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, grad):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(grad, inverse, ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group: GroupLike = None) -> torch.Tensor:
    """Send/receive pairs over the group with a gradient (JAX
    ``ppermute``): ``perm`` lists ``(source, destination)`` group ranks;
    every rank of the group calls it with the same pairs."""
    group = _resolve(group)
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(x, perm, group)


class _TPCopy(torch.autograd.Function):
    """Megatron's *f*: identity forward; the backward sums the gradient
    over the group (every rank's column-parallel product read the same
    input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), group=ctx.group), None


class _TPReduce(torch.autograd.Function):
    """Megatron's *g*: the partial sums added over the group; the backward
    passes the gradient through (every rank holds the whole sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TPMax(torch.autograd.Function):
    """The elementwise max over the group with a zero gradient (the
    log-sum-exp shift, whose derivative is zero)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), ReduceOp.MAX, group=group)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad), None


class _TPGather(torch.autograd.Function):
    """The ranks' blocks of the last dim concatenated in group-rank order;
    the backward keeps this rank's block of the gradient (every rank reads
    the whole result alike, so its gradient is equal on the ranks)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return all_gather(x.contiguous(), group=group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad.narrow(-1, r * ctx.n, ctx.n).contiguous(), None


class _TPSplit(torch.autograd.Function):
    """This rank's block of the last dim of a tensor every rank holds
    whole; the backward all-gathers the blocks' gradients (the whole
    input's gradient, equal on the ranks)."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        if x.shape[-1] % n:
            raise ValueError(f"tp_split: last dim of {tuple(x.shape)} does "
                             f"not split over {n} ranks")
        ctx.group = group
        k = x.shape[-1] // n
        return x.narrow(-1, dist.get_rank(group) * k, k).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), group=ctx.group, dim=-1), None


def tp_gather(x: torch.Tensor, group: GroupLike = None) -> torch.Tensor:
    """A column-parallel output made whole: the ranks' blocks of the last
    dim all-gathered, the backward taking this rank's block."""
    return _TPGather.apply(x, _resolve(group))


def tp_split(x: torch.Tensor, group: GroupLike = None) -> torch.Tensor:
    """This rank's block of the last dim of a whole ``x`` (the input of a
    row-parallel product that no column-parallel one feeds)."""
    return _TPSplit.apply(x, _resolve(group))


def tp_copy(x: torch.Tensor, group: GroupLike = None) -> torch.Tensor:
    """Megatron's *f* over ``group`` (JAX ``_tp_copy``): ``x`` itself, its
    gradient summed over the group."""
    return _TPCopy.apply(x, _resolve(group))


def tp_reduce(x: torch.Tensor, group: GroupLike = None) -> torch.Tensor:
    """Megatron's *g* over ``group`` (JAX ``_tp_reduce``): ``x`` summed
    over the group in its dtype.  Under a gradient a new tensor whose
    gradient passes through; without one (serving) ``x`` itself, reduced
    in place."""
    if not torch.is_grad_enabled():
        return all_reduce(x, group=group)
    return _TPReduce.apply(x, _resolve(group))


def tp_max(x: torch.Tensor, group: GroupLike = None) -> torch.Tensor:
    """The max over ``group`` with a zero gradient (JAX ``_tp_max``)."""
    return _TPMax.apply(x, _resolve(group))
