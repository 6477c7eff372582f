"""qgZ: ZeRO++'s int8 gradient reductions (arXiv 2306.10209).

Counterpart of ``deepspeed_tpu/runtime/zero/qgz.py``, over the port's
verbs (``comm.all_to_all_single`` and ``comm.all_gather`` on int8 codes
and fp32 scales, groups of ``GROUP`` elements):

* :func:`quantized_allreduce`, the two-hop mean of stages 0-2 and of a
  leaf stage 3 keeps whole: the local gradient, padded to ``world x
  GROUP``, cut into ``world`` chunks, each quantized; an all-to-all gives
  rank ``w`` every rank's chunk ``w``; dequantized and summed, the chunk
  is quantized again and all-gathered, and every rank dequantizes the
  whole;
* :func:`quantized_reduce_scatter`, the one hop of a leaf stage 3 cuts:
  the gradient cut into ``world`` chunks along ``dim`` (each padded to
  ``GROUP``), quantized, exchanged, dequantized and summed: rank ``w``
  keeps chunk ``w`` (``order``: the chunk each group rank keeps, when the
  caller's placement is not the group's rank order).

Both return the mean over the group, as JAX's do, or with ``average=False``
the sum (the port's engine sums gradients it has already divided by the
group's size; for a power-of-two group the two differ by an exact factor
and quantize to the same codes).  The sum over the ranks' chunks runs in
rank order, the mean multiplies by ``float32(1 / world)``: XLA compiles
JAX's ``jnp.sum(...) / world`` so.  :func:`wire_bytes` is JAX's count.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...comm import comm
from .qwz import GROUP, dequant_runs, quant_runs

Tensor = torch.Tensor


def _quant_groups(flat: Tensor) -> Tuple[Tensor, Tensor]:
    """fp32 ``[..., n]`` (``n % GROUP == 0``) → (int8 ``[..., n]``, fp32
    scales ``[..., n / GROUP]``)."""
    return quant_runs(flat, GROUP)


def _dequant_groups(q: Tensor, scales: Tensor) -> Tensor:
    return dequant_runs(q, scales, GROUP)


def _quant_rows(rows: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`_quant_groups` of each row of ``[W, c]``, a row at a time
    (the temporaries are a row's)."""
    q = torch.empty(rows.shape, dtype=torch.int8, device=rows.device)
    s = rows.new_empty((rows.shape[0], rows.shape[1] // GROUP))
    for r in range(rows.shape[0]):
        q[r], s[r] = _quant_groups(rows[r])
    return q, s


def _sum_rows(q: Tensor, s: Tensor, average: bool) -> Tensor:
    """The dequantized rows of ``[W, c]`` codes summed in row order, a row
    dequantized at a time (times ``1/W`` when ``average``)."""
    acc = _dequant_groups(q[0], s[0])
    for r in range(1, q.shape[0]):
        acc += _dequant_groups(q[r], s[r])
    if average:
        acc *= float(np.float32(1.0) / np.float32(q.shape[0]))
    return acc


def quantized_allreduce(g: Tensor, group: Any = None,
                        average: bool = True) -> Tensor:
    """The mean (or sum) of ``g`` over ``group`` with the int8 two-hop wire
    (JAX ``quantized_allreduce``); a new tensor of ``g``'s shape and
    dtype (``g`` itself in a group of one)."""
    world = comm.get_world_size(group)
    if world == 1:
        return g
    flat = g.reshape(-1).float()
    n = flat.numel()
    pad = -n % (world * GROUP)
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = _quant_rows(flat.view(world, -1))        # [W, c], [W, c/G]
    q = comm.all_to_all_single(q, group)             # every rank's chunk
    s = comm.all_to_all_single(s, group)             # this rank owns
    reduced = _sum_rows(q, s, average)
    q2, s2 = _quant_groups(reduced)
    q2 = comm.all_gather(q2, group).view(world, -1)
    s2 = comm.all_gather(s2, group).view(world, -1)
    out = _dequant_groups(q2, s2).reshape(-1)
    if pad:
        out = out[:n]
    return out.reshape(g.shape).to(g.dtype)


def quantized_reduce_scatter(g: Tensor, group: Any = None, dim: int = 0,
                             average: bool = True,
                             order: Optional[Sequence[int]] = None
                             ) -> Tensor:
    """This rank's chunk along ``dim`` of the mean (or sum) of ``g`` over
    ``group``, one int8 hop (JAX ``quantized_reduce_scatter``): chunk
    ``order[r]`` on group rank ``r`` (default chunk ``r``)."""
    world = comm.get_world_size(group)
    if world == 1:
        return g
    gm = g.movedim(dim, 0).float()
    per = gm.shape[0] // world
    n = per * math.prod(gm.shape[1:])
    flat = gm.reshape(world, n)
    if order is not None:
        flat = flat[list(order)]
    pad = -n % GROUP
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = _quant_rows(flat)
    q = comm.all_to_all_single(q, group)
    s = comm.all_to_all_single(s, group)
    red = _sum_rows(q, s, average)
    if pad:
        red = red[:n]
    out = red.reshape((per,) + tuple(gm.shape[1:]))
    return out.movedim(0, dim).to(g.dtype).contiguous()


def qgz_reduce_tree(grads: Dict[str, Tensor], group: Any = None
                    ) -> Dict[str, Tensor]:
    """JAX ``qgz_reduce_tree``: every leaf's two-hop mean."""
    return {k: quantized_allreduce(g, group) for k, g in grads.items()}


def wire_bytes(params: Any) -> Tuple[int, int]:
    """JAX ``wire_bytes``: (quantized, fp32) bytes a worker moves to reduce
    ``params`` (a dict or a sequence of tensors or arrays): int8 codes
    and fp32 scales over both hops, against an fp32 reduce-scatter and
    all-gather."""
    leaves = params.values() if isinstance(params, dict) else params
    n = sum(int(np.prod(np.shape(p))) for p in leaves)
    return 2 * (n + 4 * (n // GROUP)), 8 * n
