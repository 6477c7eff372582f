"""qwZ: ZeRO++'s int8 weight gathers (arXiv 2306.10209).

Counterpart of ``deepspeed_tpu/runtime/zero/qwz.py``.  Every float leaf
of more than ``stage3_param_persistence_threshold`` elements is, where the
model reads it, cast to the compute dtype, then to fp32, quantized to int8
with one fp32 scale a group, dequantized and cast back (JAX's order:
``cast_tree`` then ``make_qwz``); the backward is straight-through.  At
ZeRO stage 3 the gather moves the int8 codes and the scales instead of
the compute-dtype chunk (``sharder._GatherWeight``); at stages 0-2 nothing
is gathered, but the compute still sees the int8-rounded weights, as the
JAX engine applies qwZ at every stage.

Groups: ``GROUP`` elements along the JAX leaf's last dim when it divides
that dim, else one group a row of it (:func:`_quant`); JAX's threshold
(``qwz_compress_tree``) is :func:`qwz_axis`'s.  The JAX model
stacks its layers and keeps einsum layouts (``wq [L, H, nh, hd]``); the
port keeps ``nn.Linear`` weights ``[out, in]``, so a port parameter
carries a :class:`QwzAxis`: the port dim along which JAX's last dim runs
(``hd`` rows inside each head of ``q_proj.weight [nh·hd, H]``; dim 0 of
``gate_proj.weight [I, H]``; dim 1 of ``embed.weight``), the length of a
group along it, and the JAX leaf's element count for the threshold.  The
groups are then runs of ``run`` consecutive elements along ``dim``, and
quantizing them there computes JAX's numbers bit for bit: the amax, the
scale and each code depend on a group's elements alone.

The scale is ``amax * float32(1/127)``: XLA compiles JAX's ``amax /
127.0`` under ``jit`` (as the engine runs it) as that product; ``x /
scale`` stays a true division.  A NaN code becomes 0 before the int8
cast, as XLA's conversion makes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

GROUP = 256
#: float32(1/127): the multiplier XLA puts in place of ``/ 127.0``
INV_127 = float(np.float32(1.0) / np.float32(127.0))


@dataclasses.dataclass(frozen=True)
class QwzAxis:
    """Where JAX's last dim of a leaf runs in the port's layout: along
    ``dim``, a group every ``run`` elements; ``jax_numel``: the JAX leaf's
    elements (every layer of a stacked leaf), which the threshold counts."""

    dim: int
    run: int
    jax_numel: int


def group_run(last: int) -> int:
    """A group's length along a JAX last dim of ``last`` elements."""
    return GROUP if last % GROUP == 0 else last


def qwz_axis(dim: int, jax_last: int, jax_numel: int, threshold: int
             ) -> Optional[QwzAxis]:
    """The :class:`QwzAxis` of a leaf whose JAX last dim (``jax_last``
    long) runs along port dim ``dim``, or None when JAX leaves it whole
    (``qwz_compress_tree``: at most ``threshold`` elements)."""
    if jax_numel <= threshold:
        return None
    return QwzAxis(dim, group_run(jax_last), jax_numel)


def scales_of(amax: Tensor) -> Tensor:
    """Group scales from group amaxes; 1.0 for an all-zero group."""
    return torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))


def codes_of(g: Tensor, scale: Tensor) -> Tensor:
    """``clip(round(g / scale), -127, 127)`` as int8 (round half to
    even), a NaN code 0 (one fp32 temporary)."""
    t = torch.div(g, scale).round_()
    return torch.nan_to_num_(t, nan=0.0).clamp_(-127, 127).to(torch.int8)


def group_amax(g: Tensor) -> Tensor:
    """``max |g|`` over the last dim, without a temporary of ``g``'s size
    (a NaN propagates)."""
    return torch.maximum(g.amax(dim=-1), g.amin(dim=-1).neg_())


def quant_runs(x: Tensor, run: int) -> Tuple[Tensor, Tensor]:
    """fp32 ``x [..., D]`` in groups of ``run`` along its last dim (``run``
    divides ``D``) → (int8 codes ``[..., D]``, fp32 scales ``[..., D /
    run]``)."""
    g = x.reshape(*x.shape[:-1], x.shape[-1] // run, run)
    scale = scales_of(group_amax(g))
    return codes_of(g, scale[..., None]).reshape(x.shape), scale


def dequant_runs(q: Tensor, scale: Tensor, run: int) -> Tensor:
    """The fp32 values of :func:`quant_runs`' codes."""
    g = q.reshape(*q.shape[:-1], q.shape[-1] // run, run)
    return g.float().mul_(scale[..., None]).reshape(q.shape)


def _quant(p32: Tensor, group: int = GROUP
           ) -> Tuple[Tensor, Optional[Tensor]]:
    """JAX ``_quant``: groups of ``group`` along the last dim when it
    divides it, else one a row; a 0-d leaf is returned as is with no
    scale."""
    if p32.ndim == 0:
        return p32, None
    d = p32.shape[-1]
    return quant_runs(p32, group if d % group == 0 else d)


def _dequant(q: Tensor, scale: Tensor, shape: Tuple[int, ...],
             group: int = GROUP) -> Tensor:
    """JAX ``_dequant``."""
    d = shape[-1] if shape else 1
    return dequant_runs(q, scale, group if shape and d % group == 0 else d)


def fake_quant(w: Tensor, axis: QwzAxis) -> Tensor:
    """``w``'s values after the int8 round trip along ``axis`` (fp32)."""
    moved = w.float().movedim(axis.dim, -1)
    q, s = quant_runs(moved, axis.run)
    return dequant_runs(q, s, axis.run).movedim(-1, axis.dim)


class _StraightThrough(torch.autograd.Function):
    """Forward: ``w`` (already in the compute dtype) through the int8 round
    trip, back in its dtype; backward: the gradient unchanged (JAX
    ``make_qwz``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, w: Tensor, axis: QwzAxis) -> Tensor:
        return fake_quant(w, axis).to(w.dtype)

    @staticmethod
    def backward(ctx, grad: Tensor):
        return grad, None


def qwz(w: Tensor, axis: QwzAxis) -> Tensor:
    """qwZ of one weight in the compute dtype, straight-through."""
    return _StraightThrough.apply(w, axis)


def make_qwz():
    """JAX ``make_qwz`` on a whole leaf in JAX's layout (groups along its
    last dim): the compressor ``p -> p`` through the int8 round trip,
    straight-through.  A 0-d leaf passes unchanged."""
    def compress(p: Tensor) -> Tensor:
        if p.ndim == 0:
            return p
        return qwz(p, QwzAxis(p.ndim - 1, group_run(p.shape[-1]),
                              p.numel()))
    return compress
