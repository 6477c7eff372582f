"""Block-sparse attention for training: a forward (out + lse), a dq pass and a
dk/dv pass over the live tiles of a ``SparsityConfig`` layout, each a
hand-written CUDA kernel for Hopper beside its plain PyTorch version, with
the JAX function's host planning and dispatch.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/
block_sparse_attention.py``: the resident forward ``_bs_fwd`` and the gather
forward ``_bs_fwd_gather`` (both by the kernel behind
:func:`block_sparse_fwd`), and the flat-tile backward ``_sparse_bwd_pallas``
(its dq pass by :func:`block_sparse_bwd_dq`, its dk/dv pass by
:func:`block_sparse_bwd_dkv`).  In bf16 and fp16 all three run on the tensor
cores (``deepspeed_tpu_torch/csrc/block_sparse_attention_mma.cu``); fp32
stays on fp32 FMAs (``csrc/block_sparse_attention.cu``, whose C entry
points choose by the dtype).

Two tile sizes, kept apart:

* the **route** (the dense masked path or the kernels) is decided at the
  JAX function's blocks (``_bs_auto_block`` and its fitting) with its
  constants, measured on a TPU v5e and kept as they are for parity, so it is
  JAX's route on the same (layout, S, d, causal);
* the **kernels** walk 64 x 64 tiles (``lattice.TILE``).  :class:`TilePlan`
  lists, per layout head and tile row (forward, dq pass) or tile column
  (dk/dv pass), the live tiles of the cell layout after ``apply_lattice``,
  each with a compact bitmask of its cells (sub-blocks of ``gcd(cb, 8)``
  tokens); the causal mask and S are applied in the kernel.

Semantics (``[B, S, h, d]`` layout, scale ``1/sqrt(d)``): a key is live for a
query when their cells are live in the layout (head ``bh % H`` of an
``[H, nb, nb]`` layout, ``H`` 1 or h) and, under causal, q >= k.  The lse
``[B, h, S]`` is fp32 in units of scaled scores; a row with no live key
gives output 0 and lse ``1e30``, so its dq is 0; a key no query attends gets
dk and dv 0.  ``delta = sum_d do * o`` is plain PyTorch, as JAX computed it
outside its kernels.  A CUDA tensor of another dtype or head dim raises;
nothing falls back to the plain version on a CUDA tensor.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import op_builder
from .common import DTYPE_CODES
from .flash_attention import (attention_delta, check_attention_args,
                              check_bwd_args)
from .lattice import TILE, apply_lattice, live_lattice, num_tiles

Tensor = torch.Tensor

#: fully masked rows' lse, as the TPU kernel wrote it
NO_KEY_LSE = 1e30
#: query rows a plain version holds at once ([B, h, rows, S] fp32 planes)
PLAIN_ROWS = 1024


def _lru(cache: OrderedDict, limit: int, key, build: Callable):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    out = build()
    cache[key] = out
    while len(cache) > limit:
        cache.popitem(last=False)
    return out


# -- the JAX function's host planning (its blocks, its constants) ------------

_PLAN_CACHE: OrderedDict = OrderedDict()
_PLAN_CACHE_MAX = 16  # bounded: entries hold megabyte-scale cell tensors


def _norm_layout(layout: np.ndarray, h: int) -> np.ndarray:
    """→ ``[H, nb, nb]`` with H ∈ {1, num_heads} (shared layouts stay 1)."""
    layout = np.asarray(layout)
    if layout.ndim == 2:
        return layout[None]
    if layout.shape[0] not in (1, h):
        raise ValueError(f"per-head layout has {layout.shape[0]} heads, "
                         f"attention has {h}")
    return layout


def _plan(layout: np.ndarray, S: int, block_q: int, block_k: int, cb: int,
          causal: bool):
    """The JAX plan at its blocks: layout ``[H, nb, nb]`` → (idx ``[H, nq,
    max_live]`` int32, counts ``[H, nq]`` int32, cells ``[H, nq, max_live,
    qc, kc]`` int8).  Here only its counts are read (the route); the arrays
    are kept whole so the tests can hold them against JAX's."""
    def build():
        H = layout.shape[0]
        nq, nk = S // block_q, S // block_k
        qc, kc = block_q // cb, block_k // cb
        lay = apply_lattice(layout.astype(np.int8), causal, cb=cb)
        lists = [[np.nonzero(row)[0].tolist() for row in
                  lay[hh].reshape(nq, qc, nk, kc).any(axis=(1, 3))]
                 for hh in range(H)]
        max_live = max(1, max((len(l) for rows in lists for l in rows),
                              default=1))
        idx = np.zeros((H, nq, max_live), np.int32)
        counts = np.zeros((H, nq), np.int32)
        cells = np.zeros((H, nq, max_live, qc, kc), np.int8)
        for hh in range(H):
            for qi in range(nq):
                live = lists[hh][qi]
                counts[hh, qi] = len(live)
                for s, kj in enumerate(live):
                    idx[hh, qi, s] = kj
                    cells[hh, qi, s] = lay[hh, qi * qc:(qi + 1) * qc,
                                           kj * kc:(kj + 1) * kc]
                if live:  # padded with the last live index, as in JAX
                    idx[hh, qi, len(live):] = live[-1]
        return idx, counts, cells
    key = (layout.tobytes(), layout.shape, S, block_q, block_k, cb, causal)
    return _lru(_PLAN_CACHE, _PLAN_CACHE_MAX, key, build)


def _live_fraction(counts: np.ndarray, S: int, block_q: int, block_k: int,
                   causal: bool) -> float:
    """Live block fraction of the achievable area (the tril'd block count
    under causal)."""
    H, nq = counts.shape
    nk = S // block_k
    if causal:
        achievable = sum(min(nk, -(-((qi + 1) * block_q) // block_k))
                         for qi in range(nq)) * H
    else:
        achievable = H * nq * nk
    return float(counts.sum()) / float(max(achievable, 1))


#: the JAX function's kernel-overhead factor against the dense path,
#: measured on a TPU v5e (bf16, d 64, BigBird layouts): the kernel route
#: wins when ``1 / (overhead * live) > 1``.  (S_max, factor), first match.
#: Kept for route parity; the H100's crossover is measured by
#: ``chip_smoke.py`` and written in ``PERF.md``.
_KERNEL_OVERHEAD_BY_S: Tuple[Tuple[int, float], ...] = (
    (2048, 2.2), (4096, 1.7), (8192, 1.4), (1 << 62, 1.3))

#: longest S at which the JAX function still takes the dense path (its
#: O(S^2) logits); beyond it every layout takes the kernels
_DENSE_DISPATCH_MAX_S = 8192


def _kernel_overhead(S: int) -> float:
    for cap, ov in _KERNEL_OVERHEAD_BY_S:
        if S <= cap:
            return ov
    return _KERNEL_OVERHEAD_BY_S[-1][1]


def dense_live_threshold(S: int) -> float:
    """Live fraction above which the dense masked path takes the call."""
    return min(1.0 / _kernel_overhead(S), 0.95)


def choose_impl(S: int, live_frac: float) -> str:
    """"dense" or "kernel": the JAX ``choose_impl`` off interpret mode, with
    its "resident" and "gather" forwards both "kernel" (one Hopper forward
    serves every S)."""
    if S <= _DENSE_DISPATCH_MAX_S and live_frac > dense_live_threshold(S):
        return "dense"
    return "kernel"


def _bs_auto_block(S: int, cb: int) -> int:
    """The JAX function's default block: 128 up to S 4096, 256 beyond."""
    return max(cb, 128 if S <= 4096 else 256)


def fit_blocks(S: int, cb: int, block_q: int = 0,
               block_k: int = 0) -> Optional[Tuple[int, int]]:
    """The JAX function's blocks for this (S, cell): the requested (or auto)
    block, halved until it holds whole cells, divides S and is a multiple of
    8; None where no block fits (the JAX function then runs dense)."""
    auto = _bs_auto_block(S, cb)
    block_q = min(block_q, auto) if block_q else auto
    block_k = min(block_k, auto) if block_k else auto

    def fits(b):
        return b >= cb and b % cb == 0 and S % b == 0 and b % 8 == 0

    while block_q > cb and not fits(block_q):
        block_q //= 2
    while block_k > cb and not fits(block_k):
        block_k //= 2
    if not (fits(block_q) and fits(block_k)):
        return None
    return block_q, block_k


class Route(NamedTuple):
    impl: str                      # "dense" or "kernel"
    block_q: Optional[int]         # the JAX function's blocks (None: none fit)
    block_k: Optional[int]
    live_fraction: Optional[float]  # coarse, at those blocks


def route(layout: np.ndarray, S: int, cb: int, causal: bool,
          block_q: int = 0, block_k: int = 0) -> Route:
    """The JAX function's route for an ``[H, nb, nb]`` layout."""
    blocks = fit_blocks(S, cb, block_q, block_k)
    if blocks is None:
        return Route("dense", None, None, None)
    bq, bk = blocks
    _, counts, _ = _plan(layout, S, bq, bk, cb, causal)
    live = _live_fraction(counts, S, bq, bk, causal)
    return Route(choose_impl(S, live), bq, bk, live)


# -- the kernels' tile plan ---------------------------------------------------

class TilePlan:
    """The CUDA kernels' walk over the live ``TILE x TILE`` tiles of one cell
    layout ``[H, nb, nb]`` (cells of ``cb`` tokens, ``S = nb * cb``).

    Row-major (forward and dq pass): ``row_ptr [H * nt + 1]`` int32, the
    live list of (layout head ``hh``, q tile ``qi``) being entries
    ``row_ptr[hh * nt + qi]`` up to the next; ``col_idx`` their k tiles,
    ``masks [live, words]`` their cell masks, and ``row_order [H * nt]``
    each head's q tiles longest list first (the kernels start the long
    rows first).  Column-major (dk/dv pass): ``col_ptr``, ``row_idx`` (q
    tiles), ``masks_t`` and ``col_order`` in the same form.

    A tile's mask is a bit grid over sub-blocks of ``1 << mask_shift`` =
    ``gcd(cb, 8)`` tokens, bit ``(r >> shift) * (TILE >> shift) + (c >>
    shift)`` for tile row r and column c, in ``words = 64 >> 2 * shift``
    uint64 words (one for cells of 8 tokens or more).  It holds the layout's
    cells only: the kernels apply causality and S themselves.  The arrays go
    to a device once (:meth:`on`), through pinned memory without a sync.
    """

    def __init__(self, layout: np.ndarray, cb: int, S: int, causal: bool):
        layout = np.asarray(layout)
        if layout.ndim != 3 or layout.shape[1] != layout.shape[2] or \
                layout.shape[1] * cb != S:
            raise ValueError(f"layout {layout.shape} with cells of {cb} does "
                             f"not cover S {S}")
        self.layout, self.cb, self.S, self.causal = layout, cb, S, causal
        self.heads = layout.shape[0]
        self.nt = nt = num_tiles(S)
        g = math.gcd(cb, 8)
        self.mask_shift = g.bit_length() - 1
        self.words = 64 >> (2 * self.mask_shift)
        lay = apply_lattice(layout != 0, causal, cb=cb)
        self.cells = lay                                  # [H, nb, nb] bool
        nb = S // cb
        # cell of each g-token sub-block of each tile; nb (a dead pad cell)
        # past S
        starts = np.arange(nt * (TILE // g)) * g
        sub_cell = np.where(starts < S, starts // cb, nb).reshape(nt, -1)
        padded = np.zeros((self.heads, nb + 1, nb + 1), bool)
        padded[:, :nb, :nb] = lay
        touch = np.zeros((nt, nb + 1), np.float32)       # tile x cell
        touch[np.arange(nt)[:, None], sub_cell] = 1.0
        coarse = np.einsum("qa,hab,kb->hqk", touch,
                           padded.astype(np.float32), touch,
                           optimize=True) > 0             # [H, nt, nt]
        # a tile inside a live diagonal cell wider than the tile may still
        # lie above the diagonal: the tile lattice drops it
        coarse &= live_lattice(S, TILE, TILE, causal)[None]
        hs, qis, kjs = np.nonzero(coarse)                  # row-major order
        self.live_tiles = len(hs)
        bits = padded[hs[:, None, None], sub_cell[qis][:, :, None],
                      sub_cell[kjs][:, None, :]]
        masks = np.packbits(bits.reshape(len(hs), -1), axis=1,
                            bitorder="little").view(np.int64)
        self.masks = masks.reshape(len(hs), self.words)
        self.row_ptr = self._ptr(hs * nt + qis)
        self.col_idx = kjs.astype(np.int32)
        self.row_order = self._longest_first(self.row_ptr)
        order = np.lexsort((qis, kjs, hs))                # column-major
        self.col_ptr = self._ptr(hs[order] * nt + kjs[order])
        self.row_idx = qis[order].astype(np.int32)
        self.masks_t = np.ascontiguousarray(self.masks[order])
        self.col_order = self._longest_first(self.col_ptr)
        self._device = {}

    def _ptr(self, lists: np.ndarray) -> np.ndarray:
        counts = np.bincount(lists, minlength=self.heads * self.nt)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def _longest_first(self, ptr: np.ndarray) -> np.ndarray:
        lengths = np.diff(ptr).reshape(self.heads, self.nt)
        return np.argsort(-lengths, axis=1, kind="stable").astype(
            np.int32).reshape(-1)

    def on(self, device: torch.device) -> Tuple[Tensor, ...]:
        """``(row_ptr, col_idx, masks, row_order, col_ptr, row_idx, masks_t,
        col_order)`` on ``device``, uploaded at the first call."""
        def upload():
            return tuple(
                torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                    device, non_blocking=True)
                for a in (self.row_ptr, self.col_idx, self.masks,
                          self.row_order, self.col_ptr, self.row_idx,
                          self.masks_t, self.col_order))
        if device not in self._device:
            self._device[device] = upload()
        return self._device[device]

    def token_pairs(self) -> np.ndarray:
        """``[H]`` live (q, k) token pairs of each layout head: a cell holds
        ``cb^2``, a diagonal cell under causal ``cb (cb + 1) / 2``."""
        cb = self.cb
        full = self.cells.sum(axis=(1, 2)).astype(np.int64) * cb * cb
        if not self.causal:
            return full
        diag = np.diagonal(self.cells, axis1=1, axis2=2).sum(axis=1)
        return full - diag.astype(np.int64) * (cb * cb - cb * (cb + 1) // 2)


_TILE_PLANS: OrderedDict = OrderedDict()


def tile_plan(layout: np.ndarray, cb: int, S: int, causal: bool) -> TilePlan:
    """The :class:`TilePlan` of ``[H, nb, nb]`` ``layout``, cached (LRU of
    16) by (layout, cells, S, causal)."""
    layout = np.asarray(layout)
    key = (layout.tobytes(), layout.shape, layout.dtype.str, cb, S,
           bool(causal))
    return _lru(_TILE_PLANS, _PLAN_CACHE_MAX, key,
                lambda: TilePlan(layout, cb, S, bool(causal)))


# -- plain versions -----------------------------------------------------------

def token_mask(layout: np.ndarray, cb: int, causal: bool, S: int,
               rows: Optional[Tuple[int, int]] = None,
               device=None) -> Tensor:
    """``[H, rows, S]`` bool keep mask of query rows ``rows`` (all by
    default) under ``[H, nb, nb]`` layout: live cells, and q >= k under
    causal."""
    r0, r1 = rows if rows is not None else (0, S)
    lay = torch.from_numpy(np.asarray(layout) != 0).to(device)
    q_pos = torch.arange(r0, r1, device=device)
    k_pos = torch.arange(S, device=device)
    mask = lay[:, q_pos // cb][:, :, k_pos // cb]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return mask


def block_sparse_fwd_plain(q: Tensor, k: Tensor, v: Tensor,
                           layout: np.ndarray, cb: int, causal: bool
                           ) -> Tuple[Tensor, Tensor]:
    """The dense masked form of the JAX ``_dense_reference``, with the lse:
    fp32 scores times the scale, -1e30 on masked keys, ``p = exp(s - lse)``
    cast to q's dtype before p·V; a row with no live key gives out 0 and lse
    1e30.  Query rows go :data:`PLAIN_ROWS` at a time."""
    layout = _norm_layout(layout, q.shape[2])
    B, S, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    outs, lses = [], []
    for r0 in range(0, S, PLAIN_ROWS):
        r1 = min(r0 + PLAIN_ROWS, S)
        m = token_mask(layout, cb, causal, S, (r0, r1), q.device)[None]
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1], k).float() * scale
        s = torch.where(m, s, torch.full_like(s, -1e30))
        lse = torch.logsumexp(s, dim=-1)                    # [B, h, R]
        p = torch.exp(s - lse[..., None]).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v)
        dead = ~m.any(dim=-1)                               # [1, H, R]
        lses.append(torch.where(dead, torch.full_like(lse, NO_KEY_LSE), lse))
        outs.append(torch.where(dead.permute(0, 2, 1)[..., None],
                                torch.zeros_like(out), out))
    return torch.cat(outs, 1).contiguous(), torch.cat(lses, 2).contiguous()


def block_sparse_bwd_plain(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                           lse: Tensor, do: Tensor, layout: np.ndarray,
                           cb: int, causal: bool
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """dq, dk, dv from the saved out and lse, the recipe of the JAX
    ``_sparse_bwd_tiles`` written densely: fp32 throughout, ``p = exp(s -
    lse)`` on live pairs and 0 elsewhere, ``ds = p (dp - delta)``; dq and dk
    carry the scale once.  Query rows go :data:`PLAIN_ROWS` at a time."""
    layout = _norm_layout(layout, q.shape[2])
    B, S, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    k32, v32 = k.float(), v.float()
    delta = attention_delta(out, do)                        # [B, h, S]
    dqs = []
    dk = torch.zeros(B, S, h, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, S, PLAIN_ROWS):
        r1 = min(r0 + PLAIN_ROWS, S)
        m = token_mask(layout, cb, causal, S, (r0, r1), q.device)[None]
        q32, do32 = q[:, r0:r1].float(), do[:, r0:r1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
        p = torch.where(m, torch.exp(s - lse[..., r0:r1, None]),
                        torch.zeros_like(s))
        dv += torch.einsum("bhqk,bqhd->bkhd", p, do32)
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
        ds = p * (dp - delta[..., r0:r1, None])
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    return (torch.cat(dqs, 1).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def dense_masked_attention(q: Tensor, k: Tensor, v: Tensor,
                           layout: np.ndarray, cb: int, causal: bool,
                           key_padding_mask: Optional[Tensor] = None
                           ) -> Tensor:
    """The JAX dense path (``sparse_attention``'s masked reference), in
    plain ops with autograd: the fp32 softmax of the masked scores cast to
    q's dtype, fully masked rows zeroed explicitly.  The dense route runs
    it: with its one fused softmax, forward and backward take about two
    thirds of the time of the lse form of :func:`block_sparse_fwd_plain` on
    an H100 (``PERF.md``)."""
    layout = _norm_layout(layout, q.shape[2])
    S = q.shape[1]
    m = token_mask(layout, cb, causal, S, device=q.device)[None]
    if key_padding_mask is not None:
        m = m & key_padding_mask.to(device=q.device,
                                    dtype=torch.bool)[:, None, None, :]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p = torch.where(m.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# -- the kernels' wrappers ------------------------------------------------------

def _check_plan(q: Tensor, plan: TilePlan) -> None:
    if q.shape[1] != plan.S or plan.heads not in (1, q.shape[2]):
        raise ValueError(f"plan for S {plan.S} with {plan.heads} layout "
                         f"heads does not fit q {tuple(q.shape)}")


def _kernel_ints(q: Tensor, plan: TilePlan) -> tuple:
    """The C entry points' ints: B, S, H, d, layout heads, causal, mask
    shift, dtype."""
    B, S, h, d = q.shape
    return (B, S, h, d, plan.heads, int(plan.causal), plan.mask_shift,
            DTYPE_CODES[q.dtype])


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def block_sparse_fwd(q: Tensor, k: Tensor, v: Tensor,
                     plan: TilePlan) -> Tuple[Tensor, Tensor]:
    """``(out [B, S, h, d], lse [B, h, S] fp32)``: the forward kernel on a
    CUDA tensor, :func:`block_sparse_fwd_plain` on a CPU tensor."""
    check_attention_args(q, k, v, None, None)
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return block_sparse_fwd_plain(q, k, v, plan.layout, plan.cb,
                                      plan.causal)
    B, S, h, _ = q.shape
    row_plan = plan.on(q.device)[:4]
    out = torch.empty_like(q)
    lse = torch.empty(B, h, S, dtype=torch.float32, device=q.device)
    status = op_builder.load_library().ds_block_sparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(t.data_ptr() for t in row_plan), out.data_ptr(), lse.data_ptr(),
        *_kernel_ints(q, plan), _stream(q))
    op_builder.check(status, "block_sparse_fwd")
    block_sparse_fwd.launches += 1
    return out, lse


def _bwd_args(q, k, v, out, lse, do, plan, delta) -> Optional[Tensor]:
    """Check the backward's arguments; returns delta (computed from out and
    do on a CUDA tensor when not given: the kernels read delta, not out)."""
    delta = check_bwd_args(q, k, v, out, lse, do, delta, None, None)
    _check_plan(q, plan)
    return delta


def block_sparse_bwd_dq(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        lse: Tensor, do: Tensor, plan: TilePlan,
                        delta: Optional[Tensor] = None) -> Tensor:
    """``dq``: the dq-pass kernel on a CUDA tensor (walking each q tile's
    live k tiles), the plain backward's dq on a CPU tensor."""
    delta = _bwd_args(q, k, v, out, lse, do, plan, delta)
    if q.device.type == "cpu":
        return block_sparse_bwd_plain(q, k, v, out, lse, do, plan.layout,
                                      plan.cb, plan.causal)[0]
    row_plan = plan.on(q.device)[:4]
    dq = torch.empty_like(q)
    status = op_builder.load_library().ds_block_sparse_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in row_plan),
        dq.data_ptr(), *_kernel_ints(q, plan), _stream(q))
    op_builder.check(status, "block_sparse_bwd_dq")
    block_sparse_bwd_dq.launches += 1
    return dq


def block_sparse_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                         lse: Tensor, do: Tensor, plan: TilePlan,
                         delta: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor]:
    """``(dk, dv)``: the dk/dv-pass kernel on a CUDA tensor (walking each k
    tile's live q tiles), the plain backward's dk, dv on a CPU tensor."""
    delta = _bwd_args(q, k, v, out, lse, do, plan, delta)
    if q.device.type == "cpu":
        return block_sparse_bwd_plain(q, k, v, out, lse, do, plan.layout,
                                      plan.cb, plan.causal)[1:]
    col_plan = plan.on(q.device)[4:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = op_builder.load_library().ds_block_sparse_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in col_plan),
        dk.data_ptr(), dv.data_ptr(), *_kernel_ints(q, plan), _stream(q))
    op_builder.check(status, "block_sparse_bwd_dkv")
    block_sparse_bwd_dkv.launches += 1
    return dk, dv


#: kernel launches since the last reset (CPU calls never count)
block_sparse_fwd.launches = 0
block_sparse_bwd_dq.launches = 0
block_sparse_bwd_dkv.launches = 0


def block_sparse_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                     lse: Tensor, do: Tensor, plan: TilePlan
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(dq, dk, dv)``: delta once, then the dq and dk/dv kernels on a CUDA
    tensor; the plain backward once on a CPU tensor."""
    if q.device.type == "cpu":
        _bwd_args(q, k, v, out, lse, do, plan, None)
        return block_sparse_bwd_plain(q, k, v, out, lse, do, plan.layout,
                                      plan.cb, plan.causal)
    delta = attention_delta(out, do)
    dq = block_sparse_bwd_dq(q, k, v, out, lse, do, plan, delta)
    dk, dv = block_sparse_bwd_dkv(q, k, v, out, lse, do, plan, delta)
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """Forward kernel; the backward reads the saved out and lse (the JAX
    ``_bs_bwd``'s kernel pair, which it takes wherever the forward took the
    kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, plan):
        out, lse = block_sparse_fwd(q, k, v, plan)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_bwd(q, k, v, out, lse, do.contiguous(),
                                      ctx.plan)
        return dq, dk, dv, None


def block_sparse_kernel_attention(q: Tensor, k: Tensor, v: Tensor,
                                  layout: np.ndarray, cb: int,
                                  causal: bool = False) -> Tensor:
    """``[B, S, h, d]`` attention with a gradient through the three kernels
    (their plain versions on a CPU tensor) under ``layout`` ``[nb, nb]`` or
    ``[H, nb, nb]``, whatever the route would be."""
    layout = _norm_layout(layout, q.shape[2])
    plan = tile_plan(layout, cb, q.shape[1], causal)
    return _BlockSparseAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), plan)


# -- the public entry -----------------------------------------------------------

class _Entry(NamedTuple):
    layout: np.ndarray       # [H, nb, nb]
    route: Route
    plan: Optional[TilePlan]  # on the kernel route


_ENTRIES: OrderedDict = OrderedDict()


def config_key(cfg: Any) -> tuple:
    """A config's identity for the caches: its class and attributes (a
    layout is a function of both)."""
    return type(cfg), repr(sorted(vars(cfg).items()))


def config_entry(cfg: Any, S: int, h: int, causal: bool, block_q: int = 0,
                 block_k: int = 0) -> _Entry:
    """The layout, route and tile plan of ``cfg`` at (S, h, causal), made
    once (LRU of 16): ``make_layout`` and the planning are host work the
    JAX function redoes at every trace."""
    def build():
        layout = _norm_layout(cfg.make_layout(S), h)
        r = route(layout, S, cfg.block, causal, block_q, block_k)
        plan = (tile_plan(layout, cfg.block, S, causal)
                if r.impl == "kernel" else None)
        return _Entry(layout, r, plan)
    key = (config_key(cfg), S, h, bool(causal), int(block_q), int(block_k))
    return _lru(_ENTRIES, _PLAN_CACHE_MAX, key, build)


def block_sparse_attention(q: Tensor, k: Tensor, v: Tensor,
                           sparsity_config: Any, causal: bool = False,
                           block_q: int = 0, block_k: int = 0) -> Tensor:
    """``[B, S, h, d]`` attention that runs only the tiles the config's
    layout marks live (per head when the layout is per-head), with a
    gradient; the JAX ``block_sparse_attention``'s signature.

    The route is the JAX function's (:func:`route`): the dense masked path
    where no block fits or the coarse live fraction passes
    :func:`dense_live_threshold` at S <= 8192, else the kernels.
    ``block_q`` / ``block_k`` steer that decision only: the kernels walk 64 x
    64 tiles.  On a CPU tensor the kernels' plain versions run."""
    B, S, h, d = q.shape
    entry = config_entry(sparsity_config, S, h, causal, block_q, block_k)
    if entry.route.impl == "dense":
        return dense_masked_attention(q, k, v, entry.layout,
                                      sparsity_config.block, causal)
    return _BlockSparseAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), entry.plan)
