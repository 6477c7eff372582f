"""The tile plan of the flash-attention kernels: which (q tile, k tile)
pairs hold a live token pair, and the token mask inside one tile.

Counterpart of ``deepspeed_tpu/ops/pallas/lattice.py`` (``live_lattice``,
``apply_lattice``, ``kv_block_bounds``, ``q_block_bounds``, ``tile_keep``).
The CUDA kernels
of ``csrc/flash_attention.cu`` compute the same bounds in-kernel
(``kv_bounds`` / ``q_bounds`` there); these host versions are the
reference the tests hold against the JAX lattice, and what
``chip_smoke.py`` counts live tiles with.

Differences from the JAX module, all from the Hopper kernel's design:

* the kernel fixes its tile at :data:`TILE` x :data:`TILE` and walks one
  contiguous range per row or column of tiles (causal and window lattices
  are banded), so there is no resident/streamed split and no VMEM block
  table (``auto_flash_blocks``, ``resident_fits``, ``plan_*_live``);
* S need not be a multiple of the tile: the tile count rounds up, and a
  tile's liveness and mask consider only positions below S.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: query rows and keys per tile in every flash kernel
TILE = 64


def num_tiles(S: int, block: int = TILE) -> int:
    return -(-S // block)


def live_lattice(S: int, block_q: int, block_k: int, causal: bool,
                 window: Optional[int] = None) -> np.ndarray:
    """``[nq, nk]`` bool: True where a tile holds some unmasked (causal and
    window) token pair.  Equals the JAX ``live_lattice`` when the blocks
    divide S."""
    nq, nk = num_tiles(S, block_q), num_tiles(S, block_k)
    q_lo = np.arange(nq)[:, None] * block_q
    q_hi = np.minimum(q_lo + block_q, S) - 1       # last real q of the row
    k_lo = np.arange(nk)[None, :] * block_k
    k_hi = np.minimum(k_lo + block_k, S) - 1
    # the q-k values a tile realises form [q_lo - k_hi, q_hi - k_lo]
    live = np.ones((nq, nk), bool)
    if causal:
        live &= k_lo <= q_hi
    if window is not None:
        live &= (q_lo - k_hi) < window
        if not causal:
            live &= (k_lo - q_hi) < window
    return live


def apply_lattice(layout: np.ndarray, causal: bool,
                  window: Optional[int] = None, cb: int = 1) -> np.ndarray:
    """Intersect an ``[H, nb, nb]`` sparsity-cell layout with the causal and
    window lattice at cell granularity (cells of ``cb`` tokens, ``window``
    in tokens): a cell the lattice kills holds no live token pair.  The
    block-sparse planner's skip source, as in the JAX lattice."""
    lay = np.asarray(layout)
    if not causal and window is None:
        return lay
    cb = max(int(cb), 1)
    nb = lay.shape[-1]
    lat = live_lattice(nb * cb, cb, cb, causal, window)
    return lay * lat[None].astype(lay.dtype)


def kv_block_bounds(qi: int, block_q: int, block_k: int, nk: int,
                    causal: bool, window: Optional[int] = None
                    ) -> Tuple[int, int]:
    """``[k0, k1)``: the contiguous live k tiles of q tile ``qi`` (the
    forward's and the dq pass's walk)."""
    k1 = min((qi * block_q + block_q + block_k - 1) // block_k, nk) \
        if causal else nk
    k0 = 0
    if window is not None:
        k0 = max(qi * block_q - (window - 1), 0) // block_k
        if not causal:
            k1 = min(k1, (qi * block_q + block_q - 1 + window + block_k - 1)
                     // block_k)
    return k0, k1


def q_block_bounds(ki: int, block_q: int, block_k: int, nq: int,
                   causal: bool, window: Optional[int] = None
                   ) -> Tuple[int, int]:
    """``[q0, q1)``: the contiguous live q tiles of k tile ``ki`` (the
    dk/dv pass's transposed walk)."""
    q0 = (ki * block_k) // block_q if causal else 0
    q1 = nq
    if window is not None:
        q1 = min(nq, (ki * block_k + block_k - 1 + window + block_q - 1)
                 // block_q)
        if not causal:
            q0 = max(ki * block_k - (window - 1), 0) // block_q
    return q0, q1


def tile_keep(qi: int, kj: int, block_q: int, block_k: int, causal: bool,
              window: Optional[int] = None,
              q_seg: Optional[torch.Tensor] = None,
              k_seg: Optional[torch.Tensor] = None,
              seq_len: Optional[int] = None) -> Optional[torch.Tensor]:
    """``[block_q, block_k]`` bool keep mask of tile ``(qi, kj)``: causal
    edge, window band, segment equality (``q_seg [block_q]``, ``k_seg
    [block_k]``) and, with ``seq_len``, positions below S.  None when
    nothing masks."""
    q_pos = qi * block_q + torch.arange(block_q)[:, None]
    k_pos = kj * block_k + torch.arange(block_k)[None, :]
    keep = None

    def both(a, b):
        return b if a is None else a & b

    if causal:
        keep = q_pos >= k_pos
    if window is not None:
        reach = (q_pos - k_pos) < window
        if not causal:
            reach = reach & ((k_pos - q_pos) < window)
        keep = both(keep, reach)
    if q_seg is not None and k_seg is not None:
        keep = both(keep, q_seg[:, None] == k_seg[None, :])
    if seq_len is not None and ((qi + 1) * block_q > seq_len
                                or (kj + 1) * block_k > seq_len):
        keep = both(keep, (q_pos < seq_len) & (k_pos < seq_len))
    return keep


def live_pairs(S: int, causal: bool, window: Optional[int] = None,
               segment_ids: Optional[torch.Tensor] = None) -> int:
    """Unmasked (q, k) token pairs of one head, summed over the batch rows of
    ``segment_ids [B, S]`` (one row without it): the work a kernel must do,
    for bounds."""
    seg = None if segment_ids is None else segment_ids.cpu()
    k_pos = torch.arange(S)
    total = 0
    for q0 in range(0, S, 1024):  # a band of rows at a time: O(1024 * S)
        diff = torch.arange(q0, min(q0 + 1024, S))[:, None] - k_pos
        keep = torch.ones_like(diff, dtype=torch.bool)
        if causal:
            keep &= diff >= 0
        if window is not None:
            keep &= (diff < window) if causal else (diff.abs() < window)
        if seg is None:
            total += int(keep.sum())
        else:
            same = seg[:, q0:q0 + 1024, None] == seg[:, None, :]
            total += int((same & keep).sum())
    return total
