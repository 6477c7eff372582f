"""Block-sparse attention: the sparsity configs and the public entry.

Port of ``deepspeed_tpu/ops/sparse_attention.py`` (DeepSpeed's
``deepspeed.ops.sparse_attention``).  A ``SparsityConfig`` subclass's
``make_layout`` emits an ``[nb, nb]`` (or per-head ``[h, nb, nb]``) mask of
which key cells each query cell attends, cells of ``block`` tokens.  The
layouts are numpy, bit for bit the JAX package's: BigBird draws its random
cells from ``np.random.RandomState(seed + head)``.

:func:`sparse_attention` takes the block-sparse kernels
(:func:`~deepspeed_tpu_torch.ops.kernels.block_sparse_attention`, whose
route may still be the dense masked path) on a CUDA tensor when no padding
mask is given; ``impl="dense"``, a ``key_padding_mask`` or a CPU tensor take
the dense masked path in plain ops, with autograd.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .kernels.block_sparse_attention import (block_sparse_attention,
                                             config_entry,
                                             dense_masked_attention,
                                             token_mask)


class SparsityConfig:
    """Base: dense layout (the reference's ``DenseSparsityConfig``)."""

    def __init__(self, num_heads: int = 1, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def _blocks(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        return seq_len // self.block

    def _head_layout(self, seq_len: int, head: int) -> np.ndarray:
        """One head's ``[nb, nb]`` layout; subclasses with head-varying
        patterns (BigBird's random cells) consume ``head``."""
        n = self._blocks(seq_len)
        return np.ones((n, n), np.int32)

    def make_layout(self, seq_len: int) -> np.ndarray:
        """``[nb, nb]`` shared layout, or ``[num_heads, nb, nb]`` when
        ``different_layout_per_head``; per-head layouts that come out equal
        collapse back to the shared form."""
        if self.different_layout_per_head:
            per_head = [self._head_layout(seq_len, h)
                        for h in range(self.num_heads)]
            if all(np.array_equal(per_head[0], l) for l in per_head[1:]):
                return per_head[0]
            return np.stack(per_head)
        return self._head_layout(seq_len, 0)


class FixedSparsityConfig(SparsityConfig):
    """Local windows of ``num_local_blocks``, the last
    ``num_global_blocks`` of every window attended globally."""

    def __init__(self, num_heads: int = 1, block: int = 16,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional", **kw):
        super().__init__(num_heads, block, **kw)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def _head_layout(self, seq_len: int, head: int) -> np.ndarray:
        n = self._blocks(seq_len)
        lay = np.zeros((n, n), np.int32)
        for qb in range(n):
            w0 = (qb // self.num_local_blocks) * self.num_local_blocks
            lay[qb, w0:min(w0 + self.num_local_blocks, n)] = 1
        for w0 in range(0, n, self.num_local_blocks):
            g0 = min(w0 + self.num_local_blocks, n) - self.num_global_blocks
            for g in range(max(g0, 0), min(w0 + self.num_local_blocks, n)):
                lay[:, g] = 1
                lay[g, :] = 1
        if self.attention == "unidirectional":
            lay = np.tril(lay)
        return lay


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window plus designated global cells (Longformer)."""

    def __init__(self, num_heads: int = 1, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices=(0,), **kw):
        super().__init__(num_heads, block, **kw)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = tuple(global_block_indices)

    def _head_layout(self, seq_len: int, head: int) -> np.ndarray:
        n = self._blocks(seq_len)
        lay = np.zeros((n, n), np.int32)
        half = self.num_sliding_window_blocks // 2
        for qb in range(n):
            lay[qb, max(0, qb - half):min(n, qb + half + 1)] = 1
        for g in self.global_block_indices:
            if g < n:
                lay[:, g] = 1
                lay[g, :] = 1
        return lay


class BigBirdSparsityConfig(SparsityConfig):
    """Random plus sliding window plus global cells (BigBird)."""

    def __init__(self, num_heads: int = 1, block: int = 16,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, seed: int = 0, **kw):
        super().__init__(num_heads, block, **kw)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.seed = seed

    def _head_layout(self, seq_len: int, head: int) -> np.ndarray:
        n = self._blocks(seq_len)
        lay = np.zeros((n, n), np.int32)
        half = self.num_sliding_window_blocks // 2
        # per-head layouts differ by their random cells
        rng = np.random.RandomState(self.seed + head)
        for qb in range(n):
            lay[qb, max(0, qb - half):min(n, qb + half + 1)] = 1
            if n > self.num_random_blocks:
                lay[qb, rng.choice(n, self.num_random_blocks,
                                   replace=False)] = 1
        for g in range(min(self.num_global_blocks, n)):
            lay[:, g] = 1
            lay[g, :] = 1
            lay[:, n - 1 - g] = 1
            lay[n - 1 - g, :] = 1
        return lay


class VariableSparsityConfig(FixedSparsityConfig):
    """The reference's name, kept: the fixed pattern."""


def block_layout_to_token_mask(layout: np.ndarray, block: int,
                               causal: bool = False) -> torch.Tensor:
    """``[nb, nb]`` (or per-head ``[h, nb, nb]``) block layout → ``[S, S]``
    (or ``[h, S, S]``) bool token mask, on the CPU."""
    layout = np.asarray(layout)
    S = layout.shape[-1] * block
    mask = token_mask(layout[None] if layout.ndim == 2 else layout, block,
                      causal, S)
    return mask[0] if layout.ndim == 2 else mask


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sparsity_config: SparsityConfig, causal: bool = False,
                     key_padding_mask: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> torch.Tensor:
    """``[B, S, h, d]`` attention under a block-sparse layout, with a
    gradient.  ``impl="auto"`` on a CUDA tensor without a padding mask takes
    :func:`block_sparse_attention`; otherwise the dense masked path, whose
    fully masked rows are zeroed explicitly."""
    if impl == "auto" and key_padding_mask is None and q.is_cuda:
        return block_sparse_attention(q, k, v, sparsity_config, causal)
    S, h = q.shape[1], q.shape[2]
    layout = config_entry(sparsity_config, S, h, causal).layout
    return dense_masked_attention(q, k, v, layout, sparsity_config.block,
                                  causal, key_padding_mask)
