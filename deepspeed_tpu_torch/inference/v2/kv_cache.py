"""Blocked (paged) KV cache: pool + block allocator.

Counterpart of ``deepspeed_tpu/inference/v2/kv_cache.py``.  KV memory is a
pool of fixed-size pages shared by all sequences; each sequence owns a list
of page ids (its block table).  The pool is one tensor per K/V with the
layer dim stacked, ``[L, num_blocks, block_size, kv_h, d]``; page
bookkeeping is plain host Python.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_blocks: int = 256          # pool pages (page 0 reserved as scratch)
    block_size: int = 16           # tokens per page
    max_seq_len: int = 2048        # per-sequence logical capacity

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)


def init_kv_pool(adapter: Any, cache_config: KVCacheConfig,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed pool sized from the adapter's (layers, kv heads, head dim);
    under tensor parallelism the kv heads are this rank's, so each rank's
    pool is its own contiguous ``[L, N, bs, kv_h/tp, d]``."""
    shape = (adapter.num_layers, cache_config.num_blocks,
             cache_config.block_size, adapter.kv_heads, adapter.head_dim)
    return {"k": torch.zeros(shape, dtype=adapter.dtype, device=device),
            "v": torch.zeros(shape, dtype=adapter.dtype, device=device)}


class BlockAllocator:
    """Free-list page allocator.  Page 0 is reserved: inactive batch slots
    point their whole table at it, so their writes land only on scratch."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (page 0 is reserved)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)  # O(1) double-free check

    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"KV pool exhausted: want {n} pages, "
                              f"{len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def check_owned(self, b: int) -> None:
        """Raise unless ``b`` is a currently allocated page id."""
        if not 0 < b < self.num_blocks:
            raise ValueError(
                f"free of out-of-range page id {b!r}: valid ids are "
                f"1..{self.num_blocks - 1} (page 0 is the reserved scratch "
                f"page and is never allocated or freed)")
        if b in self._free_set:
            raise ValueError(
                f"double free of page {b}: it is already on the free list "
                f"({len(self._free)} pages free of {self.num_blocks - 1})")

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            self.check_owned(b)
            self._free.append(b)
            self._free_set.add(b)
