"""ServingScheduler: the v2 ragged planner with prefix sharing, refcounted
pages and preemptible decode slots.

Counterpart of ``deepspeed_tpu/serving/scheduler.py``.  Same planner
surface as :class:`RaggedScheduler`; the deltas:

* **Reservation** (``_reserve``): the prompt is matched against the prefix
  trie first; matched whole blocks are acquired (refcount + 1) instead of
  allocated, and the request's ``prefilled`` cursor starts past them.  The
  reuse boundary stays strictly before the last prompt token and keeps every
  later chunk's page slice in range.
* **Release** (``_release``): refcounts drop; pages reaching zero that the
  trie still indexes enter the allocator's cached tier.
* **Indexing**: a request's full prompt pages enter the trie the moment its
  prefill completes (``chunk_done``).
* **Preemption** (``preempt`` / ``resume``): a seated request leaves its
  slot with its pages and host state intact, and resumes where it stopped.

Not ported yet: the release-on-preemption path the memory plane drives
(``preempt_release``) and the disaggregated KV adoption (``adopt_*``).
"""

from __future__ import annotations

from collections import deque
from typing import List

from ..inference.v2.kv_cache import KVCacheConfig
from ..inference.v2.scheduler import RaggedScheduler, Request, RequestState
from .prefix_cache import PrefixCache, RefcountedBlockAllocator


class ServingScheduler(RaggedScheduler):
    def __init__(self, cache_config: KVCacheConfig,
                 max_batch_slots: int = 8, prefill_chunk: int = 128,
                 prefill_batch: int = 1, prefix_sharing: bool = True,
                 max_cached_blocks: int = 0):
        self._max_cached_blocks = int(max_cached_blocks)
        super().__init__(cache_config, max_batch_slots, prefill_chunk,
                         prefill_batch)
        self.allocator: RefcountedBlockAllocator
        self.prefix = PrefixCache(self.allocator, cache_config.block_size,
                                  enabled=prefix_sharing)
        self.preemptions = 0

    def _make_allocator(self, num_blocks: int) -> RefcountedBlockAllocator:
        return RefcountedBlockAllocator(
            num_blocks, max_cached=self._max_cached_blocks)

    # -- prefix-shared reservation ----------------------------------------

    def _reuse_cap(self, prompt_len: int, matched_tokens: int) -> int:
        """Largest safe reuse boundary (tokens): block-aligned, at most
        ``matched_tokens``, strictly before the last prompt token, and
        placed so every later chunk start ``cap + k*chunk`` keeps
        ``start + chunk <= max_seq_len``."""
        bs = self.cache.block_size
        cap = min(matched_tokens, ((prompt_len - 1) // bs) * bs)
        max_seq = self.cache.max_seq_len
        while cap > 0:
            last_start = cap + ((prompt_len - cap - 1) // self.chunk) \
                * self.chunk
            if last_start + self.chunk <= max_seq:
                break
            cap -= bs
        return max(cap, 0)

    def _shared_plan(self, prompt: List[int], max_new_tokens: int) -> tuple:
        """The one trie match + reuse cap + capacity count, shared by
        ``_reserve`` and ``can_admit``.  Read-only.  Returns
        ``(shared_blocks, fresh_needed, reused_tokens, available)``;
        ``available`` excludes the cached pages this request would revive."""
        bs = self.cache.block_size
        matched = self.prefix.match(prompt)
        reused = self._reuse_cap(len(prompt), len(matched) * bs)
        shared = matched[:reused // bs]
        need = -(-(len(prompt) + max_new_tokens) // bs)
        fresh = need - len(shared)
        cached_shared = sum(1 for b in shared
                            if self.allocator.is_cached(b))
        avail = (self.allocator.num_free
                 + self.allocator.num_cached - cached_shared)
        return shared, fresh, reused, avail

    def _reserve(self, req: Request) -> bool:
        shared, fresh, reused, avail = self._shared_plan(
            req.prompt, req.max_new_tokens)
        if fresh > avail:
            return False
        # only a committing reservation counts a mid-block divergence
        self.prefix.count_mid_block_divergence(req.prompt)
        self.prefix.acquire(shared)
        req.blocks = shared + self.allocator.allocate(fresh)
        req.prefilled = reused
        self.prefix.record_lookup(len(req.prompt), reused)
        return True

    def can_admit(self, prompt: List[int], max_new_tokens: int,
                  reserve_pages: int = 0,
                  ignore_slots: bool = False) -> bool:
        """Would ``_reserve`` and a free slot succeed now, leaving at least
        ``reserve_pages`` available?  ``ignore_slots`` asks the pages-only
        question (slot-blocked vs page-blocked).  Read-only."""
        if not ignore_slots and self._free_slot() < 0:
            return False
        _, fresh, _, avail = self._shared_plan(prompt, max_new_tokens)
        return fresh + max(reserve_pages, 0) <= avail

    def match_tokens(self, prompt: List[int]) -> int:
        """Prefix-affinity signal for the router: tokens of this prompt the
        local trie already holds (after the reuse cap)."""
        matched = self.prefix.match(prompt)
        return self._reuse_cap(len(prompt), len(matched)
                               * self.cache.block_size)

    # -- release through refcounts ----------------------------------------

    def _release(self, req: Request) -> None:
        self.allocator.release(req.blocks, cache_fn=self.prefix.is_indexed)

    def admit_now(self, req: Request) -> bool:
        """Seat a just-added request at once, bypassing the FIFO ``waiting``
        deque (the front-end checked capacity, and may have preempted, for
        exactly this request)."""
        if req not in self.waiting:
            raise ValueError(f"admit_now: uid {req.uid} is not waiting")
        slot = self._free_slot()
        if slot < 0 or not self._reserve(req):
            return False  # stays in waiting; _admit retries in order
        self.waiting.remove(req)
        req.state = RequestState.PREFILL
        req.slot = slot
        self.slots[slot] = req
        self.prefilling.append(req)
        return True

    # -- class-aware SplitFuse interleave ----------------------------------

    def plan_step(self) -> tuple:
        """Prefill chunks go in priority order (stable within a class)."""
        if len(self.prefilling) > 1:
            self.prefilling = deque(
                sorted(self.prefilling, key=lambda r: r.priority))
        return super().plan_step()

    # -- trie indexing at prefill completion -------------------------------

    def chunk_done(self, chunk, first_token, eos_token_id=None) -> None:
        req = chunk.request
        super().chunk_done(chunk, first_token, eos_token_id)
        # the prompt's KV is in the pool now; a request that finished
        # inside this call has already released its pages
        if chunk.is_last and req.state is not RequestState.DONE:
            self.prefix.insert(req.prompt, req.blocks)

    # -- preemptible decode slots ------------------------------------------

    def preempt(self, req: Request) -> None:
        """Bump a RUNNING or PREFILL request out of its slot.  Its pages
        stay referenced and its generated tokens and prefill cursor stay;
        :meth:`resume` continues exactly where it stopped."""
        if req.state is RequestState.PREFILL:
            self.prefilling.remove(req)
        elif req.state is not RequestState.RUNNING:
            raise ValueError(
                f"can only preempt RUNNING/PREFILL requests, uid "
                f"{req.uid} is {req.state.value}")
        self.slots[req.slot] = None
        req.slot = -1
        req.state = RequestState.WAITING
        self.preemptions += 1

    def resume(self, req: Request) -> bool:
        """Re-seat a preempted request in a free slot; False if none is
        free."""
        if req.state is not RequestState.WAITING or not req.blocks:
            raise ValueError(
                f"resume expects a preempted request (WAITING with pages "
                f"reserved), uid {req.uid} is {req.state.value}")
        slot = self._free_slot()
        if slot < 0:
            return False
        req.slot = slot
        self.slots[slot] = req
        if req.prefilled < len(req.prompt):
            req.state = RequestState.PREFILL
            self.prefilling.append(req)
        else:
            req.state = RequestState.RUNNING
        return True
