"""Paged prefix-sharing KV cache — refcounted pages + hash-trie index.

Counterpart of ``deepspeed_tpu/serving/prefix_cache.py``, carried over
unchanged: it is host-side bookkeeping with no device code.

vLLM's PagedAttention (arXiv 2309.06180 [P]) made the case that the
load-bearing primitive for multi-tenant serving throughput is not a
faster kernel but a *shared, reference-counted page pool*: identical
prompt prefixes (system prompts, few-shot headers) map to the SAME
immutable KV pages, so N concurrent requests with a 1k-token header pay
its HBM and its prefill FLOPs once.  This module is the version
over ``inference/v2``'s block pool:

* :class:`RefcountedBlockAllocator` — the v2 free-list allocator plus a
  per-page reference count and a *cached-free* LRU tier: a page whose
  last holder releases it but whose content is indexed by the prefix
  trie goes to the cached tier instead of the free list.  Allocation
  prefers truly-free pages and only reclaims cached pages LRU-oldest —
  so prefix KV survives across requests exactly as long as the pool has
  slack, and evicts itself under pressure with zero policy code in the
  scheduler.
* :class:`PrefixCache` — a hash-trie keyed by *block-size token chunks*
  (dict lookup hashes the chunk; tuple equality makes collisions
  harmless).  ``match()`` walks a prompt down the trie and returns the
  shared pages covering its longest indexed prefix; ``insert()`` indexes
  a freshly prefilled prompt's full pages.

Copy-on-write lives at the divergence boundary: shared pages are
immutable (refcount > 1 or trie-indexed), and all KV writes happen in
full-page units, so when a prompt diverges *mid-block* from an indexed
chunk the writer gets a fresh private page and recomputes it — the
"copy" is a recompute because a partial-page device copy would cost more
than the chunk's prefill.  The ``cow_events`` counter makes the boundary
observable.  Decode writes can never land on a shared page by
construction: sharing is capped at the last *full* block strictly before
the prompt's final token, and decode appends strictly after the prompt.

Host-side only (like all v2 page bookkeeping): the device never sees any
of this — tables of ints go into the same compiled programs.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..inference.v2.kv_cache import BlockAllocator


class RefcountedBlockAllocator(BlockAllocator):
    """Free-list allocator + refcounts + a cached-free LRU tier.

    Page states: *free* (on the base free list), *active* (refcount >=
    1), *cached* (refcount 0, content still indexed by the prefix trie,
    reclaimable LRU-oldest-first).  ``num_available`` — free + cached —
    is what admission control budgets against.
    """

    def __init__(self, num_blocks: int, max_cached: int = 0,
                 evict_callback: Optional[Callable[[int], None]] = None):
        super().__init__(num_blocks)
        self._refs: Dict[int, int] = {}
        #: page -> None, insertion order == LRU order (oldest first)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        #: cached pages kept at most (0 = bounded only by the pool)
        self.max_cached = int(max_cached)
        #: called with the page id when a cached page is reclaimed so the
        #: prefix trie drops the now-dangling index entry
        self._evict_callback = evict_callback

    def set_evict_callback(self, fn: Callable[[int], None]) -> None:
        self._evict_callback = fn

    # -- state queries -----------------------------------------------------

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_available(self) -> int:
        """Pages an allocation could obtain: truly free + reclaimable."""
        return self.num_free + len(self._cached)

    def is_cached(self, b: int) -> bool:
        return b in self._cached

    def _check_active(self, b: int) -> None:
        if b not in self._refs:
            raise ValueError(
                f"page {b} is not an active allocation (refcount 0): "
                f"double release, or a caller holding a stale block table")

    # -- allocation --------------------------------------------------------

    def allocate(self, n: int) -> List[int]:
        if n > self.num_available:
            raise MemoryError(
                f"KV pool exhausted: want {n} pages, {self.num_free} free "
                f"+ {len(self._cached)} cached-reclaimable")
        out: List[int] = []
        for _ in range(n):
            if self.num_free:
                b = self._free.pop()
                self._free_set.discard(b)
            else:
                b = self._reclaim_oldest_cached()
            self._refs[b] = 1
            out.append(b)
        return out

    def _reclaim_oldest_cached(self) -> int:
        b, _ = self._cached.popitem(last=False)
        if self._evict_callback is not None:
            # the callback prunes the trie subtree under this page, which
            # may UNCACHE further pages (they land on the plain free
            # list) — safe mid-allocation, the loop above re-checks
            self._evict_callback(b)
        return b

    def acquire(self, b: int) -> bool:
        """Add a reference to a shared page: retains an active page, or
        revives a cached one.  Returns True when the page was revived
        from the cached tier (a prefix *reuse across requests*)."""
        if b in self._refs:
            self._refs[b] += 1
            return False
        if b in self._cached:
            del self._cached[b]
            self._refs[b] = 1
            return True
        raise ValueError(
            f"page {b} is neither active nor cached — the prefix index "
            f"returned a page the allocator no longer tracks")

    # -- release -----------------------------------------------------------

    def release(self, blocks: List[int],
                cache_fn: Optional[Callable[[int], bool]] = None
                ) -> List[int]:
        """Drop one reference per page; pages reaching refcount 0 either
        enter the cached tier (``cache_fn(page)`` true — the trie still
        indexes them) or return to the free list.  Returns the pages
        that became reclaimable/free this call."""
        freed: List[int] = []
        for b in blocks:
            self._check_active(b)
            self._refs[b] -= 1
            if self._refs[b] > 0:
                continue
            del self._refs[b]
            freed.append(b)
            if cache_fn is not None and cache_fn(b):
                self._cached[b] = None
                self._enforce_cap()
            else:
                super().free([b])
        return freed

    def uncache(self, b: int) -> None:
        """Move a cached page to the plain free list (trie pruned it)."""
        if b in self._cached:
            del self._cached[b]
            super().free([b])

    def _enforce_cap(self) -> None:
        if self.max_cached <= 0:
            return
        while len(self._cached) > self.max_cached:
            b = self._reclaim_oldest_cached()
            super().free([b])

    def free(self, blocks: List[int]) -> None:
        """Base-scheduler compatibility: a plain free is a release that
        never caches.  Refcounted pages must go through :meth:`release`;
        freeing a page other holders still reference is the exact bug
        refcounting exists to prevent, so it raises."""
        for b in blocks:
            self._check_active(b)
            if self._refs[b] > 1:
                raise ValueError(
                    f"free of page {b} with refcount {self._refs[b]}: "
                    f"other requests still read this shared page — use "
                    f"release()")
        self.release(blocks)


class PrefixCache:
    """Hash-trie over block-size token chunks -> shared page ids.

    One node per indexed chunk; the path from the root spells a prompt
    prefix in whole blocks.  Children are keyed ``(parent_node, chunk
    tuple)`` in one flat dict, so matching a prompt is O(blocks) dict
    hits.  The trie holds **no references** of its own — liveness is the
    allocator's cached tier; when the allocator reclaims a cached page
    the eviction callback prunes the page's node *and its subtree*
    (descendant chunks are unreachable without their parent).
    """

    _ROOT = -1

    def __init__(self, allocator: RefcountedBlockAllocator,
                 block_size: int, enabled: bool = True):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.enabled = bool(enabled)
        #: node id -> {parent, chunk, block, children}; the synthetic
        #: root node anchors first-block chunks
        self._nodes: Dict[int, Dict[str, Any]] = {
            self._ROOT: {"parent": None, "chunk": (), "block": 0,
                         "children": []}}
        self._children: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._by_block: Dict[int, int] = {}
        self._next_id = 0
        # counters (read by serving metrics)
        self.lookup_tokens = 0
        self.hit_tokens = 0
        self.cow_events = 0
        self.inserts = 0
        self.evictions = 0
        self.revivals = 0
        allocator.set_evict_callback(self._on_evict)

    # -- matching ----------------------------------------------------------

    def _walk(self, prompt: List[int]
              ) -> Tuple[List[int], int, Optional[Tuple[int, ...]]]:
        """Walk the trie along ``prompt``'s whole-block chunks →
        (shared page ids in sequence order, node where the walk
        stopped, the first unmatched chunk — ``None`` if every whole
        block matched)."""
        bs = self.block_size
        blocks: List[int] = []
        parent = self._ROOT
        for i in range(len(prompt) // bs):
            chunk = tuple(prompt[i * bs:(i + 1) * bs])
            node_id = self._children.get((parent, chunk))
            if node_id is None:
                return blocks, parent, chunk
            blocks.append(self._nodes[node_id]["block"])
            parent = node_id
        return blocks, parent, None

    def match(self, prompt: List[int]) -> List[int]:
        """Longest indexed prefix of ``prompt`` in whole blocks →
        the shared page ids, in sequence order.  Strictly read-only: no
        refcount movement (``acquire`` commits a match at admission) and
        no counter movement (``count_mid_block_divergence`` records CoW
        only when a reservation commits)."""
        if not self.enabled:
            return []
        return self._walk(prompt)[0]

    def count_mid_block_divergence(self, prompt: List[int]) -> bool:
        """Count one copy-on-write event if ``prompt`` diverges from the
        trie *mid-block* — some indexed chunk shares a proper prefix
        with the diverging chunk, so an unpaged design would have shared
        that page and forked it.  Called ONLY when a reservation
        commits: advisory matches (admission checks, router affinity
        scoring) AND capacity-deferred reservations re-walk the same
        queued prompt every pump round — a page-blocked head at the
        front of the waiting deque must not inflate the counter."""
        if not self.enabled:
            return False
        _, parent, stopped = self._walk(prompt)
        if stopped is not None and self._diverges_mid_block(parent, stopped):
            self.cow_events += 1
            return True
        return False

    def _diverges_mid_block(self, parent: int, chunk: Tuple[int, ...]
                            ) -> bool:
        for nid in self._nodes[parent]["children"]:
            other = self._nodes[nid]["chunk"]
            if other and chunk and other[0] == chunk[0] and other != chunk:
                return True
        return False

    def acquire(self, blocks: List[int]) -> None:
        """Commit a match: one reference per shared page for the
        admitted request (revivals counted — those are the cross-request
        reuse the cache exists for)."""
        for b in blocks:
            if self.allocator.acquire(b):
                self.revivals += 1

    def record_lookup(self, prompt_tokens: int, reused_tokens: int) -> None:
        self.lookup_tokens += int(prompt_tokens)
        self.hit_tokens += int(reused_tokens)

    @property
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from shared pages."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    # -- insertion ---------------------------------------------------------

    def insert(self, prompt: List[int], blocks: List[int]) -> int:
        """Index a prefilled prompt's full pages.  Chunks already present
        keep their existing (shared) page — the request's private
        duplicate page stays private and frees normally.  Returns the
        number of new trie nodes."""
        if not self.enabled:
            return 0
        bs = self.block_size
        parent = self._ROOT
        added = 0
        for i in range(len(prompt) // bs):
            chunk = tuple(prompt[i * bs:(i + 1) * bs])
            key = (parent, chunk)
            node_id = self._children.get(key)
            if node_id is None:
                if i >= len(blocks):
                    break
                node_id = self._next_id
                self._next_id += 1
                self._nodes[node_id] = {"parent": parent, "chunk": chunk,
                                        "block": blocks[i], "children": []}
                self._children[key] = node_id
                self._by_block[blocks[i]] = node_id
                self._nodes[parent]["children"].append(node_id)
                added += 1
            parent = node_id
        self.inserts += added
        return added

    def is_indexed(self, b: int) -> bool:
        """The allocator's ``cache_fn``: released pages the trie still
        points at enter the cached tier instead of the free list."""
        return b in self._by_block

    # -- eviction ----------------------------------------------------------

    def _on_evict(self, block: int) -> None:
        """Allocator reclaimed cached page ``block``: prune its node and
        the whole subtree under it (children are unreachable without the
        parent).  Subtree pages still in the cached tier move to the
        plain free list; active descendants cannot exist — an active
        child implies the request also holds the parent, which would
        have kept it out of the cached tier."""
        node_id = self._by_block.pop(block, None)
        if node_id is None:
            return
        stack = [node_id]
        while stack:
            nid = stack.pop()
            node = self._nodes.pop(nid, None)
            if node is None:
                continue
            self._children.pop((node["parent"], node["chunk"]), None)
            if node["parent"] in self._nodes:
                try:
                    self._nodes[node["parent"]]["children"].remove(nid)
                except ValueError:
                    pass
            b = node["block"]
            if b != block:  # the triggering page is being reallocated
                self._by_block.pop(b, None)
                self.allocator.uncache(b)
            stack.extend(node["children"])
            self.evictions += 1

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {"nodes": len(self._nodes),
                "cached_blocks": self.allocator.num_cached,
                "lookup_tokens": self.lookup_tokens,
                "hit_tokens": self.hit_tokens,
                "hit_rate": round(self.hit_rate, 4),
                "cow_events": self.cow_events,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "revivals": self.revivals}
