"""Ragged request scheduler: continuous batching + chunked prefill.

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py`` (the reference's
ragged manager and Dynamic SplitFuse policy, arXiv 2401.08671): long prompts
are split into fixed-size chunks and prefill work is interleaved with the
running decodes.  Host-side only.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from .kv_cache import BlockAllocator, KVCacheConfig


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    state: RequestState = RequestState.WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0          # prompt tokens already written to the pool
    slot: int = -1              # decode batch slot while seated
    #: prefill priority (lower = sooner); the serving plane maps latency
    #: classes here, plain engine use leaves everything at 0 (FIFO)
    priority: int = 0

    @property
    def remaining_budget(self) -> int:
        """Generation tokens this request may still emit."""
        return max(self.max_new_tokens - len(self.generated), 0)

    def pages_needed(self, block_size: int) -> int:
        total = len(self.prompt) + self.max_new_tokens
        return -(-total // block_size)


@dataclasses.dataclass
class PrefillChunk:
    request: Request
    tokens: np.ndarray          # [chunk] int32, zero-padded
    start_pos: int              # first position this chunk covers
    n_valid: int                # true tokens in this chunk
    is_last: bool               # finishing chunk → sample first token


class RaggedScheduler:
    """Admission + step planning over a fixed decode-slot budget.  Each
    :meth:`plan_step` returns up to ``prefill_batch`` chunks plus the
    current decode batch."""

    def __init__(self, cache_config: KVCacheConfig, max_batch_slots: int = 8,
                 prefill_chunk: int = 128, prefill_batch: int = 1):
        if prefill_chunk % cache_config.block_size:
            raise ValueError("prefill_chunk must be a multiple of block_size")
        self.cache = cache_config
        self.allocator = self._make_allocator(cache_config.num_blocks)
        self.chunk = prefill_chunk
        self.prefill_batch = max(1, prefill_batch)
        self.max_slots = max_batch_slots
        self.slots: List[Optional[Request]] = [None] * max_batch_slots
        self.waiting: Deque[Request] = deque()
        self.prefilling: Deque[Request] = deque()
        self._uid = 0

    def _make_allocator(self, num_blocks: int) -> BlockAllocator:
        """Subclass hook: the serving scheduler swaps in its refcounted
        allocator."""
        return BlockAllocator(num_blocks)

    # -- request surface ---------------------------------------------------

    def validate(self, prompt: List[int], max_new_tokens: int) -> None:
        """Reject malformed requests with an error naming the field."""
        if not prompt:
            raise ValueError("prompt: must be a non-empty token list")
        if max_new_tokens <= 0:
            raise ValueError(
                f"max_new_tokens: must be >= 1, got {max_new_tokens} "
                f"(a request that may generate nothing would occupy a "
                f"decode slot forever)")
        total = len(prompt) + max_new_tokens
        if total > self.cache.max_seq_len:
            raise ValueError(f"request of {total} tokens exceeds "
                             f"max_seq_len {self.cache.max_seq_len}")
        need = -(-total // self.cache.block_size)
        if need > self.cache.num_blocks - 1:  # page 0 reserved
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.cache.num_blocks - 1}")

    def add_request(self, prompt: List[int], max_new_tokens: int) -> Request:
        self.validate(prompt, max_new_tokens)
        req = Request(uid=self._uid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens)
        self._uid += 1
        self.waiting.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting) or bool(self.prefilling)
                or any(s is not None for s in self.slots))

    # -- planning ------------------------------------------------------------

    def _free_slot(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return -1

    def _reserve(self, req: Request) -> bool:
        """Reserve the request's full page budget; ``False`` defers
        admission.  The serving scheduler overrides this to take part of the
        reservation from shared prefix pages."""
        need = req.pages_needed(self.cache.block_size)
        if need > self.allocator.num_free:
            return False
        req.blocks = self.allocator.allocate(need)
        return True

    def _release(self, req: Request) -> None:
        """Return a finished or cancelled request's pages."""
        self.allocator.free(req.blocks)

    def _admit(self) -> None:
        """Move waiting → prefilling while a slot and pages for the whole
        request (prompt + generation budget) exist, so a running sequence
        can never run out of pages mid-flight."""
        while self.waiting:
            req = self.waiting[0]
            slot = self._free_slot()
            if slot < 0:
                return
            if not self._reserve(req):
                return
            self.waiting.popleft()
            req.state = RequestState.PREFILL
            req.slot = slot
            self.slots[slot] = req
            self.prefilling.append(req)

    def plan_step(self) -> tuple:
        """→ (list of :class:`PrefillChunk`, at most ``prefill_batch``, one
        per prefilling request; the decode requests) for this step."""
        self._admit()
        chunks: List[PrefillChunk] = []
        for req in list(self.prefilling)[:self.prefill_batch]:
            start = req.prefilled
            n_valid = min(self.chunk, len(req.prompt) - start)
            toks = np.zeros((self.chunk,), np.int32)
            toks[:n_valid] = req.prompt[start:start + n_valid]
            is_last = start + n_valid >= len(req.prompt)
            chunks.append(PrefillChunk(request=req, tokens=toks,
                                       start_pos=start, n_valid=n_valid,
                                       is_last=is_last))
        decode = [r for r in self.slots
                  if r is not None and r.state is RequestState.RUNNING]
        return chunks, decode

    # -- state transitions (called by the engine) ----------------------------

    def chunk_done(self, chunk: PrefillChunk, first_token: Optional[int],
                   eos_token_id: Optional[int] = None) -> None:
        req = chunk.request
        req.prefilled += chunk.n_valid
        if chunk.is_last:
            if req.prefilled != len(req.prompt):
                raise RuntimeError(f"request {req.uid}: last chunk left "
                                   f"{req.prefilled}/{len(req.prompt)} "
                                   f"prompt tokens prefilled")
            self.prefilling.remove(req)
            req.state = RequestState.RUNNING
            if first_token is not None:
                req.generated.append(int(first_token))
                self._maybe_finish(req, int(first_token), eos_token_id)

    def decode_burst_done(self, requests: List[Request], tokens: np.ndarray,
                          eos_token_id: Optional[int] = None) -> int:
        """Accept a burst's ``[n_steps, B]`` token matrix: each request takes
        its slot's column until it finishes (EOS or budget); tokens a done
        slot generated inside the burst are discarded.  Returns the number
        of accepted tokens."""
        accepted = 0
        for req in requests:
            for tok in tokens[:, req.slot]:
                if req.state is not RequestState.RUNNING:
                    break
                req.generated.append(int(tok))
                accepted += 1
                self._maybe_finish(req, int(tok), eos_token_id)
        return accepted

    def _maybe_finish(self, req: Request, tok: int,
                      eos: Optional[int]) -> None:
        if (len(req.generated) >= req.max_new_tokens
                or (eos is not None and tok == eos)):
            req.state = RequestState.DONE
            self._release(req)
            req.blocks = []
            if req.slot >= 0:
                self.slots[req.slot] = None
                req.slot = -1

    def cancel(self, req: Request) -> None:
        """Abort a request in any state before DONE: its pages come back and
        its slot frees."""
        if req.state is RequestState.DONE:
            return
        if req in self.waiting:
            self.waiting.remove(req)
        if req in self.prefilling:
            self.prefilling.remove(req)
        if req.blocks:
            self._release(req)
            req.blocks = []
        if req.slot >= 0:
            self.slots[req.slot] = None
            req.slot = -1
        req.state = RequestState.DONE

    def table_row(self, req: Request) -> np.ndarray:
        row = np.zeros((self.cache.max_blocks_per_seq,), np.int32)
        row[:len(req.blocks)] = req.blocks
        return row
