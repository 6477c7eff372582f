"""RaggedInferenceEngineV2: the FastGen-style serving engine in PyTorch.

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py``.  Each scheduler
step runs up to two programs over the paged KV pool:

* a chunked prefill (:meth:`_prefill_batch_fn`): ``chunk`` prompt tokens for
  each of up to ``prefill_batch`` sequences, writing KV pages through each
  row's block table; its attention is plain PyTorch over the gathered pages
  of a power-of-two page bucket (:meth:`_prefill_bucket`);
* a decode burst (:meth:`_decode_burst_fn`): ``n_steps`` decode iterations
  for every slot, attention through the paged CUDA kernel
  (``ops/kernels/paged_attention.py``), sampling on the device; the tokens
  stay on the device and one ``[n_steps, B]`` copy goes to the host at the
  end of the burst.

The JAX engine donates the pool to its compiled programs; here KV writes
go into the pool tensors in place (``index_put_``).  Inactive slots point
their tables at page 0 and write only there.

Tensor-parallel serving: with a model built on a process mesh whose
``tensor`` axis has size ``tp``, every rank runs this engine over its own
heads and its own pool ``[L, N, bs, kv_h/tp, d]`` (the JAX pool's
``PartitionSpec(None, None, None, "tensor", None)``); prefill attends over
the local heads and the decode burst calls ``paged_decode_attention_tp``
(a Mixtral's prefill runs the dispatch and combine kernels over its
``I/tp`` expert columns, every rank routing the same tokens alike).
The model all-reduces each layer's row-parallel outputs and all-gathers the
logits, so every rank samples the same tokens (the generators are seeded
alike).  Every rank must be given the same requests in the same order: the
scheduler is deterministic, and a rank that took another decision would
leave a collective waiting.  The memory-ledger registration,
spans/counters and the MoE gate telemetry are not ported yet.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ...ops.kernels.paged_attention import (paged_decode_attention,
                                            paged_decode_attention_tp)
from ...ops.masks import local_attention_mask
from ...runtime.zero.sharder import refuse_cut
from ...utils.device import DeviceLike, check_module_device, resolve_device
from ...utils.logging import log_dist
from .adapters import ModelAdapterV2, make_adapter
from .kv_cache import KVCacheConfig, init_kv_pool
from .scheduler import RaggedScheduler, Request


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> torch.Tensor:
    """``[N, V]`` fp32 logits → int64 ids: greedy when ``temperature <= 0``,
    else a draw from the softmax at that temperature."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class RaggedInferenceEngineV2:
    def __init__(self, model: Any,
                 cache_config: Optional[KVCacheConfig] = None,
                 max_batch_slots: int = 8, prefill_chunk: int = 128,
                 prefill_batch: int = 2, decode_burst: int = 8,
                 scheduler_factory: Optional[Callable] = None,
                 device: DeviceLike = "cuda", mesh: Any = None):
        self.device = resolve_device(device)
        check_module_device(model, self.device)
        refuse_cut(model, "build_engine_v2")
        self.model = model
        #: the process mesh the model is split over (default: the model's)
        self.mesh = mesh if mesh is not None else model.mesh
        self.tp = model.tp
        if self.mesh is not None and self.mesh.shape["tensor"] != self.tp:
            raise ValueError(
                f"the engine's mesh has tensor size "
                f"{self.mesh.shape['tensor']}, the model was built for "
                f"{self.tp}: build the model on the same mesh")
        #: the decode burst's attention: "pallas" (the paged kernel) or,
        #: under tensor parallelism, "pallas_tp_shard_map" (the paged
        #: kernel on this rank's heads); the JAX engine's names
        self.last_attn_path: Optional[str] = None
        self.adapter: ModelAdapterV2 = make_adapter(model)
        self.config = model.config
        self.cache_config = cache_config or KVCacheConfig()
        if prefill_chunk % self.cache_config.block_size:
            raise ValueError("prefill_chunk must be a multiple of block_size")
        if self.cache_config.max_seq_len % prefill_chunk:
            # keeps every chunk's page-table slice in range
            raise ValueError("max_seq_len must be a multiple of prefill_chunk")
        #: sliding window, threaded into both programs' masks
        self.window = self.adapter.window
        make_sched = scheduler_factory or RaggedScheduler
        self.scheduler = make_sched(self.cache_config, max_batch_slots,
                                    prefill_chunk, prefill_batch)
        self.pool = init_kv_pool(self.adapter, self.cache_config, self.device)
        self.max_slots = max_batch_slots
        self.chunk = prefill_chunk
        self.prefill_batch = max(1, prefill_batch)
        self.decode_burst = max(1, decode_burst)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        #: host-clock totals of the two programs (each ends in a device →
        #: host copy, so the clock covers the device work)
        self.stats = {"prefill_calls": 0, "prefill_tokens": 0,
                      "prefill_s": 0.0, "decode_bursts": 0,
                      "decode_steps": 0, "decode_tokens": 0, "decode_s": 0.0}
        self.last_throughput = 0.0
        log_dist(f"inference v2: pool={self.cache_config.num_blocks}"
                 f"x{self.cache_config.block_size} tokens, "
                 f"slots={max_batch_slots}, chunk={prefill_chunk}"
                 f"x{prefill_batch}, burst={self.decode_burst}, "
                 f"adapter={type(self.adapter).__name__}, "
                 f"tp={self.tp}, device={self.device}")

    # ------------------------------------------------------------------
    # the two programs
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _prefill_batch_fn(self, tokens: torch.Tensor, tables: torch.Tensor,
                          start_pos: torch.Tensor, last_idx: torch.Tensor,
                          temperature: float, kb: int) -> torch.Tensor:
        """Up to ``Bp`` sequences' chunks at once: ``tokens [Bp, C]`` at
        positions ``start_pos[r] + [0, C)``; rows beyond the live chunks
        carry all-zero tables (page 0 = scratch).  Attention covers the
        first ``kb`` pages of each table, which hold every key written so
        far.  Returns the sampled ids ``[Bp]``."""
        ad = self.adapter
        Bp, C = tokens.shape
        bs = self.cache_config.block_size
        n_rep = ad.num_heads // ad.kv_heads
        dev = self.device
        positions = start_pos[:, None] + torch.arange(C, device=dev)[None, :]
        pos_flat = positions.reshape(-1)
        x = ad.embed(tokens.reshape(-1), pos_flat)  # [Bp*C, H]
        # each row's page slice for this chunk's writes, [Bp, C // bs]; the
        # start clamps as the JAX dynamic_slice does
        cursor = torch.clamp(start_pos // bs, max=tables.shape[1] - C // bs)
        pages = torch.gather(tables, 1, cursor[:, None]
                             + torch.arange(C // bs, device=dev)[None, :])
        pages_flat = pages.reshape(-1)
        gather_tables = tables[:, :kb]
        mask = local_attention_mask(
            positions, torch.arange(kb * bs, device=dev), causal=True,
            window=self.window)[:, None]  # [Bp, 1 (head), C, kb*bs]
        scale = 1.0 / math.sqrt(ad.head_dim)
        for li, layer in enumerate(ad.layers()):
            q, k, v = ad.qkv(layer, x, pos_flat)
            k_pool, v_pool = self.pool["k"][li], self.pool["v"][li]
            k_pool[pages_flat] = k.reshape(Bp * (C // bs), bs, ad.kv_heads,
                                           ad.head_dim)
            v_pool[pages_flat] = v.reshape(Bp * (C // bs), bs, ad.kv_heads,
                                           ad.head_dim)
            kf = k_pool[gather_tables].reshape(Bp, kb * bs, ad.kv_heads,
                                               ad.head_dim)
            vf = v_pool[gather_tables].reshape(Bp, kb * bs, ad.kv_heads,
                                               ad.head_dim)
            if n_rep > 1:
                kf = kf.repeat_interleave(n_rep, dim=2)
                vf = vf.repeat_interleave(n_rep, dim=2)
            qb = q.reshape(Bp, C, ad.num_heads, ad.head_dim)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kf).float() * scale
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            p = torch.softmax(s, dim=-1).to(ad.dtype)
            attn = torch.einsum("bhqk,bkhd->bqhd", p, vf)
            x = ad.post_attn(layer, x,
                             attn.reshape(Bp * C, ad.num_heads, ad.head_dim))
        x = ad.finalize(x).reshape(Bp, C, -1)
        last_h = x[torch.arange(Bp, device=dev), last_idx]  # [Bp, H]
        return _sample(ad.logits(last_h), temperature, self._gen)

    @torch.no_grad()
    def _decode_burst_fn(self, tokens: torch.Tensor, kv_lens: torch.Tensor,
                         tables: torch.Tensor, max_pos: torch.Tensor,
                         temperature: float, n_steps: int) -> torch.Tensor:
        """``n_steps`` decode iterations for all ``B`` slots: each step
        writes KV at ``kv_lens`` (clamped at ``max_pos``, so a slot that
        finished inside the burst only rewrites its own last reserved
        position) through ``tables``, attends with the paged kernel, samples
        the next token and feeds it back.  Returns ids ``[n_steps, B]`` on
        the device."""
        ad = self.adapter
        B = tokens.shape[0]
        bs = self.cache_config.block_size
        rows = torch.arange(B, device=self.device)
        out = torch.empty((n_steps, B), dtype=torch.int64, device=self.device)
        self.last_attn_path = "pallas_tp_shard_map" if self.tp > 1 \
            else "pallas"
        for step in range(n_steps):
            wp = torch.minimum(kv_lens, max_pos)  # [B] int32 write positions
            wp64 = wp.long()
            page_ids = tables[rows, wp64 // bs].long()
            offsets = wp64 % bs
            lengths = wp + 1
            x = ad.embed(tokens, wp)
            for li, layer in enumerate(ad.layers()):
                q, k, v = ad.qkv(layer, x, wp)
                k_pool, v_pool = self.pool["k"][li], self.pool["v"][li]
                k_pool[page_ids, offsets] = k
                v_pool[page_ids, offsets] = v
                if self.tp > 1:
                    attn = paged_decode_attention_tp(
                        q, k_pool, v_pool, tables, lengths, self.mesh,
                        window=self.window)
                else:
                    attn = paged_decode_attention(q, k_pool, v_pool, tables,
                                                  lengths, window=self.window)
                x = ad.post_attn(layer, x, attn)
            tokens = _sample(ad.logits(ad.finalize(x)), temperature, self._gen)
            out[step] = tokens
            kv_lens = kv_lens + 1
        return out

    # ------------------------------------------------------------------
    # serving surface
    # ------------------------------------------------------------------

    def put(self, prompt: List[int], max_new_tokens: int = 32) -> Request:
        """Admit one request (the reference's ``engine.put``)."""
        return self.scheduler.add_request(prompt, max_new_tokens)

    def _prefill_bucket(self, chunks) -> int:
        """Page bucket for this prefill call: the smallest power-of-two
        multiple of the chunk's page count that covers the deepest row's
        ``start_pos + chunk`` keys.  It fixes the gathered width and the
        mask, and so the numerics, as in the JAX engine."""
        bs = self.cache_config.block_size
        mb = self.cache_config.max_blocks_per_seq
        need = max((ch.start_pos + self.chunk) // bs for ch in chunks)
        kb = max(self.chunk // bs, 1)
        while kb < need:
            kb *= 2
        return min(kb, mb)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def step(self, temperature: float = 0.0,
             eos_token_id: Optional[int] = None) -> int:
        """One scheduler step: a batched prefill call and/or a decode burst.
        While prefill work exists the burst length is 1, so SplitFuse keeps
        interleaving chunks with decodes; once every prompt is in, decodes
        run ``decode_burst`` steps per call.  Returns the tokens processed."""
        chunks, decode = self.scheduler.plan_step()
        n_tokens = 0
        mbs = self.cache_config.max_blocks_per_seq
        if chunks:
            Bp, C = self.prefill_batch, self.chunk
            tokens = np.zeros((Bp, C), np.int32)
            tables = np.zeros((Bp, mbs), np.int32)
            start = np.zeros((Bp,), np.int64)
            last = np.zeros((Bp,), np.int64)
            for i, ch in enumerate(chunks):
                tokens[i] = ch.tokens
                tables[i] = self.scheduler.table_row(ch.request)
                start[i] = ch.start_pos
                last[i] = max(ch.n_valid - 1, 0)
            t0 = time.perf_counter()
            sampled = self._prefill_batch_fn(
                self._to_device(tokens), self._to_device(tables).long(),
                self._to_device(start), self._to_device(last), temperature,
                kb=self._prefill_bucket(chunks)).cpu().numpy()
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_calls"] += 1
            for i, ch in enumerate(chunks):
                first = int(sampled[i]) if ch.is_last else None
                self.scheduler.chunk_done(ch, first, eos_token_id)
                n_tokens += ch.n_valid
            self.stats["prefill_tokens"] += n_tokens
        if decode:
            # over-running a request's budget inside a burst is safe
            # (max_pos clamps its writes, the host discards the surplus)
            burst = 1 if (chunks or self.scheduler.prefilling) \
                else self.decode_burst
            B = self.max_slots
            tokens = np.zeros((B,), np.int64)
            kv_lens = np.zeros((B,), np.int32)
            max_pos = np.zeros((B,), np.int32)
            tables = np.zeros((B, mbs), np.int32)
            for req in decode:
                s = req.slot
                tokens[s] = req.generated[-1]
                kv_lens[s] = req.prefilled + len(req.generated) - 1
                max_pos[s] = len(req.prompt) + req.max_new_tokens - 1
                tables[s] = self.scheduler.table_row(req)
            t0 = time.perf_counter()
            toks = self._decode_burst_fn(
                self._to_device(tokens), self._to_device(kv_lens),
                self._to_device(tables), self._to_device(max_pos),
                temperature, n_steps=burst).cpu().numpy()  # [burst, B]
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_bursts"] += 1
            self.stats["decode_steps"] += burst
            accepted = self.scheduler.decode_burst_done(decode, toks,
                                                        eos_token_id)
            self.stats["decode_tokens"] += accepted
            n_tokens += accepted
        return n_tokens

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Drive the scheduler to completion over a ragged prompt batch;
        returns the generated-token lists in prompt order."""
        self._gen.manual_seed(seed)
        reqs = [self.put(p, max_new_tokens) for p in prompts]
        t0 = time.perf_counter()
        total = 0
        while self.scheduler.has_work:
            total += self.step(temperature, eos_token_id)
        dt = time.perf_counter() - t0
        self.last_throughput = total / dt if dt > 0 else 0.0
        return [r.generated for r in reqs]


def build_engine_v2(model: Any,
                    cache_config: Optional[KVCacheConfig] = None,
                    max_batch_slots: int = 8, prefill_chunk: int = 128,
                    prefill_batch: int = 2, decode_burst: int = 8,
                    scheduler_factory: Optional[Callable] = None,
                    device: DeviceLike = "cuda",
                    mesh: Any = None) -> RaggedInferenceEngineV2:
    return RaggedInferenceEngineV2(model, cache_config, max_batch_slots,
                                   prefill_chunk, prefill_batch, decode_burst,
                                   scheduler_factory=scheduler_factory,
                                   device=device, mesh=mesh)
