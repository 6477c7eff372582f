"""The port's inference engines against the JAX engines, token for token.

Both packages get the same fp32 weights and prompts; greedy generation must
give the same tokens.  v1 is ``init_inference(...).generate``; v2 is
``build_engine_v2(...).generate`` over ragged prompts longer than the
prefill chunk (SplitFuse chunking, page buckets, decode bursts, slot reuse),
with and without a sliding window.  The allocator and scheduler tests mirror
``tests/unit/inference/test_v2.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference.v2 import KVCacheConfig as JaxKVCacheConfig
from deepspeed_tpu.inference.v2 import build_engine_v2 as jax_build_engine_v2
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference.v2 import (BlockAllocator, KVCacheConfig,
                                              RaggedScheduler, RequestState,
                                              build_engine_v2)
from torch_parity import jax_tiny, port_model

PROMPT_LENS = (3, 9, 17, 21)   # prefill_chunk 8: up to three chunks
N_NEW = 6
V2 = dict(max_batch_slots=3, prefill_chunk=8, prefill_batch=2, decode_burst=4)


@pytest.fixture(scope="module", params=[None, 6], ids=["full", "window6"])
def pair(request):
    jm, params = jax_tiny(num_layers=2, max_seq_len=64,
                          sliding_window=request.param)
    return jm, params, port_model(jm, params)


def _prompts(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, size=n).tolist() for n in PROMPT_LENS]


def test_v1_greedy_matches_jax(pair):
    jm, params, tm = pair
    ids = np.random.RandomState(0).randint(1, 512, size=(2, 11))
    want = np.asarray(jax_init_inference(model=jm, model_params=params,
                                         dtype=jnp.float32).generate(
        jnp.asarray(ids), max_new_tokens=N_NEW))
    got = init_inference(tm, device="cpu").generate(ids,
                                                    max_new_tokens=N_NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_v1_fp16_prefill_logits_match_jax_and_generate_is_finite():
    """A tiny Llama computing in fp16: the port's prefill logits within
    2e-2 (relative to 1 + |ref|) of JAX's, and v1 ``generate`` (prefill,
    then the decode path) gives finite logits and valid tokens."""
    jm, params = jax_tiny(num_layers=2, max_seq_len=64, dtype=jnp.float16)
    tm = port_model(jm, params)
    assert tm.config.dtype == torch.float16
    ids = np.random.RandomState(1).randint(1, 512, size=(2, 11))
    want, _ = jm.prefill(params, jnp.asarray(ids), jm.init_cache(2, 32))
    got, cache = tm.prefill(torch.from_numpy(ids), tm.init_cache(2, 32))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    logits, _ = tm.decode_step(cache, got.argmax(-1))
    assert bool(torch.isfinite(logits).all())
    out = init_inference(tm, device="cpu").generate(ids,
                                                    max_new_tokens=N_NEW)
    assert out.shape == (2, 11 + N_NEW)
    assert ((out >= 0) & (out < 512)).all()


def test_v1_eos_and_sampling_shapes(pair):
    _, _, tm = pair
    eng = init_inference(tm, device="cpu")
    ids = torch.tensor([[5, 6, 7]])
    greedy = eng.generate(ids, max_new_tokens=6)[0, 3:].tolist()
    eos = greedy[1]
    out = eng.generate(ids, max_new_tokens=6, eos_token_id=eos)[0, 3:]
    assert out.tolist() == greedy[:2] + [eos] * 4
    a = eng.generate(ids, max_new_tokens=4, temperature=0.8, top_k=5, seed=7)
    b = eng.generate(ids, max_new_tokens=4, temperature=0.8, top_k=5, seed=7)
    assert a.shape == (1, 7) and torch.equal(a, b)


def test_v2_greedy_matches_jax_ragged_chunked(pair):
    jm, params, tm = pair
    prompts = _prompts()
    jeng = jax_build_engine_v2(
        jm, params, cache_config=JaxKVCacheConfig(num_blocks=64, block_size=4,
                                                  max_seq_len=64), **V2)
    want = jeng.generate(prompts, max_new_tokens=N_NEW)
    eng = build_engine_v2(tm, cache_config=KVCacheConfig(
        num_blocks=64, block_size=4, max_seq_len=64), device="cpu", **V2)
    got = eng.generate(prompts, max_new_tokens=N_NEW)
    assert got == want
    assert eng.scheduler.allocator.num_free == 63  # every page returned
    assert eng.stats["decode_steps"] > 0 and eng.stats["prefill_calls"] >= 3


def test_v2_matches_port_v1(pair):
    """The port's own v1 and v2 agree (the card's ``agree`` phase, here on
    the plain versions)."""
    _, _, tm = pair
    prompts = _prompts(seed=4)
    eng = build_engine_v2(tm, cache_config=KVCacheConfig(
        num_blocks=64, block_size=4, max_seq_len=64), device="cpu", **V2)
    got = eng.generate(prompts, max_new_tokens=N_NEW)
    v1 = init_inference(tm, device="cpu")
    for prompt, g in zip(prompts, got):
        want = v1.generate([prompt], max_new_tokens=N_NEW)[0, len(prompt):]
        assert g == want.tolist()


# ---------------------------------------------------------------------------
# allocator + scheduler (as tests/unit/inference/test_v2.py)
# ---------------------------------------------------------------------------

def test_block_allocator_reserves_page0_and_catches_double_free():
    a = BlockAllocator(8)
    assert a.num_free == 7  # page 0 reserved
    blocks = a.allocate(7)
    assert sorted(blocks) == list(range(1, 8))
    with pytest.raises(MemoryError):
        a.allocate(1)
    a.free(blocks[:3])
    assert a.num_free == 3
    with pytest.raises(ValueError, match="double free"):
        a.free([blocks[0]])
    with pytest.raises(ValueError, match="out-of-range"):
        a.free([0])


def test_request_larger_than_pool_rejected_at_add():
    cache = KVCacheConfig(num_blocks=4, block_size=4, max_seq_len=64)
    s = RaggedScheduler(cache, max_batch_slots=2, prefill_chunk=4)
    with pytest.raises(ValueError, match="pages"):
        s.add_request([1] * 20, max_new_tokens=10)
    with pytest.raises(ValueError, match="prompt"):
        s.add_request([], max_new_tokens=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        s.add_request([1], max_new_tokens=0)


def test_scheduler_admission_respects_pool():
    cache = KVCacheConfig(num_blocks=5, block_size=4, max_seq_len=16)
    s = RaggedScheduler(cache, max_batch_slots=4, prefill_chunk=4)
    r1 = s.add_request([1] * 8, max_new_tokens=4)  # 3 of 4 pages
    r2 = s.add_request([1] * 8, max_new_tokens=4)  # must wait
    chunks, _ = s.plan_step()
    assert chunks and chunks[0].request is r1
    assert r1.state is RequestState.PREFILL
    assert r2.state is RequestState.WAITING
    s.cancel(r1)  # pages come back → r2 admitted
    assert s.allocator.num_free == 4
    chunks, _ = s.plan_step()
    assert chunks[0].request is r2


def test_split_fuse_chunking():
    cache = KVCacheConfig(num_blocks=32, block_size=4, max_seq_len=32)
    s = RaggedScheduler(cache, max_batch_slots=2, prefill_chunk=8)
    req = s.add_request(list(range(1, 21)), max_new_tokens=2)  # 20 tokens
    for want in ((8, 0, False), (8, 8, False), (4, 16, True)):
        chunk, = s.plan_step()[0]
        assert (chunk.n_valid, chunk.start_pos, chunk.is_last) == want
        s.chunk_done(chunk, 7 if chunk.is_last else None)
    assert req.state is RequestState.RUNNING
    assert req.generated == [7]
    # a burst accepts the slot's column up to the budget
    s.decode_burst_done([req], np.array([[9, 0], [11, 0]]))
    assert req.generated == [7, 9] and req.state is RequestState.DONE
    assert s.allocator.num_free == 31
