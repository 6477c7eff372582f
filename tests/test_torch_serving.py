"""The port's serving front-end against the JAX front-end, same script.

One scripted run drives both ``build_serving_frontend`` front-ends over the
tiny fp32 model: prompts that share a 16-token header, interactive, batch
and background classes, one cancelled request and one preempted one.  The
tokens, the prefix hit rate, the preemption count and the pages free after
completion must be equal.
"""

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import KVCacheConfig as JaxKVCacheConfig
from deepspeed_tpu.serving import \
    build_serving_frontend as jax_build_serving_frontend
from deepspeed_tpu_torch import KVCacheConfig, build_serving_frontend
from deepspeed_tpu_torch.serving import (NoHealthyReplicaError, Replica,
                                         ServingFrontend, ServingParams,
                                         ServingScheduler)
from torch_parity import jax_tiny, port_model

CACHE = dict(num_blocks=64, block_size=4, max_seq_len=64)
ENGINE = dict(replicas=1, max_batch_slots=2, prefill_chunk=8,
              prefill_batch=2, decode_burst=4)


def _script(fe):
    """The serving run both front-ends go through.  Returns the handles
    and what the scheduler saw."""
    rng = np.random.RandomState(5)
    header = rng.randint(1, 512, size=16).tolist()  # 4 full pages
    sched = fe.router.replicas[0].scheduler
    a = fe.submit(header + [7, 8, 9], max_new_tokens=12, klass="background")
    # a's last prefill chunk indexes the header pages in the trie
    while a.request is None or a.request.prefilled < len(a.prompt):
        fe.pump()
    b = fe.submit(header + rng.randint(1, 512, size=5).tolist(),
                  max_new_tokens=10, klass="background")
    fe.pump()
    # both slots are taken: the batch request waits (it cannot preempt)
    c = fe.submit(rng.randint(1, 512, size=6).tolist(), max_new_tokens=6,
                  klass="batch")
    fe.pump()
    assert (a.status, b.status, c.status) == ("running", "running", "queued")
    assert b.request.blocks[:4] == a.request.blocks[:4]  # shared header
    c.cancel()
    # the interactive head preempts a background request
    d = fe.submit(header + [3, 1], max_new_tokens=5, klass="interactive")
    fe.pump()
    preempted = [h.uid for h in (a, b) if h.preempted]
    fe.run_until_idle()
    return {"tokens": [h.result() for h in (a, b, c, d)],
            "status": [h.status for h in (a, b, c, d)],
            "preempted": preempted,
            "hit_rate": sched.prefix.hit_rate,
            "hit_tokens": sched.prefix.hit_tokens,
            "free": sched.allocator.num_free,
            "cached": sched.allocator.num_cached,
            "available": sched.allocator.num_available,
            "preemptions": sched.preemptions}


@pytest.fixture(scope="module")
def runs():
    jm, params = jax_tiny(num_layers=2, max_seq_len=64)
    jfe = jax_build_serving_frontend(
        jm, params, cache_config=JaxKVCacheConfig(**CACHE), **ENGINE)
    try:
        want = _script(jfe)
    finally:
        jfe.close()  # detach from the JAX package's process-wide hooks
    fe = build_serving_frontend(port_model(jm, params),
                                cache_config=KVCacheConfig(**CACHE),
                                serving_params=ServingParams(),
                                device="cpu", **ENGINE)
    return want, _script(fe), fe


def test_serving_tokens_match_jax(runs):
    want, got, _ = runs
    assert got["tokens"] == want["tokens"]
    assert got["status"] == want["status"] == ["done", "done", "cancelled",
                                               "done"]
    assert [len(t) for t in got["tokens"]] == [12, 10, 0, 5]


def test_serving_preemption_matches_jax(runs):
    want, got, _ = runs
    assert got["preempted"] == want["preempted"] and len(got["preempted"]) == 1
    assert got["preemptions"] == want["preemptions"] == 1


def test_serving_prefix_cache_matches_jax(runs):
    want, got, fe = runs
    for key in ("hit_rate", "hit_tokens", "free", "cached", "available"):
        assert got[key] == want[key], key
    assert got["hit_rate"] > 0
    assert got["available"] == CACHE["num_blocks"] - 1  # all pages back
    assert fe.prefix_hit_rate() == got["hit_rate"]
    assert isinstance(fe.router.replicas[0].scheduler, ServingScheduler)


def test_serving_metrics_and_snapshot(runs):
    _, _, fe = runs
    snap = fe.snapshot()
    assert snap["counters"]["cancelled"] == 1
    assert snap["counters"]["preemptions"] == 1
    assert snap["classes"]["interactive"]["completed"] == 1
    assert snap["classes"]["background"]["tokens"] == 22
    assert snap["router"]["replicas"][0]["healthy"] is True


def test_replica_death_drains_onto_a_healthy_replica():
    """Two replicas; one dies mid-generation.  Its request re-runs on the
    other replica and the stream continues past the delivered tokens, equal
    to an undisturbed greedy run."""
    jm, params = jax_tiny(num_layers=1, max_seq_len=64)
    model = port_model(jm, params)
    prompt = [9, 8, 7, 6, 5]

    def frontend(replicas):
        return build_serving_frontend(model, cache_config=KVCacheConfig(
            **CACHE), device="cpu", **dict(ENGINE, replicas=replicas))

    ref = frontend(1)
    want = ref.submit(prompt, max_new_tokens=9)
    ref.run_until_idle()
    fe = frontend(2)
    h = fe.submit(prompt, max_new_tokens=9)
    while h.delivered < 3:
        fe.pump()
    first = h.replica_id
    fe.router.replicas[first].mark_dead("test: replica lost")
    fe.run_until_idle()
    assert h.result() == want.result()
    assert h.replica_id != first and h.replays == 1
    assert fe.snapshot()["counters"]["requeued_replica_death"] == 1
    # a probe that reports dead keeps a replica out of placement
    engine = fe.router.replicas[1 - first].engine
    probed = ServingFrontend([Replica(engine, 0, probe=lambda: False)])
    with pytest.raises(NoHealthyReplicaError):
        probed.submit(prompt, max_new_tokens=2)
    assert probed.router.replicas[0].dead_reason == \
        "health probe reported dead"


def test_serving_validation_and_background_thread():
    jm, params = jax_tiny(num_layers=1, max_seq_len=64)
    fe = build_serving_frontend(port_model(jm, params),
                                cache_config=KVCacheConfig(**CACHE),
                                device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="klass"):
        fe.submit([1, 2], max_new_tokens=2, klass="premium")
    with pytest.raises(ValueError, match="prompt"):
        fe.submit([], max_new_tokens=2)
    fe.start()
    try:
        h = fe.submit([4, 5, 6], max_new_tokens=3)
        assert len(h.result(timeout=30)) == 3
    finally:
        fe.stop()
    assert h.status == "done" and h.ttft_ms is not None
