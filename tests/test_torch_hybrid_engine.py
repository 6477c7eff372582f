"""The hybrid engine of the port against the JAX package's.

``hybrid_engine.enabled`` makes ``initialize`` return a
``DeepSpeedHybridEngine`` (it was accepted without effect before, ROADMAP
Queue 3's open fault 1).  On the tiny Llama (fp32, the JAX model's weights
carried across), after one ``train_step`` of each engine on the same batch:

* greedy tokens equal JAX's ``DeepSpeedHybridEngine.generate`` on its own
  updated weights, and the eos rule gives JAX's tokens too (a finished row
  repeats its last token; every 8 tokens the all-done check ends the loop
  and pads);
* sampled tokens (``temperature`` 1, ``top_k`` 3) are each among the 3
  largest logits of the model at that position, and one seed gives one
  draw;
* the typed config group, the passthrough of the training surface, and
  the refusal under ``offload_param``.

The ZeRO-3 case joins ``tests/torch_zero_ranks.py``'s launch
(``test_torch_zero``), the tensor-parallel one ``tests/torch_tp_ranks.py``'s
(``test_torch_tp_train``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from test_torch_train import _ids, training_pair
from torch_parity import free_jax_cycles  # noqa: F401

CONFIG = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
          "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}},
          "hybrid_engine": {"enabled": True, "max_out_tokens": 8}}
PROMPT = _ids(2, 6, 3)


@pytest.fixture(scope="module")
def engines():
    """(JAX hybrid engine, the port's), each after one step on the same
    batch from the same weights."""
    jm, params, tm = training_pair(num_layers=2)
    batch = _ids(2, 16, 40)
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    try:
        jeng, *_ = jdst.initialize(model=jm, model_parameters=params,
                                   config=CONFIG, mesh=mesh)
        jeng.train_step({"input_ids": jnp.asarray(batch)})
    finally:
        groups.reset_mesh()
    teng, *_ = dst.initialize(model=tm, config=CONFIG, device="cpu")
    teng.train_step({"input_ids": torch.from_numpy(batch)})
    return jeng, teng


def test_initialize_returns_the_hybrid_engine(engines):
    _, teng = engines
    assert isinstance(teng, dst.DeepSpeedHybridEngine)
    assert "hybrid_engine" not in teng.config.accepted_without_effect
    assert teng.config.hybrid_engine.max_out_tokens == 8
    # the training surface passes through
    assert teng.global_steps == 1
    assert teng.get_lr() == pytest.approx([3e-3])
    assert teng.eval() is teng and teng.train() is teng
    cfg = DeepSpeedConfig.from_dict({"hybrid_engine": {
        "enabled": True, "inference_tp_size": 2, "pin_parameters": False,
        "release_inference_cache": True, "tp_gather_partition_size": 4}})
    h = cfg.hybrid_engine
    assert (h.enabled, h.max_out_tokens, h.inference_tp_size,
            h.release_inference_cache, h.pin_parameters,
            h.tp_gather_partition_size) == (True, 512, 2, True, False, 4)
    plain, *_ = dst.initialize(model=training_pair(num_layers=1)[2],
                               config=dict(CONFIG, hybrid_engine={}),
                               device="cpu")
    assert type(plain).__name__ == "DeepSpeedEngine"


def test_greedy_tokens_after_a_step_equal_jax(engines):
    jeng, teng = engines
    want = np.asarray(jeng.generate(jnp.asarray(PROMPT)))
    got = teng.generate(torch.from_numpy(PROMPT))
    assert got.shape == (2, 6 + 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng._gen_tokens == 2 * 8
    teng.print_latency_log()
    teng.release_inference_cache()


def test_eos_rule_equals_jax(engines):
    """Row 0's first greedy token as eos: a batch of that row alone ends
    at the first all-done check (token 8) and pads to 20 tokens; with the
    second row, row 0 repeats its eos while row 1 runs on."""
    jeng, teng = engines
    first = int(teng.generate(torch.from_numpy(PROMPT[:1]),
                              max_new_tokens=1)[0, -1])
    for prompt, n in ((PROMPT[:1], 20), (PROMPT, 12)):
        before = teng._gen_tokens
        got = teng.generate(torch.from_numpy(prompt), max_new_tokens=n,
                            eos_token_id=first)
        want = np.asarray(jeng.generate(jnp.asarray(prompt),
                                        max_new_tokens=n,
                                        eos_token_id=first))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == (prompt.shape[0], 6 + n)
        assert (got[0, 6:] == first).all()
        if prompt.shape[0] == 1:  # one token counted, the rest padding
            assert teng._gen_tokens - before == 1


def test_top_k_samples_are_inside_the_top_k(engines):
    _, teng = engines
    k = 3
    out = teng.generate(torch.from_numpy(PROMPT), max_new_tokens=8,
                        temperature=1.0, top_k=k, seed=5)
    again = teng.generate(torch.from_numpy(PROMPT), max_new_tokens=8,
                          temperature=1.0, top_k=k, seed=5)
    assert torch.equal(out, again)
    logits = teng.module(out[:, :-1])  # the no-grad forward
    for i in range(6, out.shape[1]):
        top = torch.topk(logits[:, i - 1], k, dim=-1).indices
        assert (top == out[:, i:i + 1]).any(dim=-1).all(), i


def test_hybrid_engine_refuses_offload_param():
    tm = training_pair(num_layers=1)[2]
    with pytest.raises(NotImplementedError, match="offload_param"):
        dst.initialize(model=tm, config=dict(
            CONFIG, zero_optimization={"stage": 3, "offload_param": {
                "device": "cpu"}}), device="cpu")
