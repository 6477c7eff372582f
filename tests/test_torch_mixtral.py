"""The port's Mixtral against the JAX Mixtral, from one init.

``MixtralConfig.tiny`` with 2 layers (8/4 heads, 4 experts, top-2); the JAX
model draws the weights and ``mixtral_params_from_jax`` carries them into
the port.  Everything runs on the CPU, where the dispatch and combine
wrappers run their plain versions.

* fp32 logits within 1e-4;
* the training loss (cross entropy + ``aux_loss_coef`` x the summed
  router losses) within 1e-5 and per-leaf gradients within 1e-4, at
  ``moe_dispatch_impl`` ``dense`` and ``pallas``, with remat;
* v1 ``generate`` greedy tokens equal JAX v1's;
* v2 greedy tokens equal JAX v2's at equal engine knobs (every padded
  token takes capacity in both), and the port's v2 equals its own v1
  (``k x capacity_factor >= E``: no drops, so a token's output does not
  depend on the tokens batched with it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference.v2 import KVCacheConfig as JaxKVCacheConfig
from deepspeed_tpu.inference.v2 import build_engine_v2 as jax_build_engine_v2
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu_torch import (KVCacheConfig, MixtralConfig, MixtralModel,
                                 build_engine_v2, init_inference)
from deepspeed_tpu_torch.models import (llama_grads_to_jax_layout,
                                        mixtral_params_from_jax)
from torch_parity import free_jax_cycles  # noqa: F401

_SHARED = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
           "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
           "rope_theta", "rms_norm_eps", "tie_embeddings", "sliding_window",
           "remat", "num_experts", "top_k", "capacity_factor",
           "aux_loss_coef", "moe_dispatch_impl")


def mixtral_pair(seed=0, **kw):
    """(JAX Mixtral in fp32, its params, the port's Mixtral on the CPU with
    the same weights as fp32 masters)."""
    jcfg = JaxMixtralConfig.tiny(num_layers=2, dtype=jnp.float32, **kw)
    jm = JaxMixtralModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    cfg = MixtralConfig(dtype=torch.float32, param_dtype=torch.float32,
                        **{f: getattr(jcfg, f) for f in _SHARED})
    tm = MixtralModel(cfg, device="cpu")
    host = jax.tree.map(np.asarray, jax.device_get(params))
    tm.load_state_dict(mixtral_params_from_jax(host), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return mixtral_pair(max_seq_len=64)


def _ids(B, S, seed):
    return np.random.RandomState(seed).randint(1, 512, (B, S)).astype(
        np.int32)


def test_layout_and_counts(pair):
    jm, params, tm = pair
    moe = params["layers"]["moe"]
    for i in range(2):
        for name in ("wg", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                getattr(tm.layers[i], name).detach().numpy(),
                np.asarray(moe[name][i]))
    assert not hasattr(tm.layers[0], "gate_proj")
    c = tm.config
    n = sum(p.numel() for p in tm.parameters())
    assert c.num_params() == n == sum(
        x.size for x in jax.tree.leaves(params))
    expert = 3 * c.hidden_size * c.intermediate_size
    assert c.num_params() - c.active_params() == \
        c.num_layers * (c.num_experts - c.top_k) * expert


def test_logits_match_jax(pair):
    jm, params, tm = pair
    ids = _ids(2, 24, 0)
    want = np.asarray(jm.forward(params, jnp.asarray(ids)))
    got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_loss_and_grads_match_jax(impl):
    jm, params, tm = mixtral_pair(seed=1, moe_dispatch_impl=impl)
    ids = _ids(2, 16, 2)
    want_loss, want_grads = jax.value_and_grad(jm.loss)(
        params, {"input_ids": jnp.asarray(ids)})
    loss = tm.loss({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    hidden, aux = tm.hidden_states(torch.from_numpy(ids))
    assert aux.item() > 0  # the routers' loss is in the sum
    got = llama_grads_to_jax_layout(tm)
    want = jax.device_get(want_grads)

    def walk(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=1e-4,
                                   atol=2e-6, err_msg=path)

    walk(got, want, "")
    assert np.abs(got["layers"]["moe"]["wg"]).max() > 0


def test_v1_greedy_matches_jax(pair):
    jm, params, tm = pair
    ids = _ids(2, 11, 3)
    want = np.asarray(jax_init_inference(model=jm, model_params=params,
                                         dtype=jnp.float32).generate(
        jnp.asarray(ids), max_new_tokens=6))
    got = init_inference(tm, device="cpu").generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


V2 = dict(max_batch_slots=2, prefill_chunk=8, prefill_batch=2,
          decode_burst=4)


def test_v2_greedy_matches_jax_and_port_v1(pair):
    jm, params, tm = pair
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 512, size=n).tolist() for n in (4, 11, 19)]
    want = jax_build_engine_v2(
        jm, params, cache_config=JaxKVCacheConfig(
            num_blocks=64, block_size=4, max_seq_len=64), **V2).generate(
        prompts, max_new_tokens=5)
    eng = build_engine_v2(tm, cache_config=KVCacheConfig(
        num_blocks=64, block_size=4, max_seq_len=64), device="cpu", **V2)
    got = eng.generate(prompts, max_new_tokens=5)
    assert got == want
    v1 = init_inference(tm, device="cpu")
    for prompt, g in zip(prompts, got):
        assert g == v1.generate([prompt], max_new_tokens=5)[
            0, len(prompt):].tolist()
