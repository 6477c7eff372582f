"""The port's Llama (inference half) against the JAX model, same weights.

Weights come from the JAX ``init_params`` through
``llama_params_from_jax``.  Everything runs in fp32 on the CPU; logits are
compared at atol 1e-4 (same arithmetic in another summation order over
four layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import LlamaModel, llama_params_from_jax
from deepspeed_tpu_torch.models import llama as port_llama
from torch_parity import jax_tiny, port_config, port_model

ATOL = 1e-4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=[None, 5], ids=["full", "window5"])
def pair(request):
    """(JAX model, params, port model); ``window5`` has a sliding window
    shorter than the prompts."""
    jm, params = jax_tiny(sliding_window=request.param)
    return jm, params, port_model(jm, params)


def test_weight_bridge_layouts():
    jm, params = jax_tiny(num_layers=2)
    tm = port_model(jm, params)
    lp = params["layers"]
    c = jm.config
    H, hd = c.hidden_size, c.hd
    np.testing.assert_array_equal(
        _np(tm.layers[1].q_proj.weight),
        np.asarray(lp["attn"]["wq"][1]).reshape(H, -1).T)
    np.testing.assert_array_equal(
        _np(tm.layers[0].o_proj.weight),
        np.asarray(lp["attn"]["wo"][0]).reshape(c.num_heads * hd, H).T)
    np.testing.assert_array_equal(_np(tm.layers[1].down_proj.weight),
                                  np.asarray(lp["mlp"]["w_down"][1]).T)
    np.testing.assert_array_equal(_np(tm.lm_head.weight),
                                  np.asarray(params["lm_head"]).T)
    np.testing.assert_array_equal(_np(tm.embed.weight),
                                  np.asarray(params["embed"]))


def test_weight_bridge_tied_embeddings_and_bf16():
    """No ``lm_head`` with tied embeddings; a bf16 model stores the fp32
    masters rounded once, as the JAX model casts them at use."""
    jm, params = jax_tiny(num_layers=1, tie_embeddings=True)
    assert "lm_head" not in params
    tm = port_model(jm, params)
    assert tm.lm_head is None
    assert tm.head_weight() is tm.embed.weight
    bf = LlamaModel(dataclasses.replace(port_config(jm.config),
                                        dtype=torch.bfloat16), device="cpu")
    bf.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    want = np.asarray(params["layers"]["attn"]["wk"][0].astype(
        jnp.bfloat16).astype(jnp.float32)).reshape(jm.config.hidden_size, -1)
    np.testing.assert_array_equal(_np(bf.layers[0].k_proj.weight),
                                  want.T)


def test_init_params_is_seeded_and_scaled():
    cfg = port_llama.LlamaConfig.tiny(num_layers=1, dtype=torch.float32)
    a = port_llama.LlamaModel(cfg, device="cpu", seed=3)
    b = port_llama.LlamaModel(cfg, device="cpu", seed=3)
    c = port_llama.LlamaModel(cfg, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if pa.dim() == 2:
            assert not torch.equal(pa, pc), name
    w = a.layers[0].down_proj.weight  # fan_in = intermediate
    assert abs(w.std().item() * np.sqrt(cfg.intermediate_size) - 1) < 0.05
    assert torch.equal(a.layers[0].attn_norm, torch.ones(cfg.hidden_size))


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32) * 3
    w = rng.randn(64).astype(np.float32)
    want = jax_llama._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = port_llama._rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                               1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # bf16: normalise in fp32, cast, then scale in bf16
    want = jax_llama._rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16), 1e-5)
    got = port_llama._rms_norm(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(w).bfloat16(), 1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_jax(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 4, 32).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = jax_llama._rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = port_llama._rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _ids(B, S, seed):
    return np.random.RandomState(seed).randint(1, 512, size=(B, S)).astype(
        np.int32)


def test_forward_matches_jax(pair):
    jm, params, tm = pair
    ids = _ids(2, 12, 0)
    want = np.asarray(jm.forward(params, jnp.asarray(ids)))
    got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill logits and caches, then two decode steps' logits."""
    jm, params, tm = pair
    B, S, max_len = 2, 9, 16
    ids = _ids(B, S, 1)
    jcache = jm.init_cache(B, max_len)
    jlogits, jcache = jax.jit(jm.prefill)(params, jnp.asarray(ids), jcache)
    tcache = tm.init_cache(B, max_len)
    tlogits, tcache = tm.prefill(torch.from_numpy(ids), tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=ATOL, atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]),
                                   rtol=ATOL, atol=ATOL)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))
    decode = jax.jit(jm.decode_step)
    toks = _ids(2, B, 2)
    for step in range(2):
        jlogits, jcache = decode(params, jcache, jnp.asarray(toks[step]))
        tlogits, tcache = tm.decode_step(tcache, torch.from_numpy(toks[step]))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_array_equal(tcache["lengths"].numpy(), [S + 2] * B)
