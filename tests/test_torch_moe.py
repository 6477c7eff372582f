"""The port's MoE gating, index routing, dispatch/combine and MoE layer
against the JAX package, on the same numpy inputs.

* ``_gating_core``, ``top_k_gating`` and ``top_k_gating_indices`` on
  identical fp32 logits, k 1 and 2, with and without drops: expert
  indices, slots, ``keep``, ``exp_counts`` and the dispatch mask exact;
  gates, combine weights, ``l_aux``, ``load``, ``entropy``,
  ``overflow_frac`` and ``drop_rate`` within 1e-6;
* ``routing_to_indices`` exact;
* dispatch and combine (the plain versions the wrappers run on CPU tensors)
  against JAX's: dispatch exact, combine within 1e-6; the wrappers'
  gradients against the JAX ``custom_vjp`` backward
  (``_pallas_dispatch_vjp_bwd`` / ``_pallas_combine_vjp_bwd``, called
  directly) within 1e-6.  The Pallas bodies themselves do not trace under
  the installed JAX (``pl.load`` is gone from ``jax.experimental.pallas``),
  so the JAX side of the forward is its jnp reference, which its own test
  holds bit-equal to the interpret-mode kernel;
* ``MOELayer`` at every rung, forward and gradients against the JAX layer
  at the same rung (on the CPU JAX's ``pallas`` rung runs its reference),
  within 1e-5;
* ``choose_dispatch_impl`` as ``test_choose_dispatch_impl_crossover``;
* random token selection and RSample: deterministic under one generator,
  and RTS changes which tokens drop, not how many (the draws are
  ``torch.Generator``'s, so they are held to these properties, not to
  ``jax.random``'s bits).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe.layer import swiglu_expert_fn as jax_swiglu
from deepspeed_tpu.ops.pallas import moe_dispatch as jmd
from deepspeed_tpu_torch.moe import MoE, MOELayer, TopKGate
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.moe.layer import swiglu_expert_fn

# the package exports the wrapper under the module's name
tmd = importlib.import_module("deepspeed_tpu_torch.ops.kernels.moe_dispatch")

#: (T, E, k, C): k 1 and 2, capacity tight (drops) and ample (none)
GATING_CASES = {"k1_drops": (64, 4, 1, 8), "k1_ample": (64, 4, 1, 64),
                "k2_drops": (64, 4, 2, 20), "k2_ample": (48, 8, 2, 24),
                "k2_min_cap": (5, 8, 2, 4)}


def _logits(T, E, seed=0):
    return np.random.RandomState(seed).randn(T, E).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(_np(got).astype(np.float64),
                               _np(want).astype(np.float64), rtol=tol,
                               atol=tol)


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


META_KEYS = ("l_aux", "exp_counts", "load", "entropy", "overflow_frac")


@pytest.mark.parametrize("case", sorted(GATING_CASES))
def test_gating_core_matches_jax(case):
    T, E, k, C = GATING_CASES[case]
    lg = _logits(T, E, seed=T + C)
    want = jsm._gating_core(jnp.asarray(lg), k, C, None, None, True, None)
    got = tsm._gating_core(torch.from_numpy(lg), k, C, None, None, True,
                           None)
    for name in ("idxs", "positions", "within", "masks"):
        for g, w in zip(got[name], want[name]):
            _equal(g, w)
    for g, w in zip(got["gate_k"], want["gate_k"]):
        _close(g, w)
    _close(got["gates"], want["gates"])
    for key in META_KEYS:
        _close(got["meta"][key], want["meta"][key])
    if case.endswith("drops"):
        assert float(got["meta"]["overflow_frac"]) > 0


@pytest.mark.parametrize("case", sorted(GATING_CASES))
def test_top_k_gating_both_forms_match_jax(case):
    T, E, k, C = GATING_CASES[case]
    lg = _logits(T, E, seed=2 * T + C)
    jc, jd, jl, jmeta = jsm.top_k_gating(jnp.asarray(lg), k, C)
    tc, td, tl, tmeta = tsm.top_k_gating(torch.from_numpy(lg), k, C)
    _equal(td, jd)
    _close(tc, jc)
    _close(tl, jl)
    for key in META_KEYS + ("drop_rate",):
        _close(tmeta[key], jmeta[key])
    jgi, jl2, jmeta2 = jsm.top_k_gating_indices(jnp.asarray(lg), k, C)
    tgi, tl2, tmeta2 = tsm.top_k_gating_indices(torch.from_numpy(lg), k, C)
    for name in ("expert_idx", "slot", "keep"):
        _equal(getattr(tgi, name), getattr(jgi, name))
    assert tgi.expert_idx.dtype == tgi.slot.dtype == torch.int32
    _close(tgi.gate, jgi.gate)
    _close(tl2, jl2)
    _close(tmeta2["drop_rate"], jmeta2["drop_rate"])
    assert (tgi.capacity, tgi.num_experts) == (C, E)
    # the index form and the dense form are one decision
    src, flat = tmd.routing_to_indices(tgi.expert_idx, tgi.slot, tgi.keep,
                                       E, C)
    dense_src = torch.full((E, C), tmd.EMPTY_SLOT, dtype=torch.int32)
    t_, e_, c_ = torch.nonzero(td, as_tuple=True)
    dense_src[e_, c_] = t_.to(torch.int32)
    _equal(src, dense_src)
    assert np.asarray(tmeta) .sum() == float(tmeta["exp_counts"].sum())


def _routing(T=64, E=4, C=20, k=2, seed=0):
    """A capacity-stressed routing decision, for both packages."""
    lg = _logits(T, E, seed)
    jgi, _, _ = jsm.top_k_gating_indices(jnp.asarray(lg), k, C)
    tgi, _, _ = tsm.top_k_gating_indices(torch.from_numpy(lg), k, C)
    return jgi, tgi


def test_routing_to_indices_matches_jax():
    for k, C in ((1, 8), (2, 20), (2, 64)):
        jgi, tgi = _routing(k=k, C=C, seed=C)
        jsrc, jflat = jmd.routing_to_indices(jgi.expert_idx, jgi.slot,
                                             jgi.keep, 4, C)
        tsrc, tflat = tmd.routing_to_indices(tgi.expert_idx, tgi.slot,
                                             tgi.keep, 4, C)
        assert tsrc.dtype == tflat.dtype == torch.int32
        _equal(tsrc, jsrc)
        _equal(tflat, jflat)
        # tight capacities drop assignments; the ample one leaves slots empty
        assert bool((tflat == 4 * C).any()) == (C < 64)
        assert bool((tsrc == tmd.EMPTY_SLOT).any()) == (C == 64)


def _dispatch_inputs(seed, T=64, E=4, C=20, H=16):
    jgi, tgi = _routing(T, E, C, seed=seed)
    jsrc, jflat = jmd.routing_to_indices(jgi.expert_idx, jgi.slot, jgi.keep,
                                         E, C)
    tsrc, tflat = tmd.routing_to_indices(tgi.expert_idx, tgi.slot, tgi.keep,
                                         E, C)
    rng = np.random.RandomState(seed + 1)
    tokens = rng.randn(T, H).astype(np.float32)
    eo = rng.randn(E, C, H).astype(np.float32)
    return (jsrc, jflat, jgi.gate.T), (tsrc, tflat, tgi.gate.t()), tokens, eo


def test_dispatch_and_combine_match_jax():
    (jsrc, jflat, jg), (tsrc, tflat, tg), tokens, eo = _dispatch_inputs(3)
    want = jmd.dispatch_reference(jnp.asarray(tokens), jsrc)
    _equal(tmd.dispatch_reference(torch.from_numpy(tokens), tsrc), want)
    _equal(tmd.moe_dispatch(torch.from_numpy(tokens), tsrc), want)
    want_y = jmd.combine_reference(jnp.asarray(eo), jflat, jg)
    _close(tmd.combine_reference(torch.from_numpy(eo), tflat, tg), want_y)
    _close(tmd.moe_combine(torch.from_numpy(eo), tflat, tg), want_y)
    # a dropped assignment contributes nothing, an empty slot is zero
    assert (_np(tmd.moe_dispatch(torch.from_numpy(tokens), tsrc))[
        _np(tsrc) < 0] == 0).all()
    assert tmd.moe_dispatch_fwd.launches == 0  # CPU calls never count


def test_dispatch_and_combine_gradients_match_jax_vjp():
    (jsrc, jflat, jg), (tsrc, tflat, tg), tokens, eo = _dispatch_inputs(5)
    T, H = tokens.shape
    E, C, _ = eo.shape
    rng = np.random.RandomState(6)
    g_buf = rng.randn(E, C, H).astype(np.float32)
    g_y = rng.randn(T, H).astype(np.float32)
    # the JAX custom_vjp backward, called as JAX calls it
    want_tok, _ = jmd._pallas_dispatch_vjp_bwd(
        False, ((T, H), jsrc), jnp.asarray(g_buf))
    want_eo, _, want_gates = jmd._pallas_combine_vjp_bwd(
        False, (jnp.asarray(eo), jflat, jg), jnp.asarray(g_y))
    tok = torch.from_numpy(tokens).requires_grad_()
    tmd.moe_dispatch(tok, tsrc).backward(torch.from_numpy(g_buf))
    _close(tok.grad, want_tok)
    eo_t = torch.from_numpy(eo).requires_grad_()
    gates = tg.clone().requires_grad_()
    tmd.moe_combine(eo_t, tflat, gates).backward(torch.from_numpy(g_y))
    _close(eo_t.grad, want_eo)
    _close(gates.grad, want_gates)
    # and the same as autograd through the plain versions
    tok2 = torch.from_numpy(tokens).requires_grad_()
    tmd.dispatch_reference(tok2, tsrc).backward(torch.from_numpy(g_buf))
    _close(tok.grad, tok2.grad)


def _layer_inputs(E=4, H=16, I=32, T=64, seed=7):
    rng = np.random.RandomState(seed)
    wg = (rng.randn(H, E) * 0.5).astype(np.float32)
    ew = {"w_gate": (rng.randn(E, H, I) * 0.1).astype(np.float32),
          "w_up": (rng.randn(E, H, I) * 0.1).astype(np.float32),
          "w_down": (rng.randn(E, I, H) * 0.1).astype(np.float32)}
    x = rng.randn(2, T // 2, H).astype(np.float32)
    return wg, ew, x


@pytest.mark.parametrize("impl", ["dense", "sparse", "pallas", "auto"])
@pytest.mark.parametrize("cf", [0.75, 4.0], ids=["drops", "no_drops"])
def test_moe_layer_matches_jax_at_each_rung(impl, cf):
    wg, ew, x = _layer_inputs()
    jlayer = jsm.MOELayer(jsm.TopKGate(num_experts=4, k=2,
                                       capacity_factor=cf, min_capacity=4),
                          jax_swiglu, dispatch_impl=impl)

    def jloss(wg, ew, x):
        y, l_aux, _ = jlayer(wg, ew, x)
        return jnp.sum(y ** 2) + l_aux, y

    (want_val, want_y), want_g = jax.value_and_grad(
        jloss, (0, 1, 2), has_aux=True)(jnp.asarray(wg),
                                        jax.tree.map(jnp.asarray, ew),
                                        jnp.asarray(x))
    tlayer = MOELayer(TopKGate(num_experts=4, k=2, capacity_factor=cf,
                               min_capacity=4), swiglu_expert_fn,
                      dispatch_impl=impl)
    twg = torch.from_numpy(wg).requires_grad_()
    tew = {k: torch.from_numpy(v).requires_grad_() for k, v in ew.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, l_aux, meta = tlayer(twg, tew, tx)
    (y.square().sum() + l_aux).backward()
    assert tlayer.last_impl == jlayer.last_impl
    tol = 1e-5
    _close(y, want_y, tol)
    _close(y.square().sum() + l_aux, want_val, tol)
    _close(twg.grad, want_g[0], tol)
    for name in ew:
        _close(tew[name].grad, want_g[1][name], tol)
    _close(tx.grad, want_g[2], tol)
    assert set(meta) >= {"l_aux", "exp_counts", "drop_rate", "load",
                         "entropy", "overflow_frac"}
    assert (float(meta["drop_rate"]) > 0) == (cf < 2)


def test_choose_dispatch_impl_table():
    """As ``test_choose_dispatch_impl_crossover``, with the port's device
    rule: above the crossover a CUDA tensor takes the kernels, anything
    else the plain sparse rung."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cases = [  # (impl, T, E, C, device, want)
        ("auto", 64, 4, 16, cuda, "dense"),
        ("auto", 64, 4, 256, cuda, "dense"),   # exactly 1 << 16
        ("auto", 64, 4, 257, cuda, "pallas"),
        ("auto", 8192, 8, 2048, cuda, "pallas"),
        ("auto", 8192, 8, 2048, cpu, "sparse"),
        ("auto", 8192, 8, 2048, None, "sparse"),
        ("pallas", 64, 4, 16, cpu, "pallas"),
        ("pallas", 64, 4, 16, cuda, "pallas"),
        ("dense", 8192, 8, 2048, cuda, "dense"),
        ("sparse", 64, 4, 16, cuda, "sparse")]
    for impl, T, E, C, dev, want in cases:
        got = tmd.choose_dispatch_impl(impl, T, E, C, device=dev)
        assert got == want, (impl, T, E, C, dev)
        if dev is not cuda:  # off the TPU, JAX resolves as the CPU does
            assert jmd.choose_dispatch_impl(impl, T, E, C) == want
    assert tmd.DENSE_CROSSOVER_TEC == jmd.DENSE_CROSSOVER_TEC == 1 << 16
    with pytest.raises(ValueError, match="unknown moe dispatch impl"):
        tmd.choose_dispatch_impl("tutel", 64, 4, 16)


def test_capacity_matches_jax():
    for T in (1, 5, 64, 2048, 2049):
        for k, f, E in ((1, 1.0, 4), (2, 2.0, 8), (2, 1.25, 4)):
            jg = jsm.TopKGate(num_experts=E, k=k, capacity_factor=f)
            tg = TopKGate(num_experts=E, k=k, capacity_factor=f)
            assert tg.capacity(T) == jg.capacity(T)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_rts_deterministic_and_seed_dependent():
    lg = torch.from_numpy(_logits(64, 4, 9))
    d1 = tsm.top_k_gating(lg, 1, 4, rts_rng=_gen(42))[1]
    d2 = tsm.top_k_gating(lg, 1, 4, rts_rng=_gen(42))[1]
    assert torch.equal(d1, d2)
    d = [tsm.top_k_gating(lg, 1, 4, rts_rng=_gen(s))[1] for s in range(6)]
    assert any(not torch.equal(a, d[0]) for a in d[1:])


def test_rts_changes_which_tokens_drop_not_how_many():
    lg = torch.from_numpy(_logits(64, 4, 9))
    _, d_fifo, _, m_fifo = tsm.top_k_gating(lg, 1, 4)
    _, d_rts, _, m_rts = tsm.top_k_gating(lg, 1, 4, rts_rng=_gen(3))
    _close(m_rts["overflow_frac"], m_fifo["overflow_frac"])
    assert int(d_rts.sum()) == int(d_fifo.sum())
    assert not torch.equal(d_rts, d_fifo)


def test_rsample_noise_routes_deterministically_under_one_generator():
    lg = torch.from_numpy(_logits(64, 4, 11))
    gate = TopKGate(num_experts=4, k=2, capacity_factor=2.0,
                    noisy_gate_policy="RSample", use_rts=True)
    wg = torch.eye(4)
    a = gate.route(wg, lg, noise_rng=_gen(1))[0]
    b = gate.route(wg, lg, noise_rng=_gen(1))[0]
    c = gate.route(wg, lg, noise_rng=_gen(2))[0]
    assert torch.equal(a.expert_idx, b.expert_idx)
    assert torch.equal(a.slot, b.slot)
    assert not torch.equal(a.expert_idx, c.expert_idx)
    # no noise and no RTS outside training, and none without a generator
    clean = gate.route(wg, lg)[0]
    assert torch.equal(gate.route(wg, lg, train=False,
                                  noise_rng=_gen(1))[0].expert_idx,
                       clean.expert_idx)
    # the gates are the softmax of the clean logits, renormalised
    jgi, _, _ = jsm.top_k_gating_indices(jnp.asarray(lg.numpy()), 2,
                                         gate.capacity(64))
    _equal(clean.expert_idx, jgi.expert_idx)


def test_moe_block_surface():
    with pytest.raises(ValueError, match="use_tutel"):
        MoE(hidden_size=16, num_experts=4, use_tutel=True)
    # Residual-MoE is ported: the residual MLP and the coefficient join
    # the parameters, and the placement names every leaf (JAX's
    # test_moe_residual_path)
    res = MoE(hidden_size=16, num_experts=4, use_residual=True)
    res_params = res.init_params(_gen(0), intermediate_size=32)
    assert {"residual_mlp", "coefficient"} <= set(res_params)
    assert set(res.param_specs()) == set(res_params)
    with pytest.raises(ValueError, match="ep_size"):
        MoE(hidden_size=16, num_experts=4, ep_size=3)
    moe = MoE(hidden_size=16, num_experts=4, k=2, capacity_factor=4.0,
              use_rts=False)
    params = moe.init_params(_gen(0), intermediate_size=32)
    assert params["experts"]["w_down"].shape == (4, 32, 16)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 16)
                         .astype(np.float32))
    y, l_aux, meta = moe(params, x)
    assert y.shape == x.shape and l_aux.dim() == 0
    assert np.asarray(meta).sum() == 2 * 8  # the exp_counts shim
