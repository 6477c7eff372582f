"""Expert and data parallelism of the port's MoE and Mixtral against the JAX
package, Mixtral under tensor parallelism, Residual-MoE and the ``moe``
config group.

One gloo launch on 2 ranks (layouts ``ep=2`` and ``dp=2``) and one on 4
(``ep=2 x dp=2``), each mesh built inside its launch (rank bodies in
``torch_ep_ranks``, no JAX there); the launches run in a thread while this
process computes the JAX side.

* routing: ``MOELayer(mesh=...)`` on every layout, dense and sparse rungs,
  fp32: each rank's output rows within 1e-5 of JAX's ``MOELayer`` on the
  same mesh and the same global batch; the capacity (with one case where
  the pad to the expert axis changes it), ``l_aux``, ``exp_counts`` and
  ``drop_rate`` equal JAX's and equal on every rank;
* training a tiny Mixtral (2 layers, fp32, JAX's weights, rank ``r`` fed
  JAX's device-``r`` rows) for 4 steps: at ZeRO 0 on each layout and ZeRO 3
  on ``ep=2 x dp=2`` against the JAX engine on the matching mesh (loss and
  grad norm within 1e-5 relative, ``lr`` equal, the parameters within
  ``_assert_updates_close``), and every case, ``moe.capacity_factor`` (drops)
  and gradient accumulation 2 included, against the same run in one
  process within 1e-5; replicated leaves bit-equal across ranks, each
  expert leaf across its ``data`` group;
* checkpoints: one process's save loads at ``ep=2`` bit for bit; the
  ranks' ``ep=2`` save loads in one process and at ``ep=2 x dp=2``
  (stage 3) bit for bit;
* Mixtral at ``tp=2``: v2 greedy tokens equal JAX's meshless engine's,
  first logits within 1e-4; v1 ``init_inference(tensor_parallel=...)``
  tokens equal JAX v1's;
* Residual-MoE forward and gradients within 1e-5 of JAX's;
* the ``moe`` config group reaches the gate and the layer, as JAX's
  ``_apply_moe_config`` pushes it.
"""

import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
import torch_ep_ranks as ranks
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference.v2 import KVCacheConfig as JaxKVCacheConfig
from deepspeed_tpu.inference.v2 import build_engine_v2 as jax_build_engine_v2
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu.moe.layer import MoE as JaxMoE
from deepspeed_tpu.moe.layer import swiglu_expert_fn as jax_swiglu
from deepspeed_tpu.moe.sharded_moe import MOELayer as JaxMOELayer
from deepspeed_tpu.moe.sharded_moe import TopKGate as JaxTopKGate
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.entry import \
    _apply_moe_config as jax_apply_moe_config
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import (llama_tree_to_jax_layout,
                                        mixtral_params_from_jax)
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.runtime.checkpointing import full_tensors
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.utils import zero_to_fp32
from test_torch_train import _assert_lr_equal, _assert_updates_close
from torch_parity import free_jax_cycles  # noqa: F401

TIMEOUT = 300
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _jax_model(mesh=None):
    return JaxMixtralModel(JaxMixtralConfig.tiny(dtype=jnp.float32,
                                                 **ranks.MODEL), mesh=mesh)


def _jax_mesh(layout: str):
    ep, dp = ranks.LAYOUTS[layout]
    return build_mesh(MeshLayout.infer(ep * dp, ep=ep, dp=dp),
                      devices=jax.devices()[:ep * dp])


@pytest.fixture(scope="module")
def weights():
    jm = _jax_model()
    port = ranks.config()
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "num_kv_heads", "max_seq_len", "rope_theta",
              "num_experts", "top_k", "capacity_factor", "aux_loss_coef",
              "remat"):
        assert getattr(port, f) == getattr(jm.config, f), f
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    host = jax.tree.map(np.asarray, params)
    return {k: v.numpy() for k, v in mixtral_params_from_jax(host).items()}


def _one_process(weights, name: str, load=None, save=None, steps=None):
    """The case's run in one process (``ep`` 1, every rank's rows in one
    micro-batch, the microbatches in the ranks' order): the step metrics
    and the engine."""
    cfg = ranks.case_config(name)
    world = ranks.world_of(ranks.TRAIN_CASES[name][0])
    cfg["moe"] = dict(cfg["moe"], expert_parallel_size=1)
    cfg["train_micro_batch_size_per_gpu"] = world
    cfg["zero_optimization"] = {"stage": 0}
    model = dst.MixtralModel(ranks.config(), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    if load is not None:
        engine.load_checkpoint(load)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for step in ranks.microbatches(name)[:steps]:
        m = engine.train_step({"input_ids": torch.from_numpy(
            np.concatenate(step))})
        for k in out:
            out[k].append(float(m[k]))
    if save is not None:
        engine.save_checkpoint(save)
    return out, engine


@pytest.fixture(scope="module")
def launched(weights, tmp_path_factory):
    """In a thread: one process's save, then the 2-rank launch (which
    loads it and saves at ``ep=2``), then the 4-rank one (which loads
    that).  ``get()`` waits for them."""
    root = tmp_path_factory.mktemp("ep_ckpt")
    ckpt = {k: str(root / k) for k in ("one", "ep2", "ep2dp2")}
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 512, size=n).tolist() for n in (4, 13)]
    serve = dict(prompts=prompts, n_new=5, v1_new=6,
                 ids=np.random.RandomState(0).randint(1, 512, size=(2, 11)))
    result = {}

    def run():
        try:
            _one_process(weights, "ep2_z0", save=ckpt["one"], steps=2)
            result[2] = launch(ranks.ep_rank, 2, (weights, ckpt, serve),
                               timeout=TIMEOUT)
            result[4] = launch(ranks.ep_rank, 4, (weights, ckpt, None),
                               timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    # the JAX side meanwhile, into the caches the tests read
    for name in ranks.ROUTE_CASES:
        _jax_route(name)
    for name in ranks.JAX_CASES:
        _jax_train(name)
    _jax_serve(serve)

    def get(world):
        thread.join()
        if "error" in result:
            raise result["error"]
        return result[world]
    yield {"get": get, "ckpt": ckpt, "serve": serve}
    thread.join()


def _world(layout: str) -> int:
    return ranks.world_of(layout)


# -- routing ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_route(name: str):
    layout, impl, _, _, factor = ranks.ROUTE_CASES[name]
    inp = ranks.route_inputs(name)
    gate = JaxTopKGate(num_experts=ranks.ROUTE_E, k=ranks.ROUTE_K,
                       capacity_factor=factor)
    layer = JaxMOELayer(gate, jax_swiglu, mesh=_jax_mesh(layout),
                        dispatch_impl=impl)
    experts = {k: jnp.asarray(inp[k]) for k in EXPERT_LEAVES}
    y, l_aux, meta = jax.jit(lambda wg, ex, x: layer(wg, ex, x))(
        jnp.asarray(inp["wg"]), experts, jnp.asarray(inp["x"]))
    T = inp["x"].shape[0] * inp["x"].shape[1]
    return (np.asarray(y), gate.capacity(T), float(l_aux),
            np.asarray(meta["exp_counts"]), float(meta["drop_rate"]))


@pytest.mark.parametrize("name", sorted(ranks.ROUTE_CASES))
def test_global_routing_matches_jax(launched, name):
    layout, impl, rows, seq, _ = ranks.ROUTE_CASES[name]
    y, C, l_aux, counts, drop = _jax_route(name)
    got = [r["route"][name] for r in launched["get"](_world(layout))]
    if name == "ep2_pad":  # ceil(2 x 10 / 4) = 5, padded to the axis
        assert C == 6
    for r, g in enumerate(got):
        assert g["impl"] == impl and g["capacity"] == C
        np.testing.assert_allclose(g["y"], y[r * rows:(r + 1) * rows],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["l_aux"], l_aux, rtol=1e-6)
        np.testing.assert_array_equal(g["exp_counts"], counts)
        np.testing.assert_allclose(g["drop_rate"], drop, rtol=1e-6)
        # one decision: every rank holds the same capacity, loss, counts
        assert g["l_aux"] == got[0]["l_aux"]
        assert g["drop_rate"] == got[0]["drop_rate"]
        np.testing.assert_array_equal(g["exp_counts"], got[0]["exp_counts"])
    if name == "ep2dp2_sparse":  # capacity factor 1: tokens drop
        assert drop > 0


# -- training ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_train(name: str):
    """(params before, metrics, params after) of the JAX engine on the
    case's mesh."""
    layout, _, _ = ranks.TRAIN_CASES[name]
    mesh = groups.initialize_mesh(mesh=_jax_mesh(layout))
    try:
        jm = _jax_model(mesh)
        params = jm.init_params(jax.random.PRNGKey(0))
        before = jax.device_get(params)
        engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                     config=ranks.case_config(name),
                                     mesh=mesh)
        out = {"loss": [], "grad_norm": [], "lr": []}
        for step in ranks.microbatches(name):
            m = engine.train_step({"input_ids": jnp.asarray(step[0])})
            for k in out:
                out[k].append(float(m[k]))
        return before, out, jax.device_get(engine.state.params)
    finally:
        groups.reset_mesh()


def _whole_params(got, layout: str):
    """The whole model from the ranks' parameters: each expert stack's
    blocks concatenated in expert order (from the ranks of ``data`` 0)."""
    ep, dp = ranks.LAYOUTS[layout]
    whole = dict(got[0]["params"])
    for k in whole:
        if k.split(".")[-1] in EXPERT_LEAVES:
            whole[k] = np.concatenate([got[e * dp]["params"][k]
                                       for e in range(ep)])
    return whole


@pytest.mark.parametrize("name", sorted(ranks.TRAIN_CASES))
def test_training_matches_jax_and_one_process(launched, weights, name):
    layout, stage, overrides = ranks.TRAIN_CASES[name]
    ep, dp = ranks.LAYOUTS[layout]
    got = [r["train"][name] for r in launched["get"](_world(layout))]
    one, _ = _one_process(weights, name)
    for what in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[0][what], one[what], rtol=1e-5)
    _assert_lr_equal(got[0]["lr"], one["lr"])
    factor = overrides.get("moe", {}).get("capacity_factor")
    assert got[0]["capacity_factor"] == (factor or 2.0)
    for r, g in enumerate(got):  # every rank reports one model
        assert g["loss"] == got[0]["loss"], r
        assert g["grad_norm"] == got[0]["grad_norm"], r
        assert g["capacity"] == got[0]["capacity"], r
        for k, v in g["params"].items():
            # an expert leaf equals its data group's rank 0's (the same
            # expert coordinate), any other leaf rank 0's
            ref = r - r % dp if k.split(".")[-1] in EXPERT_LEAVES else 0
            assert np.array_equal(v, got[ref]["params"][k]), (r, k)
    if stage == 3:  # expert stacks cut over data on the FFN dim
        cut = got[0]["cut"]
        assert cut["layers.0.w_gate"] == [2, dp]
        assert cut["layers.0.w_down"] == [1, dp]
        assert cut["embed.weight"] == [0, ep * dp]
    if name not in ranks.JAX_CASES:
        return
    before, want, after = _jax_train(name)
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    _assert_lr_equal(got[0]["lr"], want["lr"])
    c = ranks.config()
    _assert_updates_close(before, llama_tree_to_jax_layout(
        {k: torch.from_numpy(v) for k, v in
         _whole_params(got, layout).items()}, c.num_heads,
        c.num_kv_heads), after)


# -- checkpoints ------------------------------------------------------------

def _full_state(tag_dir: str) -> dict:
    return {key: dict(full_tensors(tag_dir, key))
            for key in ("master", "m", "v")}


def _tag_dir(root: str) -> str:
    with open(os.path.join(root, "latest")) as fh:
        return os.path.join(root, fh.read().strip())


def _assert_states_equal(a: dict, b: dict) -> None:
    for key in a:
        assert set(a[key]) == set(b[key]), key
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)


def test_checkpoints_across_expert_parallel_sizes(launched, weights):
    ckpt = launched["ckpt"]
    two, four = launched["get"](2), launched["get"](4)
    # one process -> ep 2: each rank loaded its experts' slice bit for bit
    one = _full_state(_tag_dir(ckpt["one"]))["master"]
    for r in two:
        e, n = r["ckpt"]["ep_rank"], 2
        for k, v in r["ckpt"]["loaded"].items():
            want = one[k].numpy()
            if k.split(".")[-1] in EXPERT_LEAVES:
                want = want[e * n:(e + 1) * n]
            assert np.array_equal(v, want), k
        assert r["ckpt"]["steps"] == 3
    # ep 2 -> one process, and ep 2 -> ep 2 x dp 2 (stage 3), bit for bit
    ep2 = _full_state(_tag_dir(ckpt["ep2"]))
    _, engine = _one_process(weights, "ep2_z0", load=ckpt["ep2"], steps=0)
    opt = engine.optimizer
    mine = {"master": dict(zip(engine.param_names, engine.params)),
            "m": dict(zip(engine.param_names, opt.m)),
            "v": dict(zip(engine.param_names, opt.v))}
    _assert_states_equal(ep2, mine)
    assert engine.global_steps == 3 and opt.count == 3
    _assert_states_equal(ep2, _full_state(_tag_dir(ckpt["ep2dp2"])))
    assert [r["ckpt"]["steps"] for r in four] == [3] * 4
    # each ep-2 rank wrote its own experts: two boxes of the stack
    from deepspeed_tpu_torch.runtime.checkpointing import (leaf_sources,
                                                           load_rank_states)
    pieces = leaf_sources(load_rank_states(_tag_dir(ckpt["ep2"])))
    boxes = sorted(b[0] for _, b in pieces["layers.0.w_gate"][1])
    assert boxes == [(0, 2), (2, 4)]
    assert len(pieces["layers.0.wg"][1]) == 1
    # zero_to_fp32 assembles the whole expert stacks
    whole = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        ckpt["ep2"])
    _assert_states_equal({"master": ep2["master"]}, {"master": whole})
    assert whole["layers.0.w_gate"].shape[0] == ranks.config().num_experts


# -- Mixtral under tensor parallelism --------------------------------------

_SERVED = {}


def _jax_serve(serve):
    """JAX's meshless v2 greedy tokens, the first prompt's logits and v1's
    greedy tokens (computed once)."""
    if not _SERVED:
        jm = _jax_model()
        params = jm.init_params(jax.random.PRNGKey(0))
        _SERVED["v2"] = jax_build_engine_v2(
            jm, params, cache_config=JaxKVCacheConfig(**ranks.CACHE),
            **ranks.ENGINE).generate(serve["prompts"],
                                     max_new_tokens=serve["n_new"])
        first = jnp.asarray([serve["prompts"][0]])
        logits, _ = jm.prefill(params, first,
                               jm.init_cache(1, first.shape[1]))
        _SERVED["logits"] = np.asarray(logits)
        _SERVED["v1"] = np.asarray(jax_init_inference(
            model=jm, model_params=params, dtype=jnp.float32).generate(
            jnp.asarray(serve["ids"]), max_new_tokens=serve["v1_new"]))
    return _SERVED


def test_mixtral_tp_serving_matches_jax(launched):
    ref = _jax_serve(launched["serve"])
    want, logits, want_v1 = ref["v2"], ref["logits"], ref["v1"]
    for r in launched["get"](2):
        s = r["serve"]
        assert s["tokens"] == want
        assert s["attn_path"] == "pallas_tp_shard_map"
        np.testing.assert_allclose(s["logits"], np.asarray(logits),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(s["v1_tokens"], want_v1)
        assert s["v1_tp"] == 2
        assert s["v1_expert_cols"] == ranks.config().intermediate_size // 2


def test_zero_init_refuses_an_expert_axis(launched):
    for r in launched["get"](4):
        assert "Queue 1 item 5a" in r["refusals"]["zero_init"]


def test_initialize_cuts_a_whole_mixtral_over_the_expert_axis(launched):
    """``moe.expert_parallel_size`` 2 on four ranks with no mesh: each rank
    keeps 2 of the 4 experts (expert-major ranks) and the first step's
    loss is one on every rank."""
    got = launched["get"](4)
    E = ranks.config().num_experts
    for r, g in enumerate(got):
        cut = g["whole_cut"]
        assert cut["w_gate"][0] == E // 2 and cut["ep_rank"] == r // 2
        assert cut["loss"] == got[0]["whole_cut"]["loss"]
    assert np.isfinite(got[0]["whole_cut"]["loss"])


@pytest.mark.parametrize("world", [2, 4])
def test_moe_block_placement_is_a_slice_of_one_process(launched, world):
    """``MoE(ep_size, mesh, enable_expert_tensor_parallelism=True)`` with
    Residual-MoE: at ``ep=2`` (2 ranks), ``ep=2 x dp=2`` (4) and ``tp=2``
    (2) each rank's output rows and ``l_aux`` equal the one-process
    block's on the global batch, from the same seed."""
    moe = MoE(**ranks.BLOCK, mesh=None)
    params = moe.init_params(torch.Generator().manual_seed(
        ranks.BLOCK_SEED), ranks.BLOCK_I)
    y, l_aux, _ = moe(params, torch.from_numpy(ranks.block_input(world)))
    got = launched["get"](world)
    cases = [(r["block"], True) for r in got]
    if world == 2:
        cases += [(r["serve"]["block"], False) for r in got]
    for i, (g, on_data) in enumerate(cases):
        rows = y[2 * (i % world):2 * (i % world) + 2] if on_data else y
        np.testing.assert_allclose(g["y"], rows.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g["l_aux"], float(l_aux), rtol=1e-6)
        E, I = ranks.BLOCK["num_experts"], ranks.BLOCK_I
        assert g["w_gate"] == ([E // 2, 16, I] if on_data
                               else [E, 16, I // 2])


# -- Residual-MoE and the moe group (one process) ---------------------------

def test_residual_moe_matches_jax():
    H, I, E = 16, 24, 4
    kw = dict(hidden_size=H, num_experts=E, k=2, capacity_factor=2.0,
              use_residual=True, use_rts=False)
    jmoe = JaxMoE(**kw, mesh=build_mesh(MeshLayout.infer(1),
                                        devices=jax.devices()[:1]))
    params = jax.device_get(jmoe.init_params(jax.random.PRNGKey(3), I))
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, H).astype(np.float32)
    ct = rng.randn(2, 8, H).astype(np.float32)

    def jloss(p, x):
        y, l_aux, _ = jmoe(p, x)
        return jnp.sum(y * ct) + l_aux, y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    moe = MoE(**kw, mesh=None)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                             requires_grad=True), params)
    tx = torch.tensor(x, requires_grad=True)
    y, l_aux, _ = moe(tp, tx)
    ((y * torch.from_numpy(ct)).sum() + l_aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    got = jax.tree.map(lambda t: t.grad.numpy(), tp)
    for path, want in jax.tree_util.tree_flatten_with_path(jgp)[0]:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
    assert np.abs(got["coefficient"]).max() > 0
    assert np.abs(got["residual_mlp"]["w_down"]).max() > 0


def test_moe_config_group_reaches_the_gate_and_layer():
    group = {"capacity_factor": 4.0, "dispatch_impl": "dense",
             "pad_capacity_to_ep": False, "use_rts": True}
    cfg = DeepSpeedConfig.from_dict({"train_micro_batch_size_per_gpu": 1,
                                     "moe": group})
    assert (cfg.moe.capacity_factor, cfg.moe.dispatch_impl,
            cfg.moe.expert_parallel_size) == (4.0, "dense", 1)
    assert cfg.extra == {}
    with pytest.raises(ValueError, match="dispatch_impl"):
        DeepSpeedConfig.from_dict({"moe": {"dispatch_impl": "tutel"}})
    model = dst.MixtralModel(ranks.config(), device="cpu")
    dst.initialize(model=model, device="cpu", config={
        "train_micro_batch_size_per_gpu": 1, "moe": group})
    jm = _jax_model()
    jax_apply_moe_config(JaxConfig.model_validate({
        "train_micro_batch_size_per_gpu": 1, "moe": group}), jm)
    for layer, want in ((model._moe_layer, jm._moe_layer),):
        assert layer.dispatch_impl == want.dispatch_impl == "dense"
        for f in ("capacity_factor", "eval_capacity_factor", "pad_to_ep",
                  "use_rts"):
            assert getattr(layer.gate, f) == getattr(want.gate, f), f
    # 128 tokens: auto would take the sparse rung here (T·E·C 131072)
    model.loss(torch.zeros(2, 64, dtype=torch.long))
    assert model._moe_layer.last_impl == "dense"
    assert model._moe_layer.last_capacity == want.gate.capacity(128) == 256
    with pytest.raises(ValueError, match="must divide the DP world"):
        dst.initialize(model=model, device="cpu", config={
            "train_micro_batch_size_per_gpu": 1,
            "moe": {"expert_parallel_size": 2}})
