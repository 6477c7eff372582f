"""Data parallelism and ZeRO stages 0-3 of the port against the JAX engine.

``initialize`` on 2 and 4 gloo ranks on the CPU (``launcher.local.launch``,
rank bodies in ``torch_zero_ranks``, no JAX there) trains one tiny Llama
(2 layers, fp32 masters, the JAX model's weights carried by
``llama_params_from_jax``; ranks other than 0 draw their own weights, which
``initialize`` replaces with rank 0's).  Rank ``r`` feeds the rows JAX's
batch sharding gives device ``r``.  The JAX engine runs the same config on
a data mesh of as many of the 8 virtual CPU devices, at the same stage.

* per stage and rank count: five steps' ``loss`` and ``grad_norm`` within
  1e-5 relative (``test_torch_train.test_engine_steps_match_jax``'s fp32
  tolerance), ``lr`` equal, and the parameters gathered after the steps
  within ``_assert_updates_close``'s bound of the JAX engine's;
* on two ranks: gradient accumulation 2 with clipping (the clip factor
  reads the global norm, the replicated norm vectors counted once), fp16
  with an overflow that forms on one rank and lands in one rank's chunk
  (every rank skips together; fp16 tolerances of ``test_torch_train``), and
  ``kernels.fused_adam`` at stage 3 (the kernels' plain versions here);
* every rank ends with the same parameters, bit for bit;
* the placement rule against JAX's ``dp_shardable_dim`` and
  ``ZeroShardingPolicy`` on a table of shapes and thresholds;
* ``zero.Init`` and ``GatheredParameters`` (read only and with
  ``modifier_rank``), ``reduce_scatter`` along dims 0 and 1,
  ``all_to_all_single``, Mixtral training on a data axis of 2, and the
  refusal to serve a model cut under ZeRO-3;
* the per-rank token mean the port takes (DeepSpeed's) beside JAX's
  global-batch mean when the ranks' rows count different labelled tokens.

One launch per rank count runs every case; its results feed a
module-scoped fixture, and each case is its own test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import torch_zero_ranks as ranks
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.zero import sharder as jax_sharder
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import (LlamaConfig, LlamaModel,
                                        llama_params_from_jax,
                                        llama_tree_to_jax_layout)
from deepspeed_tpu_torch.runtime.config import ZeroConfig
from deepspeed_tpu_torch.runtime.zero import (ZeroShardingPolicy,
                                              dp_shardable_dim,
                                              reshard_layout_report)
from deepspeed_tpu_torch.launcher import launch
from test_torch_train import (_assert_lr_equal, _assert_updates_close,
                              _jax_batch, _run)
from torch_parity import free_jax_cycles  # noqa: F401

#: a launch runs every case on every rank (one thread each)
TIMEOUT = 300
JNP = {"float32": jnp.float32, "float16": jnp.float16}


def _jax_model(dtype="float32"):
    return JaxLlamaModel(JaxLlamaConfig.tiny(dtype=JNP[dtype],
                                            num_layers=2))


@pytest.fixture(scope="module")
def weights():
    jm = _jax_model()
    jcfg = jm.config
    port = LlamaConfig(**ranks.MODEL)
    for f in ("vocab_size", "hidden_size", "intermediate_size",
              "num_layers", "num_heads", "num_kv_heads", "max_seq_len",
              "rope_theta", "rms_norm_eps", "tie_embeddings",
              "sliding_window", "head_dim", "remat", "attn_impl"):
        assert getattr(port, f) == getattr(jcfg, f), f
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    host = jax.tree.map(np.asarray, params)
    return {k: v.numpy() for k, v in llama_params_from_jax(host).items()}


_RUNS = {}


@pytest.fixture(scope="module")
def port_runs(weights):
    """rank count -> every rank's results (one launch each, on first use)."""
    def get(world):
        if world not in _RUNS:
            _RUNS[world] = launch(ranks.zero_rank, world,
                                  (weights, world == 2), timeout=TIMEOUT)
        return _RUNS[world]
    yield get
    _RUNS.clear()


@functools.lru_cache(maxsize=None)
def _jax_run(name, world):
    """(params before, the step metrics, params after) of the JAX engine on
    a ``world``-device data mesh at the case's stage and config."""
    _, dtype, _ = ranks.all_cases()[name]
    jm = _jax_model(dtype)
    params = jm.init_params(jax.random.PRNGKey(0))
    if "overflow" in name:
        params = dict(params, final_norm=params["final_norm"]
                      * ranks.OVERFLOW_NORM)
    before = jax.device_get(params)
    layout = MeshLayout.infer(world, dp=world)
    mesh = groups.initialize_mesh(mesh=build_mesh(
        layout, devices=jax.devices()[:world]))
    engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                 config=ranks.case_config(name), mesh=mesh)
    want = _run(engine, ranks.global_batches(name, world), _jax_batch)
    return before, want, jax.device_get(engine.state.params)


#: the port's stages 1 and 2 are held against JAX's stage 0 on the same
#: mesh, which JAX's own keystone test holds its stages 1 and 2 equal to
#: (``tests/unit/runtime/test_engine.py::test_zero_stage_matches_stage0``)
JAX_STAGE = {"stage1": "stage0", "stage2": "stage0"}


def _check_case(got_ranks, name, world):
    got = got_ranks[0]
    before, want, after = _jax_run(JAX_STAGE.get(name, name), world)
    fp32 = ranks.all_cases()[name][1] == "float32"
    loss_tol, norm_tol = (1e-5, 1e-5) if fp32 else (2e-2, 5e-2)
    if name in ranks.OFFLOAD_CASES:  # the offload tolerance of JAX's tests
        loss_tol = norm_tol = 2e-4
    _assert_lr_equal(got["lr"], want["lr"])
    assert got["loss_scale"] == want["loss_scale"]
    assert got["skipped"] == want["skipped"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_tol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=norm_tol, atol=1e-6)
    if fp32:
        _assert_updates_close(before, llama_tree_to_jax_layout(
            {k: torch.from_numpy(v) for k, v in got["params"].items()},
            8, 4), after)
    for other in got_ranks[1:]:  # one model: every rank reports the same
        assert other["loss"] == got["loss"]
        assert other["grad_norm"] == got["grad_norm"]
        assert other["skipped"] == got["skipped"]


@pytest.mark.parametrize("name", sorted(ranks.STAGE_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_stages_match_jax(port_runs, world, name):
    got = port_runs(world)
    stage = ranks.STAGE_CASES[name][0]
    n_params = sum(v.size for v in got[0][name]["params"].values())
    # stage >= 1 cuts every matrix (the 5 norms stay whole); stage 3 holds
    # this rank's chunks alone
    assert got[0][name]["cut"] == (0 if stage == 0 else 2 * 7 + 2)
    norms = 5 * ranks.MODEL["hidden_size"]
    assert got[0][name]["chunk_numel"] == (
        (n_params - norms) // world + norms if stage == 3 else n_params)
    _check_case([r[name] for r in got], name, world)


@pytest.mark.parametrize("name", sorted(ranks.EXTRA_CASES))
def test_two_rank_cases_match_jax(port_runs, name):
    got = [r[name] for r in port_runs(2)]
    _check_case(got, name, 2)
    if "overflow" in name:  # skip twice, halving, then grow, in lockstep
        assert got[0]["skipped"] == [1, 2, 2, 2, 2]
        assert got[0]["loss_scale"] == [2.0 ** 15, 2.0 ** 14, 2.0 ** 13,
                                        2.0 ** 13, 2.0 ** 14]


@pytest.mark.parametrize("name", sorted(ranks.OFFLOAD_CASES))
def test_offload_ranks_match_jax_offload(port_runs, name):
    """ZeRO-Offload on two ranks against JAX's offload engine on a
    two-device data mesh; each rank's host state is its chunk of the cut
    leaves and the whole norms, to the byte, all on the host."""
    got = [r[name] for r in port_runs(2)]
    _check_case(got, name, 2)
    stage = ranks.OFFLOAD_CASES[name][0]
    total = sum(v.size for v in got[0]["params"].values())
    norms = 5 * ranks.MODEL["hidden_size"]
    for r in got:
        assert r["host_numel"] == (total - norms) // 2 + norms
        assert r["host_state_bytes"] == r["host_numel"] * 12
        assert r["host_devices"] == ["cpu"]
        assert r["cut"] == 2 * 7 + 2
        if stage == 3:
            assert r["chunk_numel"] == r["host_numel"]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_seeded_differently_end_up_equal(port_runs, world, weights):
    """Ranks other than 0 drew other weights; after ``initialize`` and the
    steps every rank holds the same parameters, bit for bit."""
    got = port_runs(world)
    cases = [k for k in got[0] if k in ranks.all_cases()]
    assert len(cases) == (4 if world == 4 else 10)
    for name in cases:
        for r in got[1:]:
            for k, v in got[0][name]["params"].items():
                assert np.array_equal(v, r[name]["params"][k]), (name, k)
        moved = max(np.abs(got[0][name]["params"][k] - weights[k]).max()
                    for k in weights)
        assert moved > 0, name


SHAPES = [(512, 128), (128, 512), (128, 128), (352, 128), (128, 352),
          (64, 128), (128,), (6, 4), (3, 5), (2, 4, 6), (8, 12, 8),
          (7,), (), (30000, 7)]


@pytest.mark.parametrize("dp", [2, 3, 4])
@pytest.mark.parametrize("threshold", [0, 1000, 100_000])
def test_placement_rule_matches_jax(dp, threshold):
    """The cut dim of every stage's parameter, gradient and optimizer-state
    placement equals the dim JAX's policy gives the DP axes."""
    layout = MeshLayout.infer(dp, dp=dp)
    mesh = build_mesh(layout, devices=jax.devices()[:dp])
    for stage in range(4):
        zero_cfg = jax_sharder.DeepSpeedZeroConfig(
            stage=stage, stage3_param_persistence_threshold=threshold)
        want = jax_sharder.ZeroShardingPolicy.from_config(mesh, zero_cfg)
        got = ZeroShardingPolicy.from_config(ZeroConfig(
            stage=stage, stage3_param_persistence_threshold=threshold), dp)
        for shape in SHAPES:
            leaf = np.zeros(shape, np.float32)
            for kind in ("param", "grad", "opt_state"):
                spec = getattr(want, f"{kind}_spec")(leaf)
                dims = [i for i, e in enumerate(spec) if e is not None]
                assert getattr(got, f"{kind}_dim")(shape) == (
                    dims[0] if dims else None), (stage, shape, kind)
    for shape in SHAPES:
        assert dp_shardable_dim(shape, dp) == \
            jax_sharder.dp_shardable_dim(shape, dp), shape
    named = [[str(s), list(s)] for s in SHAPES]
    assert reshard_layout_report(named, dp) == \
        jax_sharder.reshard_layout_report(named, dp)


def test_auto_threshold_counts_as_jax_does():
    z = ZeroConfig(stage=3, stage3_param_persistence_threshold="auto",
                   reduce_bucket_size="auto",
                   stage3_prefetch_bucket_size="auto")
    assert z.persistence_threshold == 100_000
    z.resolve_auto_from_hidden_size(768)
    want = jax_sharder.DeepSpeedZeroConfig(
        stage=3, stage3_param_persistence_threshold="auto",
        reduce_bucket_size="auto", stage3_prefetch_bucket_size="auto")
    want.resolve_auto_from_hidden_size(768)
    for key in ("reduce_bucket_size", "stage3_prefetch_bucket_size",
                "stage3_param_persistence_threshold"):
        assert getattr(z, key) == getattr(want, key), key


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_and_all_to_all(port_runs, world):
    got = [r["verbs"] for r in port_runs(world)]
    x = np.arange(world * 6 * 4, dtype=np.float32).reshape(world * 6, 4)
    x_sum = sum(x * (r + 1) for r in range(world))
    y = np.arange(6 * world * 8, dtype=np.float32).reshape(6, world * 8)
    y_sum = sum(y + r for r in range(world))
    for r, v in enumerate(got):
        np.testing.assert_array_equal(v["rs0"], x_sum[r * 6:(r + 1) * 6])
        np.testing.assert_array_equal(v["rs1"], y_sum[:, r * 8:(r + 1) * 8])
        np.testing.assert_allclose(v["rs1_avg"],
                                   y_sum[:, r * 8:(r + 1) * 8] / world,
                                   rtol=1e-6)
        want = np.concatenate([np.arange(r * 3, r * 3 + 3) + 100 * s
                               for s in range(world)]).astype(np.float32)
        np.testing.assert_array_equal(v["a2a"], want)


def test_zero_init_and_gathered_parameters(port_runs):
    got = [r["init"] for r in port_runs(2)]
    for r, v in enumerate(got):
        # every matrix cut in two along its larger dim, norms whole
        assert v["chunk_shapes"]["embed.weight"] == [256, 128]
        assert v["chunk_shapes"]["layers.0.down_proj.weight"] == [128, 176]
        assert v["chunk_shapes"]["layers.0.attn_norm"] == [128]
        assert len(v["cut"]) == 2 * 7 + 2
        assert v["gathered_equal_whole"], r
        assert v["chunk_back"], r
        assert v["modified"] == [2.0], r  # rank 1's edit, on every rank
        np.testing.assert_allclose(v["losses"]["init"],
                                   v["losses"]["whole"], rtol=1e-6)


def test_mixtral_and_serving_a_cut_model_are_refused(port_runs):
    """Mixtral on a data axis of 2 trains now (its gate routes the global
    micro-batch: one loss on both ranks, and it moves), and so does
    ZeRO-Infinity on two ranks, on a data axis and on a tensor axis (the
    latter's parity: ``test_torch_tp_train``); serving a model cut under
    ZeRO-3 is still refused."""
    got = [r["refusals"] for r in port_runs(2)]
    for v in got:
        assert np.all(np.isfinite(v["mixtral"]))
        assert v["mixtral"] == got[0]["mixtral"]
        assert v["mixtral"][1] != v["mixtral"][0]
        for what in ("init_inference", "build_engine_v2"):
            assert "GatheredParameters" in v[what], v[what]
        # ZeRO-Infinity on two ranks trains one model, on the data axis
        # and on a tensor axis
        for key in ("infinity_2_ranks", "infinity_tp"):
            assert np.all(np.isfinite(v[key])), key
            assert v[key] == got[0][key], key
            assert v[key][1] < v[key][0], key


def test_uneven_labels_per_rank_mean_beside_jax_global_mean(port_runs,
                                                           weights):
    """With labels masked unevenly across the ranks' rows, the port (as
    DeepSpeed) averages each rank's token mean; JAX's GSPMD loss is the
    token mean of the whole micro-batch.  Both are printed; the port's
    two-rank loss equals the mean of the per-rank losses."""
    got = [r["uneven_eval"] for r in port_runs(2)]
    batch = ranks.uneven_batch()
    model = LlamaModel(LlamaConfig(dtype=torch.float32, **ranks.MODEL),
                       device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.items()})
    with torch.no_grad():
        per_rank = [float(model.loss({
            k: torch.from_numpy(ranks.local_rows(v, r, 2))
            for k, v in batch.items()})) for r in range(2)]
    jm = _jax_model()
    jax_loss = float(jm.loss(jm.init_params(jax.random.PRNGKey(0)),
                             {k: jnp.asarray(v) for k, v in batch.items()}))
    print(f"port (2 ranks, mean of rank means): {got[0]:.6f}; "
          f"JAX (global token mean): {jax_loss:.6f}")
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], np.mean(per_rank), rtol=1e-6)
    assert abs(got[0] - jax_loss) > 1e-3


def test_hybrid_engine_at_zero3_equals_one_process(port_runs, weights):
    """The hybrid engine at ZeRO-3 on two ranks: after one step, greedy
    tokens (the cut weights gathered where the model reads them) equal
    one process's on the same global batch, on both ranks."""
    got = [r["hybrid_z3"] for r in port_runs(2)]
    model = LlamaModel(LlamaConfig(dtype=torch.float32,
                                   param_dtype=torch.float32,
                                   **ranks.MODEL), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.items()})
    import deepspeed_tpu_torch as dst
    cfg = dict(ranks.hybrid_z3_config(), zero_optimization={"stage": 0},
               train_micro_batch_size_per_gpu=2)
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    engine.train_step({"input_ids": torch.from_numpy(
        ranks.global_batches("stage3", 2)[0])})
    want = engine.generate(torch.tensor(ranks.HYBRID_PROMPT),
                           max_new_tokens=ranks.HYBRID_NEW).tolist()
    for r in got:
        assert r["kind"] == "DeepSpeedHybridEngine"
        assert r["cut"] == 2 * 7 + 2
        assert r["tokens"] == want


def test_zero_config_fields_and_refusals():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = DeepSpeedConfig.from_dict({"zero_optimization": {
        "stage": 3, "reduce_bucket_size": 1000, "overlap_comm": True,
        "stage3_max_live_parameters": 5, "contiguous_gradients": False}})
    z = cfg.zero_optimization
    assert (z.stage, z.reduce_bucket_size, z.overlap_comm,
            z.stage3_max_live_parameters) == (3, 1000, True, 5)
    assert z.extra == {}
    fields = {f.name for f in dataclasses.fields(ZeroConfig)}
    assert {"allgather_bucket_size", "stage3_param_persistence_threshold",
            "stage3_prefetch_bucket_size",
            "stage3_gather_16bit_weights_on_model_save"} <= fields
    for bad, item in (
            ({"pipeline": {"stages": 2}}, 8),
            ({"zero_optimization": {"mics_shard_size": 2}}, 10),
            ({"kernels": {"overlap_collectives": True}}, "4b")):
        with pytest.raises(NotImplementedError,
                           match=f"not ported yet.*item {item}\\)"):
            DeepSpeedConfig.from_dict(bad)
    # ZeRO++ is ported: its keys parse (the engines: test_torch_zeropp)
    for key, value in (("zero_quantized_weights", True),
                       ("zero_quantized_gradients", True),
                       ("zero_hpz_partition_size", 2)):
        z = DeepSpeedConfig.from_dict({"zero_optimization": {
            "stage": 3, key: value}}).zero_optimization
        assert getattr(z, key) == value and z.extra == {}, key
