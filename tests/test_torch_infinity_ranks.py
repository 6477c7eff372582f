"""ZeRO-Infinity of the port on more than one rank (per-rank host planes,
the gathered wire, the reduce-scattered gradients) and Infinity x Ulysses,
against the JAX package's ``LayerStreamingEngine`` on the same mesh.

One gloo launch on 2 ranks and one on 4, rank bodies in
``torch_inf_ranks`` (no JAX there); the launches run in a thread while
this process runs the JAX side on device subsets of the 8 virtual CPU
devices.  fp32 throughout, 4-layer tiny Llama (2-layer tiny Mixtral).

* through ``initialize`` with ``offload_param`` (cpu tier), 3 steps: dp 2
  on the fused and the stash path (gas 2 with clipping), sp 2 on Ulysses
  (the flash route: the kernels' plain versions here), sp 2 with
  ``loss_tiles`` 4, Mixtral at dp 2 (the router's aux loss through the
  streamed backward), and dp 2 x sp 2: losses and grad norms within 2e-4
  relative of JAX's streamed engine and of the port's streamed engine in
  one process on the global batch, the final fp32 masters within 2e-4 of
  JAX's in relative norm a leaf (the one-process Infinity tests' bound)
  and of the one-process run's to 2e-4 an element, ``eval_loss`` before
  the steps within 1e-5 of JAX's; every rank reports the same, bit for
  bit; the all-to-alls of the formula (12 a layer a step under ``seq``);
* each rank's planes hold its segment: ``n_plane x world == n_pad``, the
  host plane bytes one process's over ``world`` up to the padding, the
  trunk's device buffers ``2 x n_pad`` elements, the gather and
  reduce-scatter bytes of the step's layer visits;
* at dp 2, bit for bit: the nvme tier (a ring of 2 slots, files per rank)
  equals the cpu tier, the pipelined host Adam the serial one, on both
  paths; an fp16 overflow on one rank skips the step on every rank;
* a save at dp 2 resumes bit for bit and loads in one process to the same
  masters and moments; a save in one process loads at dp 2 to its masters
  and moments;
* the streamed sp-2 run equals the on-device sp-2 run (the remat path)
  within 2e-4; ``offload_param`` on a tensor axis trains within 2e-4 of
  the on-device tp-2 engine.
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
import torch_inf_ranks as ranks
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import (llama_params_from_jax,
                                        mixtral_params_from_jax)
from torch_parity import free_jax_cycles  # noqa: F401

TIMEOUT = 300
RTOL = 2e-4
#: the JAX tiny Mixtral's fields the port's config takes
_MOE_FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
               "num_layers", "num_heads", "num_kv_heads", "head_dim",
               "max_seq_len", "rope_theta", "rms_norm_eps", "tie_embeddings",
               "sliding_window", "remat", "attn_impl", "num_experts",
               "top_k", "capacity_factor", "aux_loss_coef",
               "moe_dispatch_impl")


def _jax_model(moe: bool, attn: str = "flash", tiles: int = 1, mesh=None):
    if moe:
        return JaxMixtralModel(JaxMixtralConfig.tiny(
            num_layers=2, dtype=jnp.float32), mesh=mesh)
    return JaxLlamaModel(JaxLlamaConfig(**ranks.MODEL, dtype=jnp.float32,
                                        attn_impl=attn, loss_tiles=tiles),
                         mesh=mesh)


def _to_port(tree, moe: bool):
    """A JAX tree of numpy arrays by the port's parameter names."""
    sd = (mixtral_params_from_jax if moe else llama_params_from_jax)(tree)
    return {k: v.numpy() for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _weights(moe: bool):
    """(JAX host tree, the port's state dict) of the tiny model."""
    host = jax.tree.map(np.asarray, jax.device_get(
        _jax_model(moe).init_params(jax.random.PRNGKey(0))))
    return host, _to_port(host, moe)


def _mixtral_fields():
    cfg = JaxMixtralConfig.tiny(num_layers=2, dtype=jnp.float32)
    return {f: getattr(cfg, f) for f in _MOE_FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """(metrics, eval loss before the steps, masters by the port's names)
    of JAX's streamed engine on the case's mesh."""
    world, sp, attn, tiles, _, moe = ranks.CASES[name]
    mesh = groups.initialize_mesh(mesh=build_mesh(
        MeshLayout.infer(world, sp=sp, dp=world // sp),
        devices=jax.devices()[:world]))
    jm = _jax_model(moe, attn, tiles, mesh)
    host, _ = _weights(moe)
    eng, *_ = jdst.initialize(model=jm, model_parameters=jax.tree.map(
        jnp.asarray, host), config=ranks.case_config(name), mesh=mesh)
    assert eng.infinity is not None
    batches = ranks.global_batches(name)
    ev = float(eng.eval_loss({"input_ids": jnp.asarray(
        batches[0][:ranks.ROWS])}))
    want = {k: [] for k in ("loss", "grad_norm")}
    for b in batches:
        m = eng.train_step({"input_ids": jnp.asarray(b)})
        for k in want:
            want[k].append(float(m[k]))
    inf = eng.infinity
    layers = [inf.swapper.layer_master_tree(i) for i in range(inf.L)]
    masters = dict(jax.tree.map(np.asarray, dict(inf.resident)))
    masters["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return want, ev, _to_port(masters, moe)


@functools.lru_cache(maxsize=None)
def _one_process(name: str):
    """The port's streamed engine in one process on the global batches
    (sp 1): its metrics and masters."""
    _, _, _, _, _, moe = ranks.CASES[name]
    cfg = dict(ranks.case_config(name),
               train_micro_batch_size_per_gpu=ranks.ROWS,
               sequence_parallel={"sp_size": 1})
    model = (dst.MixtralModel if moe else dst.LlamaModel)(
        ranks.model_config(name, _mixtral_fields()), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _weights(moe)[1].items()})
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    got = {k: [] for k in ("loss", "grad_norm")}
    for b in ranks.global_batches(name):
        m = engine.train_step({"input_ids": torch.from_numpy(b)})
        for k in got:
            got[k].append(float(m[k]))
    return got, ranks.streamed_state(engine)


def _max_abs(a, b) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _world1_save(root):
    """A one-process Infinity run of one step, saved under ``root/world1``
    (tag ``w1``, where the 2-rank launch looks); its masters and
    moments."""
    cfg = dict(ranks.case_config("dp2_fused"),
               train_micro_batch_size_per_gpu=ranks.ROWS,
               sequence_parallel={"sp_size": 1})
    model = dst.LlamaModel(ranks.model_config("dp2_fused", None),
                           device="cpu", seed=11)
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    engine.train_step({"input_ids": torch.from_numpy(
        ranks.global_batches("dp2_fused")[0])})
    engine.save_checkpoint(str(root / "world1"), tag="w1")
    return ranks.streamed_state(engine), ranks.streamed_moments(engine)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """In a thread: the 2-rank launch, then the 4-rank one; the JAX side
    meanwhile.  ``get(world)`` waits for them."""
    root = tmp_path_factory.mktemp("inf_ranks")
    _, weights = _weights(False)
    _, moe_weights = _weights(True)
    world1 = _world1_save(root / "w2")
    result = {}

    def run():
        try:
            for world in (2, 4):
                result[world] = launch(
                    ranks.inf_rank, world,
                    (weights, moe_weights, _mixtral_fields(),
                     str(root / f"w{world}")), timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    for name in ranks.CASES:
        _jax_run(name)

    def get(world):
        thread.join()
        if "error" in result:
            raise result["error"]
        return result[world]
    yield {"get": get, "root": root, "world1": world1}
    thread.join()


def _case_ranks(launched, name):
    return [r[name] for r in launched["get"](ranks.CASES[name][0])]


def _assert_ranks_equal(got, keys=("loss", "grad_norm")):
    for r in got[1:]:
        for k in keys:
            assert r[k] == got[0][k], k
        for k in got[0]["state"]:
            np.testing.assert_array_equal(r["state"][k], got[0]["state"][k])


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_streamed_ranks_match_jax(launched, name):
    world, sp, _, _, _, moe = ranks.CASES[name]
    got = _case_ranks(launched, name)
    want, want_eval, want_masters = _jax_run(name)
    g = got[0]
    np.testing.assert_allclose(g["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(g["grad_norm"], want["grad_norm"], rtol=RTOL)
    np.testing.assert_allclose(g["eval"], want_eval, rtol=1e-5)
    assert g["loss"][-1] < g["loss"][0]
    assert set(g["state"]) == set(want_masters)
    # each master leaf against JAX's in relative norm (the one-process
    # Infinity tests' bound: the port's fp32 Adam amplifies last-bit
    # differences of near-zero gradients, in one process as on ranks),
    # and every element against the port's one-process streamed run
    rel = max(_rel(g["state"][k], want_masters[k]) for k in want_masters)
    one, one_state = _one_process(name)
    err = _max_abs(g["state"], one_state)
    print(f"{name}: losses {_rel(g['loss'], want['loss']):.3e}, grad norms "
          f"{_rel(g['grad_norm'], want['grad_norm']):.3e} from JAX; "
          f"masters {rel:.3e} (largest element "
          f"{_max_abs(g['state'], want_masters):.3e}) from JAX, largest "
          f"element {err:.3e} from one process")
    assert rel <= RTOL, rel
    assert err <= RTOL, err
    np.testing.assert_allclose(g["loss"], one["loss"], rtol=RTOL)
    np.testing.assert_allclose(g["grad_norm"], one["grad_norm"], rtol=RTOL)
    _assert_ranks_equal(got, ("loss", "grad_norm", "eval"))
    assert sorted((r["dp_rank"], r["sp_rank"]) for r in got) == sorted(
        (d, s) for d in range(world // sp) for s in range(sp))
    # per layer and micro-batch: q, k, v and the output forward, again in
    # the backward's recompute, and in its backward
    L = 2 if moe else ranks.MODEL["num_layers"]
    assert g["all_to_all"] == (ranks.STEPS * ranks.gas(name) * L * 12
                               if sp > 1 else 0)


@pytest.mark.parametrize("name", ["dp2_fused", "dp2_sp2"])
def test_each_rank_holds_its_segment(launched, name):
    got = _case_ranks(launched, name)
    world = ranks.CASES[name][0]
    L = ranks.MODEL["num_layers"]
    segments = []
    for r in got:
        n, n_pad, n_plane = r["n_elems"], r["n_pad"], r["n_plane"]
        assert r["world"] == world and n_plane * world == n_pad
        assert n <= n_pad < n + world
        assert r["plane_numel"] == [n_plane, n_plane]
        # fp32 wire + master + m + v: one process's bytes over the world,
        # up to the padding
        assert r["host_plane_bytes"] == L * n_plane * 16
        assert abs(r["host_plane_bytes"] * world - L * n * 16) < \
            L * world * 16
        assert r["device_param_bytes"] == 2 * n_pad * 4
        # a layer gathered at every visit: 2 L a micro-batch and L in the
        # eval; its gradients reduce-scattered once a micro-batch
        visits = ranks.STEPS * ranks.gas(name)
        assert r["io_bytes"]["gather"] == (2 * visits + 1) * L * n_pad * 4
        assert r["io_bytes"]["reduce_scatter"] == visits * L * n_pad * 4
        assert r["io_bytes"]["d2h"] == visits * L * n_plane * 4
        assert r["trunk_on_module"] == 0.0  # no whole trunk leaf held
        segments += r["segments"]
    assert sorted(set(map(tuple, segments))) == [
        (k * got[0]["n_plane"], (k + 1) * got[0]["n_plane"])
        for k in range(world)]


def test_nvme_equals_cpu_and_pipelined_equals_serial(launched):
    for rank, r in enumerate(launched["get"](2)):
        tiers = r["tiers"]
        for name in ("dp2_fused", "dp2_stash_gas2_clip"):
            ref = tiers[f"{name}/cpu/serial"]
            assert not ref["pipelined"]
            for key in ("cpu/pipelined", "nvme/pipelined"):
                row = tiers[f"{name}/{key}"]
                assert row["pipelined"]
                assert row["loss"] == ref["loss"], (name, key)
                assert row["grad_norm"] == ref["grad_norm"], (name, key)
                for k in ref["state"]:
                    np.testing.assert_array_equal(row["state"][k],
                                                  ref["state"][k])
            nv = tiers[f"{name}/nvme/pipelined"]
            assert nv["evicts"]
            assert nv["files"] == sorted(
                f"layer_{i:05d}.r{k}.{kind}" for i in range(4)
                for k in range(2) for kind in ("wire", "master", "m", "v"))


def test_fp16_overflow_on_one_rank_skips_every_rank(launched):
    got = [r["fp16"] for r in launched["get"](2)]
    for v in got:
        assert v["clean"]["overflow"] == [0.0, 0.0]
        assert v["clean"]["loss"] == got[0]["clean"]["loss"]
        assert all(np.isfinite(v["clean"]["loss"]))
        assert v["overflow"] == [1.0]
        before, after = v["before"], v["after"]
        assert after["steps"] == before["steps"] == 2
        assert after["adam"] == before["adam"] == 2
        assert after["count"] == before["count"]
        assert after["scale"] == before["scale"] / 2
        assert after["skipped"] == 1


def test_checkpoint_resumes_and_crosses_rank_counts(launched):
    got = [r["checkpoint"] for r in launched["get"](2)]
    for r in got:
        assert r["again"]["loss"] == r["first"]["loss"]
        assert r["again"]["grad_norm"] == r["first"]["grad_norm"]
        assert r["params_equal"]
        assert r["loaded"] == {"adam": 2, "steps": 2}
        # the rank files, and one file a layer written by rank 0
        assert [f for f in r["files"] if f.endswith(".pt")] == [
            "dp_rank_00000.pt", "dp_rank_00001.pt"] + [
            f"infinity_layer_{i:05d}.pt" for i in range(4)]
    # one process loads the dp-2 save: the same masters and moments
    cfg = dict(ranks.case_config("dp2_fused"),
               train_micro_batch_size_per_gpu=ranks.ROWS,
               sequence_parallel={"sp_size": 1})
    model = dst.LlamaModel(ranks.model_config("dp2_fused", None),
                           device="cpu", seed=13)
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    engine.load_checkpoint(str(launched["root"] / "w2" / "ckpt"), tag="dp2")
    assert engine.infinity.swapper.state_step == 2
    state = ranks.streamed_state(engine)
    for k, v in got[0]["at_save"].items():
        np.testing.assert_array_equal(state[k], v)
    for mine, saved in zip(ranks.streamed_moments(engine),
                           got[0]["moments"]):
        for k in ("m", "v"):
            np.testing.assert_array_equal(mine[k], saved[k])
    # and the dp-2 ranks loaded a one-process save
    w1_state, w1_moments = launched["world1"]
    for r in got:
        back = r["from_world1"]
        assert back["adam"] == 1
        for k, v in w1_state.items():
            np.testing.assert_array_equal(back["state"][k], v)
        for mine, saved in zip(back["moments"], w1_moments):
            for k in ("m", "v"):
                np.testing.assert_array_equal(mine[k], saved[k])


def test_streamed_sp2_equals_on_device_sp2(launched):
    for r in launched["get"](2):
        dev, streamed = r["on_device_sp2"], r["sp2"]
        np.testing.assert_allclose(streamed["loss"], dev["loss"], rtol=RTOL)
        np.testing.assert_allclose(streamed["grad_norm"], dev["grad_norm"],
                                   rtol=RTOL)
        assert streamed["all_to_all"] == dev["all_to_all"]


def test_offload_param_on_a_tensor_axis_is_refused(launched):
    """``offload_param`` on a tensor axis trains now (each tensor rank
    streams its own blocks): within ``RTOL`` of the on-device tp-2 engine,
    one loss on both ranks (``test_torch_tp_train`` holds it to JAX's
    engine and checkpoints it)."""
    got = [r["tp_refusal"] for r in launched["get"](2)]
    for r in got:
        np.testing.assert_allclose(r["streamed"]["loss"],
                                   r["on_device"]["loss"], rtol=RTOL)
        np.testing.assert_allclose(r["streamed"]["grad_norm"],
                                   r["on_device"]["grad_norm"], rtol=RTOL)
        assert r["streamed"]["loss"] == got[0]["streamed"]["loss"]
