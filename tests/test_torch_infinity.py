"""ZeRO-Infinity (layer streaming) of the port against the JAX package's
``LayerStreamingEngine``, on the CPU.

The JAX model draws the weights and ``llama_params_from_jax`` (or
``mixtral_params_from_jax``) carries them into the port's model, which
``initialize`` takes with ``offload_param`` set: its trunk goes to the
swapper's tier, its resident leaves to the device (here the CPU).

* the fused path (gas 1) and the stash path (gas 2 with clipping):
  losses, grad norms and every master (in relative norm) within 2e-4 of
  JAX's streamed engine (JAX's ``test_streaming_matches_on_device``
  tolerance), and of the port's on-device ZeRO-0 engine;
* fp16: the loss scale and the skipped steps equal JAX's, losses within
  ``test_torch_train``'s fp16 bound (2e-2); an overflow skips every update
  (the Adam count and the step count hold) and halves the scale;
* Mixtral: the router's aux loss and its gradient through the streamed
  backward (3e-4, JAX's ``test_streaming_moe_aux_loss_matches`` bound);
* ``eval_loss`` against JAX's and the training step's loss;
* the nvme tier (``tmp_path``, a ring of 2 slots for 4 layers, so it
  evicts) equals the cpu tier bit for bit, and the pipelined host
  optimizer equals the serial one bit for bit (both paths, both tiers);
* resume bit for bit on both tiers; ``zero_to_fp32`` rebuilds every leaf,
  and ``ds_to_universal``'s directory streams back into a fresh engine;
* the flash calls a step (``2 x L x gas`` forwards) and the protocol's
  refusal of a model without it;
* a dropped engine frees its host planes and ends the pipeline's thread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import (LlamaConfig, LlamaModel,
                                        MixtralConfig, MixtralModel,
                                        llama_params_from_jax,
                                        llama_tree_to_jax_layout,
                                        mixtral_params_from_jax)
from deepspeed_tpu_torch.utils import zero_to_fp32
from torch_parity import free_jax_cycles  # noqa: F401

_SHARED = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
           "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
           "rope_theta", "rms_norm_eps", "tie_embeddings", "sliding_window",
           "remat", "attn_impl")
_MOE = ("num_experts", "top_k", "capacity_factor", "aux_loss_coef",
        "moe_dispatch_impl")
JNP = {"float32": jnp.float32, "float16": jnp.float16}
TORCH = {"float32": torch.float32, "float16": torch.float16}
TOL = 2e-4
LAYERS = 4

#: name -> (dtype, config overrides, Mixtral)
CASES = {
    "fused": ("float32", {}, False),
    "stash_gas2_clip": ("float32", {"gradient_accumulation_steps": 2,
                                    "gradient_clipping": 0.5}, False),
    "fp16": ("float16", {"fp16": {"enabled": True,
                                  "initial_scale_power": 8,
                                  "hysteresis": 1,
                                  "loss_scale_window": 2}}, False),
    "mixtral_aux": ("float32", {}, True),
}


@functools.lru_cache(maxsize=None)
def _weights(dtype, moe):
    if moe:
        jcfg = JaxMixtralConfig.tiny(num_layers=2, dtype=JNP[dtype])
        jm = JaxMixtralModel(jcfg)
    else:
        jcfg = JaxLlamaConfig.tiny(num_layers=LAYERS, dtype=JNP[dtype],
                                   attn_impl="flash")
        jm = JaxLlamaModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jax.device_get(params))
    sd = (mixtral_params_from_jax if moe else llama_params_from_jax)(host)
    return jcfg, host, {k: v.numpy() for k, v in sd.items()}


def _jax_model(dtype, moe):
    jcfg, host, _ = _weights(dtype, moe)
    jm = (JaxMixtralModel if moe else JaxLlamaModel)(jcfg)
    return jm, jax.tree.map(jnp.asarray, host)


def _port_model(dtype, moe):
    jcfg, _, sd = _weights(dtype, moe)
    fields = _SHARED + (_MOE if moe else ())
    cfg = (MixtralConfig if moe else LlamaConfig)(
        dtype=TORCH[dtype], param_dtype=torch.float32,
        **{f: getattr(jcfg, f) for f in fields})
    tm = (MixtralModel if moe else LlamaModel)(cfg, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return tm


def _config(case, offload_param=None, **zero):
    _, overrides, _ = CASES[case]
    z = {"stage": 3, **zero}
    if offload_param is not None:
        z["offload_param"] = offload_param
    return {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.0}},
            "zero_optimization": z, **overrides}


def _batches(case, n=3):
    rows = 4 * CASES[case][1].get("gradient_accumulation_steps", 1)
    return [np.random.RandomState(20 + i).randint(0, 512, (rows, 32))
            .astype(np.int32) for i in range(n)]


def _port_engine(case, offload_param=None, **zero):
    dtype, _, moe = CASES[case]
    engine, *_ = dst.initialize(model=_port_model(dtype, moe), device="cpu",
                                config=_config(case, offload_param, **zero))
    return engine


def _trajectory(engine, batches, to_batch):
    out = {k: [] for k in ("loss", "grad_norm", "loss_scale", "skipped")}
    for b in batches:
        m = engine.train_step(to_batch(b))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["loss_scale"].append(float(m["loss_scale"]))
        out["skipped"].append(int(bool(m["overflow"])))
    return out


def _torch_batch(b):
    return {"input_ids": torch.from_numpy(b)}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """(trajectory, masters in the JAX layout, eval loss before the steps)
    of JAX's streamed engine."""
    dtype, _, moe = CASES[case]
    jm, params = _jax_model(dtype, moe)
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    eng, *_ = jdst.initialize(model=jm, model_parameters=params, mesh=mesh,
                              config=_config(case, {"device": "cpu"}))
    assert eng.infinity is not None
    batches = _batches(case)
    ev = float(eng.eval_loss({"input_ids": jnp.asarray(batches[0])}))
    got = _trajectory(eng, batches,
                      lambda b: {"input_ids": jnp.asarray(b)})
    inf = eng.infinity
    layers = [inf.swapper.layer_master_tree(i) for i in range(inf.L)]
    masters = dict(jax.tree.map(np.asarray, dict(inf.resident)))
    masters["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return got, masters, ev


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / \
        max(np.linalg.norm(want), 1e-30)


def _assert_masters(got, want, tol, path=""):
    if isinstance(want, dict):
        for k in want:
            _assert_masters(got[k], want[k], tol, f"{path}/{k}")
        return
    assert _rel(got, want) <= tol, (path, _rel(got, want))


def _port_masters(engine):
    """Every master in the JAX layout: the trunk's layers are views of the
    cpu tier's masters, the resident leaves the engine's."""
    return llama_tree_to_jax_layout(
        {k: v.detach() for k, v in engine.module.named_parameters()}, 8, 4)


@pytest.mark.parametrize("case", ["fused", "stash_gas2_clip"])
def test_streaming_matches_jax_and_on_device(case):
    want, want_masters, _ = _jax_run(case)
    engine = _port_engine(case, {"device": "cpu"})
    inf = engine.infinity
    assert inf is not None and inf.swapper.nvme_dir is None
    got = _trajectory(engine, _batches(case), _torch_batch)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=TOL)
    assert got["loss"][-1] < got["loss"][0]
    _assert_masters(_port_masters(engine), want_masters, TOL)
    assert inf.swapper.state_step == 3 and engine.global_steps == 3
    # the port's on-device engine from the same weights
    dev = _port_engine(case)
    on_dev = _trajectory(dev, _batches(case), _torch_batch)
    np.testing.assert_allclose(got["loss"], on_dev["loss"], rtol=TOL)
    np.testing.assert_allclose(got["grad_norm"], on_dev["grad_norm"],
                               rtol=TOL)
    # the trunk never went to the device whole: two layer buffers
    sw = inf.swapper
    assert inf.peak_device_param_bytes() == 2 * sw.n_elems * 4
    assert inf.total_param_count() == engine.module.config.num_params()


def test_fp16_streaming_matches_jax_and_skips_on_overflow():
    want, _, _ = _jax_run("fp16")
    engine = _port_engine("fp16", {"device": "cpu"})
    got = _trajectory(engine, _batches("fp16"), _torch_batch)
    assert got["loss_scale"] == want["loss_scale"]
    assert got["skipped"] == want["skipped"] == [0, 0, 0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-2)
    # an overflow: a resident master at 1e38 is inf in fp16
    inf = engine.infinity
    steps, adam = inf.global_steps, inf.swapper.state_step
    scale = got["loss_scale"][-1]
    with torch.no_grad():
        inf.resident["embed.weight"].mul_(1e38)
    m = engine.train_step(_torch_batch(_batches("fp16")[0]))
    assert bool(m["overflow"]) and engine.skipped_steps == 1
    assert inf.global_steps == steps and inf.swapper.state_step == adam
    assert engine.optimizer.count == steps
    assert engine.loss_scaler.scale == scale / 2


def test_mixtral_aux_loss_streams():
    want, want_masters, _ = _jax_run("mixtral_aux")
    engine = _port_engine("mixtral_aux", {"device": "cpu"})
    assert engine.infinity.aux_coef == 0.02
    got = _trajectory(engine, _batches("mixtral_aux"), _torch_batch)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=3e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=3e-4)
    dev = _port_engine("mixtral_aux")
    on_dev = _trajectory(dev, _batches("mixtral_aux"), _torch_batch)
    np.testing.assert_allclose(got["loss"], on_dev["loss"], rtol=3e-4)
    router = [p for n, p in engine.module.named_parameters()
              if n.endswith(".wg")]
    moved = [p for n, p in dev.module.named_parameters()
             if n.endswith(".wg")]
    for a, b in zip(router, moved):  # the aux gradient reached the router
        assert _rel(a.detach().numpy(), b.detach().numpy()) <= 3e-4


def test_eval_loss_matches_jax_and_the_step():
    _, _, want_eval = _jax_run("fused")
    engine = _port_engine("fused", {"device": "cpu"})
    batch = _torch_batch(_batches("fused")[0])
    ev = engine.eval_loss(batch)
    assert not ev.requires_grad
    np.testing.assert_allclose(float(ev), want_eval, rtol=1e-5)
    assert float(engine.train_step(batch)["loss"]) == pytest.approx(
        float(ev), rel=1e-6)


def _digests(engine):
    return {k: v.detach().clone() for k, v in
            zip(engine.param_names, engine.params)} | {
        f"layer{i}": engine.infinity.swapper.layer_master_tree(i)
        for i in range(engine.infinity.L)}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", ["fused", "stash_gas2_clip"])
def test_nvme_equals_cpu_and_pipelined_equals_serial(case, tmp_path):
    runs = {}
    for tier in ("cpu", "nvme"):
        for pipelined in (True, False):
            param = ({"device": "cpu"} if tier == "cpu" else
                     {"device": "nvme", "buffer_count": 2, "nvme_path":
                      str(tmp_path / f"nv_{pipelined}")})
            opt = {} if pipelined else {"offload_optimizer": {
                "device": "cpu", "pipeline_read": False,
                "pipeline_write": False}}
            engine = _port_engine(case, param, **opt)
            sw = engine.infinity.swapper
            assert (sw._pipe is not None) == pipelined
            got = _trajectory(engine, _batches(case, 2), _torch_batch)
            runs[tier, pipelined] = (got["loss"], got["grad_norm"],
                                     _digests(engine))
            if tier == "nvme":
                assert sw.buffer_count < sw.L  # the ring evicts
                files = sorted(p.name for p in (tmp_path /
                                                f"nv_{pipelined}").iterdir())
                assert len(files) == 4 * LAYERS
                assert sw.io_bytes["disk_read"] > 0
                stats = sw.aio_stats()
                assert stats["direct_bytes"] + stats["buffered_bytes"] > 0
    ref = runs["cpu", False]
    for key, (loss, norm, digests) in runs.items():
        assert loss == ref[0] and norm == ref[1], key
        _assert_same(digests, ref[2])


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_checkpoint_resumes_bit_for_bit(tier, tmp_path):
    def param(tag):
        return ({"device": "cpu"} if tier == "cpu" else
                {"device": "nvme", "buffer_count": 2,
                 "nvme_path": str(tmp_path / f"nv_{tag}")})
    b = _torch_batch(_batches("fused")[0])
    e = _port_engine("fused", param("a"))
    for _ in range(2):
        e.train_step(b)
    tag_dir = e.save_checkpoint(str(tmp_path / "ckpt"))
    want = [float(e.train_step(b)["loss"]) for _ in range(2)]
    e2 = _port_engine("fused", param("b"))
    e2.load_checkpoint(str(tmp_path / "ckpt"))
    assert e2.infinity.swapper.state_step == 2 and e2.global_steps == 2
    assert [float(e2.train_step(b)["loss"]) for _ in range(2)] == want
    _assert_same(_digests(e2), _digests(e))
    # one file a layer beside the resident leaves; every leaf rebuilt
    import os
    assert sorted(f for f in os.listdir(tag_dir)
                  if f.startswith("infinity_layer_")) == [
        f"infinity_layer_{i:05d}.pt" for i in range(LAYERS)]
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "ckpt"))
    assert set(sd) == {n for n, _ in e.module.named_parameters()}


def test_flash_calls_and_the_training_loop(monkeypatch):
    from deepspeed_tpu_torch.models import llama as port_llama

    calls = []
    real = port_llama.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_llama, "flash_attention", counting)
    runs = {}
    for how in ("train_step", "loop"):
        engine = _port_engine("stash_gas2_clip", {"device": "cpu"})
        metrics = []
        for batch in _batches("stash_gas2_clip", 2):
            batch = torch.from_numpy(batch)
            calls.clear()
            if how == "train_step":
                metrics.append(engine.train_step({"input_ids": batch}))
                assert len(calls) == 2 * LAYERS * 2  # 2 x L x gas
                continue
            for half in (batch[:4], batch[4:]):
                assert engine.step() is None
                engine.backward(engine({"input_ids": half}))
            assert engine.is_gradient_accumulation_boundary()
            calls.clear()
            metrics.append(engine.step())
            assert len(calls) == 2 * LAYERS * 2
        runs[how] = [float(m["loss"]) for m in metrics]
    assert runs["loop"] == runs["train_step"]


def test_a_model_without_the_protocol_is_refused():
    w = torch.nn.Parameter(torch.zeros(4))
    with pytest.raises(ValueError, match="layer-streamable"):
        dst.initialize(model=lambda b: (w * 0).sum(), model_parameters=[w],
                       config=_config("fused", {"device": "cpu"}),
                       device="cpu")
    with pytest.raises(ValueError, match="nvme_path"):
        _port_engine("fused", {"device": "nvme"})


def test_a_dropped_engine_frees_its_planes():
    """The pipeline's worker thread holds the swapper weakly: dropping the
    engine frees the host planes and ends the thread."""
    import gc
    import weakref

    engine = _port_engine("fused", {"device": "cpu"})
    engine.train_step(_torch_batch(_batches("fused")[0]))
    sw = engine.infinity.swapper
    thread = sw._pipe._t
    ref = weakref.ref(sw)
    del engine, sw
    gc.collect()
    assert ref() is None
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_universal_checkpoint_streams_back(tmp_path):
    """``ds_to_universal`` of an Infinity save holds every leaf; loaded
    into a fresh streamed engine, the next steps equal the saver's."""
    from deepspeed_tpu_torch.utils import ds_to_universal

    b = _torch_batch(_batches("fused")[0])
    e = _port_engine("fused", {"device": "cpu"})
    for _ in range(2):
        e.train_step(b)
    e.save_checkpoint(str(tmp_path / "ckpt"))
    meta = ds_to_universal.convert(str(tmp_path / "ckpt"),
                                   str(tmp_path / "uni"))
    assert set(meta["params"]) == {n for n, _ in
                                   e.module.named_parameters()}
    want = [float(e.train_step(b)["loss"]) for _ in range(2)]
    e2 = _port_engine("fused", {"device": "cpu"})
    e2.load_universal_checkpoint(str(tmp_path / "uni"))
    assert e2.infinity.swapper.state_step == 2
    assert [float(e2.train_step(b)["loss"]) for _ in range(2)] == want
