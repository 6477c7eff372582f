"""ZeRO-Offload of the port against the JAX package, on the CPU.

* the host optimizers (``ops/adam``: ``DeepSpeedCPUAdam`` with and without
  its bf16 emit, ``DeepSpeedCPUAdagrad``, ``DeepSpeedCPULion``) against the
  JAX package's on the same numpy inputs: **bit-equal** (the C++ source is
  the same file, built with the same flags);
* ``AIOHandle`` moves bytes to and from a file (offsets, truncation, the
  O_DIRECT / buffered split);
* the engine with ``offload_optimizer: cpu`` against JAX's offload engine,
  3 steps: in fp32 losses, grad norms and the host masters within 2e-4
  (the tolerance of JAX's ``test_offload``; masters in relative norm); on
  the bf16 wire the first step (the same bf16 weights) within 2e-4, the
  later steps within ``test_torch_train``'s bf16 bounds (2e-2 loss, 5e-2
  norm, masters 1e-2): the two frameworks round the bf16 model's
  activations at different points, about 1e-3 a step here; and against
  the port's on-device engine;
* fp16 with offload: the loss scale and the skipped steps equal JAX's
  offload engine's when every step overflows at first (the update is
  skipped, the scale halves, then grows);
* resume bit for bit, and an offload save loads without offload and the
  reverse; ``state_dict_arrays`` / ``load_state_arrays`` /
  ``reseed_masters`` round trip, and a universal directory loads into the
  host state;
* the host builder reads ``deepspeed_tpu_torch/csrc/host/`` alone, is keyed
  by the host CPU and raises without ``g++``; a client optimizer is refused
  under ``zero_force_ds_cpu_optimizer``.

The data-parallel cases (2 ranks, stages 1-3) run in
``tests/test_torch_zero.py``'s launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.ops import adam as jax_adam
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import (LlamaConfig, LlamaModel,
                                        llama_params_from_jax,
                                        llama_tree_to_jax_layout)
from deepspeed_tpu_torch.ops import adam as port_adam
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.aio import AIOHandle
from torch_parity import free_jax_cycles  # noqa: F401

_SHARED = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
           "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
           "rope_theta", "rms_norm_eps", "tie_embeddings", "sliding_window",
           "remat", "attn_impl")
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
TOL = 2e-4


# -- the host optimizers -------------------------------------------------------

def _host_inputs(seed=0):
    rs = np.random.RandomState(seed)
    params = [rs.randn(1000).astype(np.float32),
              rs.randn(17, 33).astype(np.float32),
              rs.randn(3).astype(np.float32)]
    grads = [[rs.randn(*p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    return params, grads


HOST_CASES = {
    "adamw": ("DeepSpeedCPUAdam", dict(lr=1e-2, weight_decay=0.1), False),
    "adam_l2": ("DeepSpeedCPUAdam", dict(lr=1e-2, weight_decay=0.1,
                                         adamw_mode=False), False),
    "adamw_bf16_emit": ("DeepSpeedCPUAdam", dict(lr=1e-2, betas=(0.8, 0.9),
                                                 eps=1e-6), True),
    "adagrad": ("DeepSpeedCPUAdagrad", dict(lr=0.05, weight_decay=0.01),
                False),
    "lion": ("DeepSpeedCPULion", dict(lr=1e-3, weight_decay=0.1), False),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_optimizers_bit_equal_jax(case):
    cls, kw, emit = HOST_CASES[case]
    params, grads = _host_inputs()
    want = getattr(jax_adam, cls)(params, **kw)
    got = getattr(port_adam, cls)([torch.from_numpy(p) for p in params],
                                  **kw)
    for step_grads in grads:
        if emit:
            w_out = [np.empty(p.shape, np.uint16) for p in params]
            g_out = [torch.empty(p.shape, dtype=torch.bfloat16)
                     for p in params]
            want.step(step_grads, bf16_out=w_out)
            got.step([torch.from_numpy(g) for g in step_grads],
                     bf16_out=g_out)
            for a, b in zip(w_out, g_out):
                np.testing.assert_array_equal(
                    b.view(torch.int16).numpy().view(np.uint16), a)
        else:
            want.step(step_grads)
            got.step([torch.from_numpy(g) for g in step_grads])
        for a, b in zip(want.params, got.params):
            np.testing.assert_array_equal(b.numpy(), a)
    for attr in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(getattr(want, attr, []), getattr(got, attr, [])):
            np.testing.assert_array_equal(b.numpy(), a)
    assert got.state_step == want.state_step == 3


def test_aio_round_trip(tmp_path):
    h = AIOHandle(block_size=1 << 16, queue_depth=4, thread_count=2)
    src = torch.arange(300_001, dtype=torch.float32)  # an unaligned tail
    path = str(tmp_path / "plane.bin")
    assert h.sync_pwrite(src, path, truncate=True) == 0
    back = torch.empty_like(src)
    assert h.sync_pread(back, path) == 0
    assert torch.equal(back, src)
    # an offset write inside the file, then a shorter truncating rewrite
    patch = torch.full((1024,), -1.0)
    assert h.sync_pwrite(patch, path, offset=4096 * 3) == 0
    h.sync_pread(back, path)
    want = src.clone()
    want[3072:3072 + 1024] = -1.0
    assert torch.equal(back, want)
    short = torch.arange(10, dtype=torch.int16)
    assert h.sync_pwrite(short, path, truncate=True) == 0
    assert (tmp_path / "plane.bin").stat().st_size == 20
    stats = h.stats()
    assert stats["direct_bytes"] + stats["buffered_bytes"] > 0
    assert h.sync_pread(torch.empty(10), str(tmp_path / "missing")) == 1
    with pytest.raises(ValueError, match="contiguous CPU"):
        h.async_pread(src[::2], path)


def test_host_builder_reads_its_own_sources(monkeypatch, tmp_path):
    root = op_builder.CSRC.parent.parent
    for b in (op_builder.CPU_ADAM, op_builder.ASYNC_IO):
        assert b.source.parent == root / "deepspeed_tpu_torch/csrc/host"
        assert b.source.read_bytes() == (
            root / "csrc" / {"cpu_adam": "adam",
                             "async_io": "aio"}[b.name] /
            b.source.name).read_bytes()  # a copy, unchanged
        assert b.library_path().parent == op_builder.BUILD_DIR / "host"
    # the CPU is in the key: another CPU builds another library
    before = op_builder.CPU_ADAM.library_path()
    monkeypatch.setattr(op_builder, "host_cpu_key", lambda: "another-cpu")
    assert op_builder.CPU_ADAM.library_path() != before
    fresh = op_builder.HostBuilder("cpu_adam_t", "cpu_adam.cpp",
                                   ["-fopenmp"])
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(op_builder.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        fresh.build()


# -- the engine ------------------------------------------------------------------

def _pair(dtype, seed=0):
    jcfg = JaxLlamaConfig.tiny(dtype=JNP[dtype], num_layers=2,
                               attn_impl="flash")
    jm = JaxLlamaModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    cfg = LlamaConfig(dtype=TORCH[dtype], param_dtype=torch.float32,
                      **{f: getattr(jcfg, f) for f in _SHARED})
    return jm, params, cfg, {k: v for k, v in llama_params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(params))).items()}


def _port_model(cfg, sd):
    tm = LlamaModel(cfg, device="cpu")
    tm.load_state_dict(sd, strict=True)
    return tm


def _config(dtype, offload, stage=0):
    zero = {"stage": stage}
    if offload:
        zero["offload_optimizer"] = {"device": "cpu"}
    return {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "bf16": {"enabled": dtype == "bfloat16"},
            "zero_optimization": zero}


def _batches(n=3):
    return [np.random.RandomState(40 + i).randint(0, 512, (4, 16))
            .astype(np.int32) for i in range(n)]


def _run(engine, to_batch):
    out = {"loss": [], "grad_norm": []}
    for b in _batches():
        m = engine.train_step(to_batch(b))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


def _rel(got, want):
    return np.linalg.norm(np.asarray(got, np.float64) - want) / \
        np.linalg.norm(np.asarray(want, np.float64))


def _assert_masters_close(got_tree, want_tree, tol=TOL, path=""):
    if isinstance(want_tree, dict):
        for k in want_tree:
            _assert_masters_close(got_tree[k], want_tree[k], tol,
                                  f"{path}/{k}")
        return
    assert _rel(got_tree, np.asarray(want_tree, np.float32)) <= tol, path


def _host_masters(engine):
    return llama_tree_to_jax_layout(
        dict(zip(engine.param_names, engine.offload_opt.masters)), 8, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offload_matches_jax_offload(dtype):
    jm, params, cfg, sd = _pair(dtype)
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    jeng, *_ = jdst.initialize(model=jm, model_parameters=params,
                               config=_config(dtype, True), mesh=mesh)
    assert jeng.offload_opt.wire_bf16 == (dtype == "bfloat16")
    want = _run(jeng, lambda b: {"input_ids": jnp.asarray(b)})
    st = jeng.offload_opt.state_dict_arrays()
    want_masters = jax.tree.unflatten(jeng.offload_opt.treedef,
                                      st["master"])

    engine, opt, *_ = dst.initialize(model=_port_model(cfg, sd),
                                     config=_config(dtype, True),
                                     device="cpu")
    assert opt is engine.offload_opt and engine.offload_enabled
    wire = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {p.dtype for p in engine.params} == {wire}
    assert all(m.device.type == "cpu" and m.dtype == torch.float32
               for m in engine.offload_opt.masters + opt.opt.exp_avg)
    got = _run(engine, lambda b: {"input_ids": torch.from_numpy(b)})
    loss_tol, norm_tol, master_tol = ((TOL, TOL, TOL) if dtype == "float32"
                                      else (2e-2, 5e-2, 1e-2))
    for k in ("loss", "grad_norm"):  # step 1: the same weights
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_tol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=norm_tol)
    _assert_masters_close(_host_masters(engine), want_masters, master_tol)
    assert set(engine.offload_opt.last_timings) >= {
        "d2h_wait_s", "host_opt_s", "h2d_s", "step_s"}

    # against the port's on-device engine from the same weights
    dev, *_ = dst.initialize(model=_port_model(cfg, sd),
                             config=_config(dtype, False), device="cpu")
    on_dev = _run(dev, lambda b: {"input_ids": torch.from_numpy(b)})
    tol = TOL if dtype == "float32" else 2e-2  # the wire's rounding
    np.testing.assert_allclose(got["loss"], on_dev["loss"], rtol=tol)
    np.testing.assert_allclose(got["grad_norm"], on_dev["grad_norm"],
                               rtol=tol)


def test_offload_fp16_skips_as_jax():
    """Every token the same (``test_torch_train``'s overflow case): the
    fp16 lm_head gradient overflows at 2^15, not after the scale halves."""
    jm, params, cfg, sd = _pair("float16")
    conf = dict(_config("float16", True), train_micro_batch_size_per_gpu=2,
                fp16={"enabled": True, "initial_scale_power": 16,
                      "hysteresis": 1, "loss_scale_window": 2})
    batches = [np.full((2, 16), 7, np.int32)] * 4

    def run(engine, to_batch):
        out = {"loss_scale": [], "skipped": [], "loss": []}
        for b in batches:
            m = engine.train_step(to_batch(b))
            out["loss_scale"].append(float(m["loss_scale"]))
            out["skipped"].append(int(engine.skipped_steps))
            out["loss"].append(float(m["loss"]))
        return out

    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    jeng, *_ = jdst.initialize(model=jm, model_parameters=params,
                               config=conf, mesh=mesh)
    want = run(jeng, lambda b: {"input_ids": jnp.asarray(b)})
    engine, *_ = dst.initialize(model=_port_model(cfg, sd), config=conf,
                                device="cpu")
    got = run(engine, lambda b: {"input_ids": torch.from_numpy(b)})
    assert got["loss_scale"] == want["loss_scale"]
    assert got["skipped"] == want["skipped"] == [1, 1, 1, 1]
    assert engine.offload_opt.count == 3  # three applied steps
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-2)


def test_offload_resumes_bit_for_bit_and_crosses_engines(tmp_path):
    _, _, cfg, sd = _pair("float32")
    b = {"input_ids": torch.from_numpy(_batches(1)[0])}
    runs = {}
    for offload in (True, False):
        e, *_ = dst.initialize(model=_port_model(cfg, sd),
                               config=_config("float32", offload),
                               device="cpu")
        for _ in range(2):
            e.train_step(b)
        e.save_checkpoint(str(tmp_path / f"offload{offload}"))
        runs[offload] = [float(e.train_step(b)["loss"]) for _ in range(2)]
    for saved in (True, False):
        for offload in (True, False):
            e, *_ = dst.initialize(model=_port_model(cfg, sd),
                                   config=_config("float32", offload),
                                   device="cpu")
            e.load_checkpoint(str(tmp_path / f"offload{saved}"))
            got = [float(e.train_step(b)["loss"]) for _ in range(2)]
            if saved == offload:  # resume: bit for bit
                assert got == runs[saved], (saved, offload)
            else:  # another engine: the other step's arithmetic
                np.testing.assert_allclose(got, runs[saved], rtol=1e-5)
    # bf16 wire: the fp32 masters travel, the card's bf16 copy follows
    _, _, cfg16, sd16 = _pair("bfloat16")
    e, *_ = dst.initialize(model=_port_model(cfg16, sd16),
                           config=_config("bfloat16", True), device="cpu")
    e.train_step(b)
    e.save_checkpoint(str(tmp_path / "bf16"))
    want = [float(e.train_step(b)["loss"]) for _ in range(2)]
    e2, *_ = dst.initialize(model=_port_model(cfg16, sd16),
                            config=_config("bfloat16", True), device="cpu")
    e2.load_checkpoint(str(tmp_path / "bf16"))
    for a, c in zip(e.offload_opt.masters[:1], e2.offload_opt.masters[:1]):
        assert not torch.equal(a, c)  # e took two more steps
    assert [float(e2.train_step(b)["loss"]) for _ in range(2)] == want


def test_offload_refusals_and_other_optimizers():
    _, _, cfg, sd = _pair("float32")
    conf = _config("float32", True)
    with pytest.raises(ValueError, match="zero_force_ds_cpu_optimizer"):
        dst.initialize(model=_port_model(cfg, sd), config=conf,
                       optimizer=object(), device="cpu")
    e, opt, *_ = dst.initialize(
        model=_port_model(cfg, sd), optimizer=object(), device="cpu",
        config=dict(conf, zero_force_ds_cpu_optimizer=False))
    assert opt is e.offload_opt
    b = {"input_ids": torch.from_numpy(_batches(1)[0])}
    for name, kind in (("Lion", "CPULion"), ("Adagrad", "CPUAdagrad")):
        e, *_ = dst.initialize(model=_port_model(cfg, sd), device="cpu",
                               config=dict(conf, optimizer={
                                   "type": name, "params": {"lr": 1e-3}}))
        assert e.offload_opt.kind == kind
        losses = [float(e.train_step(b)["loss"]) for _ in range(3)]
        assert losses[-1] < losses[0]


def test_offload_state_arrays_reseed_and_universal(tmp_path):
    """JAX's ``state_dict_arrays`` / ``load_state_arrays`` /
    ``reseed_masters`` round trip, and a universal directory loads into
    the host masters and moments (the step after it equals the saver's)."""
    from deepspeed_tpu_torch.utils import ds_to_universal

    _, _, cfg, sd = _pair("float32")
    b = {"input_ids": torch.from_numpy(_batches(1)[0])}
    conf = _config("float32", True)
    e, *_ = dst.initialize(model=_port_model(cfg, sd), config=conf,
                           device="cpu")
    for _ in range(2):
        e.train_step(b)
    arrays = {k: ([t.clone() for t in v] if isinstance(v, list) else v)
              for k, v in e.offload_opt.state_dict_arrays().items()}
    assert set(arrays) == {"exp_avg", "exp_avg_sq", "master", "step"}
    assert arrays["step"] == 2
    e2, *_ = dst.initialize(model=_port_model(cfg, sd), config=conf,
                            device="cpu")
    assert e2.offload_opt.load_state_arrays(arrays)
    for a, c in zip(arrays["master"], e2.offload_opt.masters):
        assert torch.equal(a, c)
    e2.offload_opt.reseed_masters([p.detach() for p in e.params])
    for a, c in zip(e.offload_opt.masters, e2.offload_opt.masters):
        assert torch.equal(a, c)  # fp32 wire: the card holds the masters
    e.save_checkpoint(str(tmp_path / "ckpt"))
    ds_to_universal.convert(str(tmp_path / "ckpt"), str(tmp_path / "uni"))
    want = float(e.train_step(b)["loss"])
    e3, *_ = dst.initialize(model=_port_model(cfg, sd), config=conf,
                            device="cpu")
    e3.load_universal_checkpoint(str(tmp_path / "uni"))
    assert e3.offload_opt.count == 2
    assert float(e3.train_step(b)["loss"]) == want
