"""Checkpoints of the port's engine, held against the JAX package's tests.

One test each for the JAX checkpoint tests, with the port's state cut over
gloo ranks on the CPU (``launcher.local.launch``, rank bodies in
``torch_ckpt_ranks``, no JAX there):

* ``test_checkpoint_roundtrip`` (``tests/unit/runtime/test_engine.py``):
  save at step 3, load into a model drawn from another seed, the next
  loss bit-equal to the unbroken run's, fp32 and bf16;
* ``test_checkpoint_reshard_across_stages``: the masters and Adam's
  moments saved at stage 3 by 2 ranks load bit-equal at stage 0 in one
  process and at stage 2 on 4 ranks; those 4 ranks' checkpoint loads
  bit-equal at stage 1 on 2;
* ``test_ckpt_save_world2_resume_world1`` / ``_world4``
  (``tests/unit/multiprocess/test_multiprocess.py``): the resumed runs
  continue the two ranks' losses (1e-5, the ZeRO tests' fp32 tolerance:
  another rank count sums in another order);
* ``test_zero_to_fp32_export`` (``tests/unit/test_feature_subsystems.py``),
  the copied script run from the save directory, and the gathered bf16
  state dict;
* ``test_async_checkpoint_roundtrip`` (``tests/unit/runtime/
  test_compat_surfaces.py``): training on after an async save does not
  change what was saved; ``latest`` appears only at ``wait()``;
* fused and plain Adam load each other's state; fp16 with an overflow skip
  keeps the loss scaler's state, the skipped steps and the scheduler's
  applied steps; a truncated or missing file raises
  ``CheckpointCorruptionError``; a model of other shapes or another
  optimizer raises naming the leaf or the type, and loads nothing;
* against JAX: the JAX engine trains the tiny Llama 3 steps, saves, runs
  its ``ds_to_universal`` and trains 2 more; its universal arrays, mapped
  to the port's names by the port's
  ``ds_to_universal.convert_jax_universal`` (``llama_params_from_jax``),
  continue in the port within rtol 3e-4
  (``tests/unit/launcher/test_cli_parity.py``'s
  tolerance); the port's own ``ds_to_universal`` continues the two ranks'
  run.
"""

import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
import torch_ckpt_ranks as ranks
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.ds_to_universal import main as jax_ds_to_universal
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    CheckpointCorruptionError, DecoupledCheckpointEngine,
    verify_sidecar_manifest)
from deepspeed_tpu_torch.runtime.optimizers import (Adagrad, Adam, Lion,
                                                    SGD)
from deepspeed_tpu_torch.runtime.precision import DynamicLossScaler
from deepspeed_tpu_torch.utils import ds_to_universal, zero_to_fp32
from torch_zero_ranks import OVERFLOW_TOKEN
from torch_parity import free_jax_cycles  # noqa: F401

TIMEOUT = 240
FP32_RTOL = 1e-5


def _assemble(per_rank, key):
    """Whole numpy leaves from every rank's slices (``state_slices``)."""
    out = {}
    for st in per_rank:
        for name, e in st["leaves"].items():
            pl = e["placement"]
            if pl is None:
                out.setdefault(name, e[key])
                continue
            full = out.setdefault(name, np.zeros(pl["full_shape"],
                                                 np.float32))
            n = pl["full_shape"][pl["dim"]] // pl["dp"]
            idx = [slice(None)] * full.ndim
            idx[pl["dim"]] = slice(pl["rank"] * n, (pl["rank"] + 1) * n)
            full[tuple(idx)] = e[key]
    return out


def _assert_state_equal(got, want, keys=("master", "m", "v")):
    for key in keys:
        a, b = _assemble(got, key), _assemble(want, key)
        assert set(a) == set(b)
        for name in b:
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{name} ({key})")
    assert {st["count"] for st in got} == {want[0]["count"]}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Two ranks save at stage 3 and train on; four ranks resume that at
    stage 2 and save; two of them resume that at stage 1."""
    root = tmp_path_factory.mktemp("ckpt")
    ckpt2, ckpt4 = str(root / "world2"), str(root / "world4")
    saved = launch(ranks.save_rank, 2, (ckpt2,), timeout=TIMEOUT)
    resumed = launch(ranks.resume_rank, 4, (ckpt2, ckpt4), timeout=TIMEOUT)
    return {"ckpt2": ckpt2, "ckpt4": ckpt4, "saved": saved,
            "resumed": resumed}


def _engine(stage=0, seed=9, dtype=torch.float32, **over):
    if dtype == torch.bfloat16:
        over["bf16"] = {"enabled": True}
    engine, *_ = dst.initialize(model=ranks.model(seed, dtype),
                                config=ranks.config(stage, **over),
                                device="cpu")
    return engine


def _one(engine, n, first):
    return ranks.train(engine, 0, 1, n, first)


def _masters(engine):
    return [p.detach().clone() for p in engine.params]


# -- one process ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    engine = _engine(seed=0, dtype=dtype)
    _one(engine, 3, 0)
    tag_dir = engine.save_checkpoint(str(tmp_path))
    assert tag_dir.endswith("global_step3")
    for f in ("latest", "zero_to_fp32.py"):
        assert (tmp_path / f).exists()
    assert (tmp_path / "latest").read_text() == "global_step3"
    assert sorted(os.listdir(tag_dir)) == [
        "client_state.json", "dp_rank_00000.pt", "ds_manifest.json"]
    meta = json.loads((tmp_path / "global_step3" / "client_state.json")
                      .read_text())
    assert set(meta) == {"global_steps", "micro_steps", "offload_step",
                         "infinity_step", "lr_scheduler", "client_state",
                         "ds_config_stage"}
    ref = _masters(engine)
    ref_next = _one(engine, 1, 3)

    e2 = _engine(seed=123, dtype=dtype)
    path, client = e2.load_checkpoint(str(tmp_path))
    assert path == tag_dir and client == {}
    for a, b in zip(ref, e2.params):
        assert torch.equal(a, b)
    assert e2.global_steps == 3 and e2.optimizer.count == 3
    assert _one(e2, 1, 3) == ref_next  # bit for bit


def test_async_checkpoint_roundtrip(tmp_path):
    over = {"checkpoint": {"checkpoint_engine": {"type": "async"}}}
    engine = _engine(seed=0, **over)
    assert isinstance(engine.checkpoint_engine, DecoupledCheckpointEngine)
    _one(engine, 3, 0)
    saved = _masters(engine)
    saved_m = [t.clone() for t in engine.optimizer.m]
    engine.save_checkpoint(str(tmp_path))
    assert not (tmp_path / "latest").exists()  # committed at wait()
    _one(engine, 3, 3)  # in-place updates while the writer runs
    assert not torch.equal(saved[0], engine.params[0])

    e2 = _engine(seed=5, **over)
    e2.load_checkpoint(str(tmp_path))  # joins the other engine's save
    assert (tmp_path / "latest").read_text() == "global_step3"
    for a, b in zip(saved + saved_m, e2.params + e2.optimizer.m):
        assert torch.equal(a, b)
    assert e2.global_steps == 3


def test_async_engine_serializes_back_to_back_saves(tmp_path):
    eng = DecoupledCheckpointEngine()
    tree = {"a": torch.arange(8.0), "b": torch.ones(4, 4)}
    done = []
    eng.save(tree, str(tmp_path / "t1.pt"), lambda: done.append(1))
    tree["a"].mul_(2)  # after the snapshot: not in t1
    eng.save(tree, str(tmp_path / "t2.pt"), lambda: done.append(2))
    assert done == [1]
    eng.wait()
    assert done == [1, 2]
    assert torch.equal(eng.load(str(tmp_path / "t1.pt"))["a"],
                       torch.arange(8.0))
    assert torch.equal(eng.load(str(tmp_path / "t2.pt"))["a"],
                       torch.arange(8.0) * 2)
    assert eng.commit("t2")


@pytest.mark.parametrize("save_fused", [True, False],
                         ids=["fused_to_plain", "plain_to_fused"])
def test_fused_and_plain_adam_state_interchange(tmp_path, save_fused):
    engine = _engine(seed=0, kernels={"fused_adam": save_fused})
    assert engine.fused_adam_enabled == save_fused
    _one(engine, 3, 0)
    engine.save_checkpoint(str(tmp_path))
    want = _one(engine, 2, 3)
    e2 = _engine(seed=4, kernels={"fused_adam": not save_fused})
    e2.load_checkpoint(str(tmp_path))
    assert e2.optimizer.count == 3
    assert _one(e2, 2, 3) == want


def test_fp16_overflow_skip_keeps_scaler_and_applied_steps(tmp_path):
    over = {"fp16": {"enabled": True, "initial_scale_power": 16,
                     "hysteresis": 1, "loss_scale_window": 2},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
                "warmup_num_steps": 8}}}
    batch = {"input_ids": torch.full((ranks.ROWS, 16), OVERFLOW_TOKEN)}

    def fp16_engine(seed):
        return _engine(seed=seed, dtype=torch.float16, **over)

    def run(engine, n):
        return [(float(m["loss"]), m["loss_scale"], m["lr"])
                for m in (engine.train_step(batch) for _ in range(n))]

    engine = fp16_engine(0)
    run(engine, 2)
    assert engine.skipped_steps == 1 and engine.optimizer.count == 1
    scaler = engine.loss_scaler.state_dict()
    assert scaler["growth_counter"] == 1  # the next clean step doubles
    engine.save_checkpoint(str(tmp_path))
    assert engine.lr_scheduler.last_step == 1  # applied steps
    want = run(engine, 3)

    e2 = fp16_engine(7)
    e2.load_checkpoint(str(tmp_path))
    assert e2.loss_scaler.state_dict() == scaler
    assert e2.skipped_steps == 1 and e2.global_steps == 2
    assert e2.lr_scheduler.last_step == 1
    assert run(e2, 3) == want


def test_torn_or_truncated_checkpoint_raises(tmp_path):
    engine = _engine(seed=0)
    _one(engine, 1, 0)
    tag_dir = engine.save_checkpoint(str(tmp_path))
    rank_file = os.path.join(tag_dir, "dp_rank_00000.pt")
    data = open(rank_file, "rb").read()
    with open(rank_file, "r+b") as f:  # same size, other bytes
        f.seek(len(data) // 2)
        f.write(bytes(b ^ 0xFF for b in data[len(data) // 2:
                                             len(data) // 2 + 64]))
    assert verify_sidecar_manifest(tag_dir)  # sizes still agree
    with pytest.raises(CheckpointCorruptionError, match="sha256"):
        verify_sidecar_manifest(tag_dir, strict=True)
    with open(rank_file, "wb") as f:
        f.write(data[: len(data) // 3])
    before = _masters(_engine(seed=2))
    e2 = _engine(seed=2)
    with pytest.raises(CheckpointCorruptionError, match="truncated"):
        e2.load_checkpoint(str(tmp_path))
    os.remove(rank_file)
    with pytest.raises(CheckpointCorruptionError, match="missing"):
        e2.load_checkpoint(str(tmp_path))
    for a, b in zip(before, e2.params):
        assert torch.equal(a, b)


def test_mismatched_model_or_optimizer_raises_and_loads_nothing(tmp_path):
    engine = _engine(seed=0)
    _one(engine, 1, 0)
    engine.save_checkpoint(str(tmp_path))
    saved = _masters(engine)
    wide = LlamaModel(LlamaConfig(**dict(ranks.MODEL, intermediate_size=384),
                                  dtype=torch.float32,
                                  param_dtype=torch.float32), device="cpu")
    e2, *_ = dst.initialize(model=wide, config=ranks.config(0), device="cpu")
    before = _masters(e2)
    with pytest.raises(ValueError, match="gate_proj.weight"):
        e2.load_checkpoint(str(tmp_path))
    for a, b in zip(before, e2.params):
        assert torch.equal(a, b)
    deep = LlamaModel(LlamaConfig(**dict(ranks.MODEL, num_layers=3),
                                  dtype=torch.float32,
                                  param_dtype=torch.float32), device="cpu")
    e3, *_ = dst.initialize(model=deep, config=ranks.config(0), device="cpu")
    with pytest.raises(ValueError, match="layers.2."):
        e3.load_checkpoint(str(tmp_path))
    # another optimizer: the module alone loads
    lion = _engine(seed=3, optimizer={"type": "Lion", "params": {"lr": 1e-4}})
    with pytest.raises(ValueError, match="Adam"):
        lion.load_checkpoint(str(tmp_path))
    lion.load_checkpoint(str(tmp_path), load_module_only=True)
    for a, b in zip(saved, lion.params):
        assert torch.equal(a, b)
    assert lion.optimizer.count == 0
    assert all(not t.any() for t in lion.optimizer.m)


def test_save_inside_an_accumulation_raises(tmp_path):
    engine = _engine(seed=0, gradient_accumulation_steps=2)
    batch = ranks.rows(ranks.batches(1)[0], 0, 2)
    engine.backward(engine(batch))
    with pytest.raises(RuntimeError, match="accumulation"):
        engine.save_checkpoint(str(tmp_path))
    engine.backward(engine(batch))
    engine.step()
    assert engine.save_checkpoint(str(tmp_path)).endswith("global_step1")


@pytest.mark.parametrize("cls", [Adam, Lion, SGD, Adagrad])
def test_optimizer_state_dict_round_trip(cls):
    def opt():
        torch.manual_seed(0)
        return cls([torch.randn(4, 3), torch.randn(5)])
    a, b = opt(), opt()
    for _ in range(2):
        a.step(1e-2, grads=[torch.randn(4, 3), torch.randn(5)])
    b.load_state_dict(a.state_dict())
    assert b.count == 2
    for k in cls.state_names:
        for x, y in zip(getattr(a, k), getattr(b, k)):
            assert torch.equal(x, y) and x is not y
    with pytest.raises(ValueError):
        (Lion if cls is not Lion else SGD)([torch.zeros(1)]).load_state_dict(
            a.state_dict())


def test_loss_scaler_state_dict_round_trip():
    a = DynamicLossScaler(initial_scale_power=10, loss_scale_window=3,
                          hysteresis=2)
    for overflow in (True, False, False):
        a.update(overflow)
    b = DynamicLossScaler(initial_scale_power=10, loss_scale_window=3,
                          hysteresis=2)
    b.load_state_dict(a.state_dict())
    for overflow in (False, True, True, False):
        a.update(overflow)
        b.update(overflow)
        assert a.state_dict() == b.state_dict()


# -- ranks -------------------------------------------------------------------

def test_ckpt_save_world2_resume_world1(launched):
    """Two ranks at stage 3 resume in one process at stage 0: the state
    bit for bit, the continued losses within the fp32 tolerance."""
    saved = launched["saved"]
    assert saved[0]["tag_dir"].endswith("global_step3")
    e1 = _engine(stage=0, seed=9)
    path, client = e1.load_checkpoint(launched["ckpt2"])
    assert client == {"consumed_samples": ranks.SAVE_AT * ranks.ROWS}
    assert e1.global_steps == ranks.SAVE_AT
    _assert_state_equal([ranks.state_slices(e1)],
                        [s["saved"] for s in saved])
    np.testing.assert_allclose(_one(e1, ranks.AFTER, ranks.SAVE_AT),
                               saved[0]["losses"][ranks.SAVE_AT:],
                               rtol=FP32_RTOL)


def test_ckpt_save_world2_resume_world4(launched):
    saved, resumed = launched["saved"], launched["resumed"]
    for r in resumed:
        assert r["global_steps"] == ranks.SAVE_AT
        assert r["client"] == {"consumed_samples": ranks.SAVE_AT * ranks.ROWS}
        np.testing.assert_allclose(r["losses"],
                                   saved[0]["losses"][ranks.SAVE_AT:],
                                   rtol=FP32_RTOL)


@pytest.mark.parametrize("case", ["stage3x2_to_stage0x1",
                                  "stage3x2_to_stage2x4",
                                  "stage2x4_to_stage1x2"])
def test_checkpoint_reshard_across_stages(launched, case):
    saved, resumed = launched["saved"], launched["resumed"]
    if case == "stage3x2_to_stage0x1":
        e0 = _engine(stage=0, seed=11)
        e0.load_checkpoint(launched["ckpt2"])
        got, want = [ranks.state_slices(e0)], [s["saved"] for s in saved]
    elif case == "stage3x2_to_stage2x4":
        got, want = [r["loaded"] for r in resumed], [s["saved"]
                                                      for s in saved]
        # stage 2 cuts m and v over 4 ranks; its masters are whole
        pl = [e["placement"] for e in got[1]["leaves"].values()]
        assert any(p is not None and p["dp"] == 4 for p in pl)
    else:
        got = [r["back"] for r in resumed[:2]]
        want = [r["saved"] for r in resumed]
        assert all(b["dp"] == 2 for b in got)
        assert resumed[2]["back"] is None
    _assert_state_equal(got, want)


def test_zero_to_fp32_export(launched, tmp_path):
    ckpt = launched["ckpt2"]
    whole = _assemble([s["saved"] for s in launched["saved"]], "master")
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(ckpt)
    assert list(sd) == list(ranks.model(0).state_dict())
    assert sum(v.numel() for v in sd.values()) == \
        ranks.model(0).config.num_params()
    for name, t in sd.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), whole[name])
    # the copy in the save directory, run as a script
    out = tmp_path / "fp32.pt"
    argv = sys.argv
    sys.argv = ["zero_to_fp32.py", ckpt, str(out)]
    try:
        runpy.run_path(os.path.join(ckpt, "zero_to_fp32.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    loaded = torch.load(out, weights_only=True)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    assert all(s["sd16_equal"] for s in launched["saved"])
    with pytest.raises(FileNotFoundError):
        zero_to_fp32.resolve_tag(str(tmp_path), None)


def test_port_universal_continues_the_ranks(launched, tmp_path):
    meta = ds_to_universal.convert(launched["ckpt2"], str(tmp_path))
    assert meta["step"] == ranks.SAVE_AT and meta["source_tag"] == \
        "global_step3"
    assert all(e["has_moments"] for e in meta["params"].values())
    e1 = _engine(stage=0, seed=13)
    e1.load_universal_checkpoint(str(tmp_path))
    _assert_state_equal([ranks.state_slices(e1)],
                        [s["saved"] for s in launched["saved"]])
    assert e1.global_steps == ranks.SAVE_AT
    np.testing.assert_allclose(_one(e1, ranks.AFTER, ranks.SAVE_AT),
                               launched["saved"][0]["losses"][ranks.SAVE_AT:],
                               rtol=FP32_RTOL)


# -- against JAX ---------------------------------------------------------------

def test_jax_universal_checkpoint_continues_in_the_port(tmp_path):
    """JAX: 3 steps, save, ``ds_to_universal``, 2 steps more.  The port's
    ``ds_to_universal.convert_jax_universal`` renames JAX's universal
    arrays (by ``llama_params_from_jax``; Adam's moments are elementwise,
    so the same map holds); the port loads them and gives JAX's next 2
    losses within rtol 3e-4."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, num_layers=2)
    jm = JaxLlamaModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    config = {"train_micro_batch_size_per_gpu": ranks.ROWS,
              "steps_per_print": 0,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 3e-3, "weight_decay": 0.01}}}
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    je, *_ = jdst.initialize(model=jm, model_parameters=params,
                             config=dict(config), mesh=mesh)
    data = ranks.batches(5)
    for b in data[:3]:
        je.train_step({"input_ids": jnp.asarray(b)})
    je.save_checkpoint(str(tmp_path / "jax"))
    want = [float(je.train_step({"input_ids": jnp.asarray(b)})["loss"])
            for b in data[3:]]
    assert jax_ds_to_universal(["--input_folder", str(tmp_path / "jax"),
                                "--output_folder", str(tmp_path / "ju")]) \
        == 0
    jmeta = json.loads((tmp_path / "ju" / "universal_metadata.json")
                       .read_text())
    assert jmeta["step"] == 3

    out = tmp_path / "pu"
    meta = ds_to_universal.convert_jax_universal(str(tmp_path / "ju"),
                                                 str(out), "llama")
    assert meta["step"] == 3 and meta["source_tag"] == jmeta["source_tag"]
    assert all(e["has_moments"] for e in meta["params"].values())

    tm = LlamaModel(LlamaConfig(
        **{f: getattr(jcfg, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_layers",
            "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
            "rope_theta", "rms_norm_eps", "tie_embeddings",
            "sliding_window", "remat", "attn_impl")},
        dtype=torch.float32, param_dtype=torch.float32), device="cpu",
        seed=21)
    engine, *_ = dst.initialize(model=tm, config=config, device="cpu")
    engine.load_universal_checkpoint(str(out))
    assert engine.optimizer.count == 3 and engine.global_steps == 3
    got = [float(engine.train_step({"input_ids": torch.from_numpy(b)})
                 ["loss"]) for b in data[3:]]
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=1e-6)
