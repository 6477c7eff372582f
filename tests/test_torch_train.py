"""The port's training path against the JAX package, from one init.

* ``LlamaModel.loss`` and its per-leaf gradients against ``jax.value_and_grad``
  of the JAX model's loss on ``LlamaConfig.tiny`` with GQA (8 query heads
  over 4 kv heads), under ``attn_impl`` "flash" and "xla", remat on and off;
* five ``train_step``s of the port's engine against five of the JAX
  engine: the ``loss``, ``grad_norm``, ``lr``, ``loss_scale`` and
  ``skipped_steps`` sequences, in fp32, bf16 and fp16 (with an overflow
  that skips; bf16 and fp16 also through ``attn_impl="flash"``), with
  gradient accumulation, clipping and a WarmupLR schedule, and the
  parameters after the steps for every ported optimizer;
* ``forward`` / ``backward`` / ``step`` against ``train_step``.

The JAX model draws the weights; ``llama_params_from_jax`` carries them into
the port, which keeps them as fp32 masters (``param_dtype=torch.float32``)
and computes in the config's dtype, as the JAX engine casts its masters.
Everything runs on the CPU, where the flash wrappers run their plain
versions.  Tolerances: fp32 1e-5 relative (another summation order); bf16
and fp16 2e-2 relative on the loss and 5e-2 on the grad norm (the two
frameworks round activations at different points); ``lr`` and the loss
scale are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import (LlamaConfig, LlamaModel,
                                        llama_grads_to_jax_layout,
                                        llama_params_from_jax,
                                        llama_tree_to_jax_layout)
from torch_parity import free_jax_cycles  # noqa: F401

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
_SHARED = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
           "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
           "rope_theta", "rms_norm_eps", "tie_embeddings", "sliding_window",
           "remat", "attn_impl")


def training_pair(dtype="float32", seed=0, **kw):
    """(JAX model, its fp32 params, the port's model on the CPU with the
    same weights as fp32 masters, computing in ``dtype``)."""
    jcfg = JaxLlamaConfig.tiny(dtype=JNP[dtype], **kw)
    jm = JaxLlamaModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    cfg = LlamaConfig(dtype=TORCH[dtype], param_dtype=torch.float32,
                      **{f: getattr(jcfg, f) for f in _SHARED})
    tm = LlamaModel(cfg, device="cpu")
    host = jax.tree.map(np.asarray, jax.device_get(params))
    tm.load_state_dict(llama_params_from_jax(host), strict=True)
    return jm, params, tm


def _ids(B, S, seed):
    return np.random.RandomState(seed).randint(0, 512, (B, S)).astype(
        np.int32)


def _assert_tree_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=path)


# -- the model's loss and gradients ----------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_loss_and_grads_match_jax(attn_impl, remat):
    jm, params, tm = training_pair(num_layers=2, attn_impl=attn_impl,
                                   remat=remat, sliding_window=11)
    ids = _ids(2, 24, 1)
    labels = np.roll(ids, -3, axis=1)
    labels[:, :4] = -100  # ignored positions
    batch = {"input_ids": ids, "labels": labels}
    want_loss, want_grads = jax.value_and_grad(jm.loss)(
        params, jax.tree.map(jnp.asarray, batch))
    loss = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    _assert_tree_close(llama_grads_to_jax_layout(tm),
                       jax.device_get(want_grads), rtol=1e-4, atol=2e-6)


def test_bf16_loss_and_grads_match_jax():
    jm, params, tm = training_pair("bfloat16", num_layers=2,
                                   attn_impl="flash")
    ids = _ids(2, 16, 2)
    want_loss, want_grads = jax.value_and_grad(jm.loss)(
        params, {"input_ids": jnp.asarray(ids)})
    loss = tm.loss({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    assert loss.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-2)
    got = llama_grads_to_jax_layout(tm)
    want = jax.device_get(want_grads)
    for path, g, w in (("lm_head", got["lm_head"], want["lm_head"]),
                       ("wq", got["layers"]["attn"]["wq"],
                        want["layers"]["attn"]["wq"]),
                       ("w_down", got["layers"]["mlp"]["w_down"],
                        want["layers"]["mlp"]["w_down"])):
        w = np.asarray(w, np.float32)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 5e-2, (path, rel)


def test_remat_recomputes_attention_and_keeps_the_gradient():
    """Under remat the layer's forward runs again in the backward (one
    more call of the attention) and the gradients do not change."""
    from deepspeed_tpu_torch.models import llama as port_llama

    calls = []
    real = port_llama.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    grads = {}
    for remat in (False, True):
        _, _, tm = training_pair(num_layers=2, attn_impl="flash",
                                 remat=remat)
        calls.clear()
        port_llama.flash_attention = counting
        try:
            tm.loss(torch.from_numpy(_ids(1, 16, 3))).backward()
        finally:
            port_llama.flash_attention = real
        assert len(calls) == (4 if remat else 2)
        grads[remat] = [p.grad.clone() for p in tm.parameters()]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_tree_layout_round_trip():
    _, params, tm = training_pair(num_layers=2)
    tree = llama_tree_to_jax_layout(
        {k: v for k, v in tm.state_dict().items()}, 8, 4)
    _assert_tree_close(tree, jax.device_get(params), 0, 0)


# -- the engine over five steps ----------------------------------------------

def _jax_engine(jm, params, config):
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                 config=dict(config), mesh=mesh)
    return engine


def _run(engine, batches, to_batch):
    seq = {k: [] for k in ("loss", "grad_norm", "lr", "loss_scale",
                           "skipped")}
    for b in batches:
        m = engine.train_step(to_batch(b))
        for k in ("loss", "grad_norm", "lr", "loss_scale"):
            seq[k].append(float(m[k]))
        seq["skipped"].append(int(engine.skipped_steps))
    return seq


def _assert_lr_equal(got, want):
    """The rates to float32 rounding: the arithmetic is the same, operation
    by operation, but the log warmup's ``log1p`` and the cosine come from
    two math libraries (numpy's and XLA's), which may round them a few
    float32 ulps apart."""
    np.testing.assert_allclose(np.float32(got), np.float32(want), rtol=1e-6,
                               atol=0)


def _assert_updates_close(before, got, want, rel=1e-3):
    """Per leaf, the port's parameter update (after minus before) is within
    ``rel`` of the JAX engine's in relative Frobenius norm.  An elementwise
    bound would not do: where a gradient entry is near 0, Adam's
    ``m / sqrt(v)`` turns a last-bit difference into a visible one."""
    if isinstance(want, dict):
        for k in want:
            _assert_updates_close(before[k], got[k], want[k], rel)
        return
    b = np.asarray(before, np.float32)
    du, dw = np.asarray(got) - b, np.asarray(want, np.float32) - b
    assert np.linalg.norm(du - dw) <= rel * np.linalg.norm(dw), \
        np.linalg.norm(du - dw) / np.linalg.norm(dw)


def _jax_batch(b):
    return {"input_ids": jnp.asarray(b)}


def _port_batch(b):
    return {"input_ids": torch.from_numpy(b)}


BASE = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 3e-3, "weight_decay": 0.01}}}

#: name -> (compute dtype, config overrides, model overrides, batch maker)
ENGINE_CASES = {
    "fp32": ("float32", {}, {}),
    "fp32_gas2_clip_warmup": ("float32", {
        "gradient_accumulation_steps": 2, "gradient_clipping": 0.5,
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
            "warmup_num_steps": 4}}}, {}),
    "bf16_flash": ("bfloat16", {"bf16": {"enabled": True}},
                   {"attn_impl": "flash"}),
    "fp16_flash": ("float16", {"fp16": {"enabled": True}},
                   {"attn_impl": "flash"}),
    # every token the same: the lm_head gradient is h * scale / gas in
    # fp16, which overflows at 2^15 and not after the scale halves
    "fp16_overflow_skip": ("float16", {
        "fp16": {"enabled": True, "initial_scale_power": 16,
                 "hysteresis": 1, "loss_scale_window": 2}}, {}),
}


def _batches(case, n=5):
    if case == "fp16_overflow_skip":
        return [np.full((2, 16), 7, np.int32)] * n
    rows = 2 * ENGINE_CASES[case][1].get("gradient_accumulation_steps", 1)
    return [_ids(rows, 16, 10 + i) for i in range(n)]


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_steps_match_jax(case):
    dtype, overrides, model_kw = ENGINE_CASES[case]
    config = dict(BASE, **overrides)
    jm, params, tm = training_pair(dtype, num_layers=2, **model_kw)
    before = jax.device_get(params)
    batches = _batches(case)
    jax_engine = _jax_engine(jm, params, config)
    want = _run(jax_engine, batches, _jax_batch)
    engine, opt, _, sched = dst.initialize(model=tm, config=config,
                                           device="cpu")
    assert opt is engine.optimizer and sched is engine.lr_scheduler
    got = _run(engine, batches, _port_batch)
    _assert_lr_equal(got["lr"], want["lr"])
    assert got["loss_scale"] == want["loss_scale"]
    assert got["skipped"] == want["skipped"]
    loss_tol, norm_tol = ((1e-5, 1e-5) if dtype == "float32"
                          else (2e-2, 5e-2))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_tol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=norm_tol, atol=1e-6)
    if case == "fp16_overflow_skip":  # skip, halve, then grow back
        assert got["skipped"] == [1] * 5
        assert got["loss_scale"] == [2.0 ** 15, 2.0 ** 14, 2.0 ** 14,
                                     2.0 ** 15, 2.0 ** 15]
    if dtype == "float32":
        _assert_updates_close(
            before, llama_tree_to_jax_layout(dict(tm.named_parameters()), 8,
                                             4),
            jax.device_get(jax_engine.state.params))


OPTIMIZERS = {
    "Adam_l2": {"type": "Adam", "params": {"lr": 2e-3, "weight_decay": 0.1}},
    "Lion": {"type": "Lion", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "SGD_momentum": {"type": "SGD", "params": {"lr": 0.5, "momentum": 0.9}},
    "Adagrad": {"type": "Adagrad", "params": {"lr": 0.05}},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    config = dict(BASE, optimizer=OPTIMIZERS[name])
    jm, params, tm = training_pair(num_layers=1)
    before = jax.device_get(params)
    batches = [_ids(2, 16, 20 + i) for i in range(3)]
    jax_engine = _jax_engine(jm, params, config)
    want = _run(jax_engine, batches, _jax_batch)
    engine, *_ = dst.initialize(model=tm, config=config, device="cpu")
    got = _run(engine, batches, _port_batch)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_updates_close(
        before, llama_tree_to_jax_layout(dict(tm.named_parameters()), 8, 4),
        jax.device_get(jax_engine.state.params))


# -- the DeepSpeed-style loop ------------------------------------------------

def test_forward_backward_step_equals_train_step():
    config = dict(BASE, gradient_accumulation_steps=2, gradient_clipping=1.0)
    runs = {}
    for how in ("train_step", "loop"):
        _, _, tm = training_pair(num_layers=1)
        engine, *_ = dst.initialize(model=tm, config=config, device="cpu")
        metrics = []
        for i in range(3):
            batch = torch.from_numpy(_ids(4, 16, 30 + i))
            if how == "train_step":
                metrics.append(engine.train_step(batch))
                continue
            for half in (batch[:2], batch[2:]):
                assert not engine.is_gradient_accumulation_boundary()
                assert engine.step() is None
                engine.backward(engine(half))
            assert engine.is_gradient_accumulation_boundary()
            metrics.append(engine.step())
        runs[how] = ([float(m["loss"]) for m in metrics],
                     [float(m["grad_norm"]) for m in metrics],
                     [p.detach().clone() for p in tm.parameters()],
                     engine.get_lr(), engine.get_global_grad_norm())
    a, b = runs["train_step"], runs["loop"]
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-6)
    for x, y in zip(a[2], b[2]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a[3] == b[3] and a[4] == b[4]


def test_eval_loss_has_no_graph_and_equals_the_loss():
    _, _, tm = training_pair(num_layers=1)
    engine, *_ = dst.initialize(model=tm, config=BASE, device="cpu")
    batch = torch.from_numpy(_ids(2, 16, 40))
    ev = engine.eval_loss(batch)
    assert not ev.requires_grad
    assert ev.item() == pytest.approx(engine(batch).item(), rel=1e-6)


def test_initialize_refuses_what_is_not_ported():
    _, _, tm = training_pair(num_layers=1)
    for bad in ({"zero_optimization": {"stage": 2,
                                       "zero_quantized_gradients": True}},
                {"zero_optimization": {"stage": 1, "mics_shard_size": 2}},
                {"zero_optimization": {"offload_optimizer":
                                       {"device": "cpu"}}},
                {"tensor_parallel": {"autotp_size": 2}},
                {"optimizer": {"type": "Lamb", "params": {}}}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            dst.initialize(model=tm, config=dict(BASE, **bad), device="cpu")
    # the dataloader is ported (tests/test_torch_dataloader.py)
    data = [{"input_ids": np.arange(16)}] * 4
    _, _, loader, _ = dst.initialize(model=tm, config=BASE,
                                     training_data=data, device="cpu")
    assert next(iter(loader))["input_ids"].shape == (2, 16)
    # the fused Adam step is ported (tests/test_torch_fused_adam.py)
    engine, *_ = dst.initialize(model=tm, config=dict(
        BASE, kernels={"fused_adam": True}), device="cpu")
    assert engine.fused_adam_enabled
    # groups whose planes are not ported are accepted without effect
    engine, *_ = dst.initialize(model=tm, config=dict(
        BASE, telemetry={"enabled": True}, comms_logger={"enabled": True},
        tuning={"auto_apply": False}), device="cpu")
    assert set(engine.config.accepted_without_effect) == {
        "telemetry", "comms_logger", "tuning"}
    with pytest.raises(ValueError, match="computes in"):
        dst.initialize(model=tm, config=dict(BASE, bf16={"enabled": True}),
                       device="cpu")
    bf16_model = LlamaModel(dataclasses.replace(tm.config,
                                                param_dtype=None,
                                                dtype=torch.bfloat16),
                            device="cpu")
    with pytest.raises(TypeError, match="fp32 masters"):
        dst.initialize(model=bf16_model, config=dict(
            BASE, bf16={"enabled": True}), device="cpu")


def test_batch_sizes_resolve_as_the_jax_config():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    for spec in ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2},
                 {"train_batch_size": 8, "gradient_accumulation_steps": 4},
                 {"train_micro_batch_size_per_gpu": 3},
                 {"train_batch_size": 6}, {}):
        want = JaxConfig.from_dict_or_path(dict(spec), world_size=1)
        got = DeepSpeedConfig.from_dict(dict(spec))
        got.resolve_batch_sizes(world_size=1)
        for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                    "gradient_accumulation_steps"):
            assert getattr(got, key) == getattr(want, key), (spec, key)
    with pytest.raises(ValueError, match="invariant"):
        DeepSpeedConfig.from_dict({
            "train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
            "gradient_accumulation_steps": 2}).resolve_batch_sizes(1)


@pytest.mark.parametrize("name", ["WarmupLR", "WarmupDecayLR",
                                  "WarmupCosineLR", "LRRangeTest",
                                  "OneCycle"])
def test_lr_schedules_match_jax(name):
    from deepspeed_tpu.runtime import lr_schedules as jax_sched
    from deepspeed_tpu_torch.runtime import lr_schedules as port_sched

    params = {"WarmupLR": {"warmup_max_lr": 0.01, "warmup_num_steps": 7},
              "WarmupDecayLR": {"total_num_steps": 20, "warmup_num_steps": 5,
                                "warmup_type": "linear"},
              "WarmupCosineLR": {"total_num_steps": 20,
                                 "warmup_num_steps": 5},
              "LRRangeTest": {"lr_range_test_step_size": 3,
                              "lr_range_test_staircase": True},
              "OneCycle": {"cycle_first_step_size": 4,
                           "decay_step_size": 2, "decay_lr_rate": 0.1}}[name]
    want = jax_sched.get_lr_schedule(name, dict(params))
    got = port_sched.get_lr_schedule(name, dict(params))
    _assert_lr_equal([got(step) for step in range(25)],
                     [float(want(jnp.int32(step))) for step in range(25)])
