"""The port's fused Adam (``ops/kernels/fused_adam.py``) and the engine's
``kernels.fused_adam`` step against the JAX package.

Mirrors ``tests/unit/ops/test_fused_optimizer.py`` and
``tests/unit/runtime/test_kernel_plane.py``:

* the plain ``reference_adam`` (what the wrapper runs on CPU tensors)
  against JAX ``reference_adam_tree`` and ``fused_adam_tree(interpret=
  True)``: on step 1 the moments and the parameters are bit-equal to
  ``reference_adam_tree``; against the interpreted Pallas kernel the
  moments are within 3e-8 and the parameters within 3e-7, absolute (the
  interpreter's XLA contracts ``a·b + c`` into FMAs; with L2 decay
  ``g·mult + wd·p`` may cancel, so no bound in ulps holds).  Adam with L2
  decay, AdamW, and ``mult`` ≠ 1;
* ``tree_sqsum`` against JAX's, and non-finite gradients poison it;
* the engine with ``kernels.fused_adam`` on against the JAX engine with it
  on: five steps' ``loss``, ``grad_norm`` and ``lr`` within 1e-5, tiny
  Llama and tiny Mixtral in fp32, with clipping; an fp16 run whose
  overflows skip the step;
* fused against unfused in the port, and a run that switches between them
  mid-way (one optimizer state): the same losses;
* SGD with ``kernels.fused_adam``: the gate stays off and the plain step
  runs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu.ops.pallas import fused_optimizer as jfo
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import (LlamaConfig, LlamaModel,
                                        MixtralConfig, MixtralModel,
                                        llama_params_from_jax)
from torch_parity import free_jax_cycles  # noqa: F401

# the package exports the wrapper under the module's name
tfa = importlib.import_module("deepspeed_tpu_torch.ops.kernels.fused_adam")

SHAPES = [(300, 7), (13,), (1,), (130,), (2, 3, 4)]
CONFIGS = {"adam": jfo.FusedAdamConfig(),
           "adam_l2_mult": jfo.FusedAdamConfig(weight_decay=0.02,
                                               decoupled_wd=False),
           "adamw": jfo.FusedAdamConfig(weight_decay=0.01)}
MULT = {"adam": 1.0, "adam_l2_mult": 0.37, "adamw": 1.0}


def _lists(seed, fresh=True):
    rng = np.random.RandomState(seed)
    p = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    g = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    if fresh:
        m = [np.zeros(s, np.float32) for s in SHAPES]
        v = [np.zeros(s, np.float32) for s in SHAPES]
    else:
        m = [0.1 * rng.randn(*s).astype(np.float32) for s in SHAPES]
        v = [np.abs(0.1 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    return p, g, m, v


def _port_step(lists, count_inc, lr, mult, cfg):
    p, g, m, v = ([torch.from_numpy(x.copy()) for x in xs] for xs in lists)
    tfa.fused_adam(p, g, m, v, count_inc, lr, mult,
                   tfa.FusedAdamConfig(*cfg))
    return p, m, v


def _jax_lists(lists):
    return [[jnp.asarray(x) for x in xs] for xs in lists]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_first_step_matches_jax_reference_and_kernel(name):
    cfg, mult, lr = CONFIGS[name], MULT[name], 1e-3
    lists = _lists(0)
    p, m, v = _port_step(lists, 1, lr, mult, cfg)
    want = jfo.reference_adam_tree(*_jax_lists(lists), 1, jnp.float32(lr),
                                   mult, cfg)
    kern = jfo.fused_adam_tree(*_jax_lists(lists), 1, jnp.float32(lr), mult,
                               cfg, interpret=True)
    for i in range(len(SHAPES)):
        for got, ref, k in ((p, want[0], kern[0]), (m, want[1], kern[1]),
                            (v, want[2], kern[2])):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
        for got, k, tol in ((m, kern[1], 3e-8), (v, kern[2], 3e-8),
                            (p, kern[0], 3e-7)):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(k[i]),
                                       rtol=0, atol=tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_later_steps_match_jax_reference(name):
    """From a used state (random moments) at step 7."""
    cfg, mult, lr = CONFIGS[name], MULT[name], 3e-4
    lists = _lists(1, fresh=False)
    p, m, v = _port_step(lists, 7, lr, mult, cfg)
    want = jfo.reference_adam_tree(*_jax_lists(lists), 7, jnp.float32(lr),
                                   mult, cfg)
    for got, ref in zip((p, m, v), want):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=3e-7)


def test_mult_folds_unscale_and_clip():
    """fused(g·scale, mult = factor/scale) == a step on the unscaled,
    clipped gradients (JAX ``test_mult_folds_unscale_and_clip``)."""
    p, g, m, v = _lists(5)
    scale, clip = 1024.0, 0.5
    gn = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g)))
    factor = min(1.0, clip / (gn + 1e-6))
    a = _port_step((p, [x * scale for x in g], m, v), 1, 1e-3,
                   factor / scale, jfo.FusedAdamConfig())
    b = _port_step((p, [(x * scale / scale) * factor for x in g], m, v), 1,
                   1e-3, 1.0, jfo.FusedAdamConfig())
    for x, y in zip(a[0], b[0]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=3e-7)


def test_tree_sqsum_matches_jax_and_flags_nonfinite():
    _, g, _, _ = _lists(3)
    want = jfo.tree_sqsum([jnp.asarray(x) for x in g], interpret=True)
    got = tfa.tree_sqsum([torch.from_numpy(x) for x in g])
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for bad in (np.inf, -np.inf, np.nan):
        gb = [x.copy() for x in g]
        gb[0][0, 0] = bad
        assert not torch.isfinite(
            tfa.tree_sqsum([torch.from_numpy(x) for x in gb]))
    assert tfa.tree_sqsum([]).item() == 0.0
    assert tfa.tree_sqsum.launches == tfa.fused_adam.launches == 0


def test_chunk_table_covers_every_element_once():
    numels = [1, 3, tfa.CHUNK, tfa.CHUNK + 5, 3 * tfa.CHUNK, 7]
    table = tfa.chunk_table(numels)
    index, start, length = table
    assert table.dtype == np.int64 and (start % tfa.CHUNK == 0).all()
    assert (length > 0).all() and (length <= tfa.CHUNK).all()
    for i, n in enumerate(numels):
        sel = index == i
        covered = np.zeros(n, int)
        for s, l in zip(start[sel], length[sel]):
            covered[s:s + l] += 1
        assert (covered == 1).all()


def test_wrapper_refuses_mismatched_lists():
    p, g, m, v = ([torch.from_numpy(x) for x in xs] for xs in _lists(0))
    with pytest.raises(ValueError, match="pair up"):
        tfa.fused_adam(p, g[:-1], m, v, 1, 1e-3)
    with pytest.raises(ValueError, match="devices"):
        tfa.fused_adam(p, g, m, [x.to("meta") for x in v], 1, 1e-3)


# -- the engine's fused step ------------------------------------------------

_SHARED = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
           "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
           "rope_theta", "rms_norm_eps", "tie_embeddings", "sliding_window",
           "remat", "attn_impl")
_MOE = ("num_experts", "top_k", "capacity_factor", "aux_loss_coef",
        "moe_dispatch_impl")
TORCH = {jnp.float32: torch.float32, jnp.float16: torch.float16}


def _pair(family, dtype=jnp.float32):
    """(JAX model, its params, a fresh port model with the same fp32
    masters) for ``family`` "llama" or "mixtral", 2 layers."""
    if family == "llama":
        jcfg = JaxLlamaConfig.tiny(num_layers=2, dtype=dtype)
        jm, cls, ccls, fields = JaxLlamaModel(jcfg), LlamaModel, \
            LlamaConfig, _SHARED
    else:
        jcfg = JaxMixtralConfig.tiny(num_layers=2, dtype=dtype)
        jm, cls, ccls, fields = JaxMixtralModel(jcfg), MixtralModel, \
            MixtralConfig, _SHARED + _MOE
    params = jm.init_params(jax.random.PRNGKey(0))
    host = llama_params_from_jax(jax.tree.map(np.asarray,
                                              jax.device_get(params)))

    def port():
        tm = cls(ccls(dtype=TORCH[dtype], param_dtype=torch.float32,
                      **{f: getattr(jcfg, f) for f in fields}), device="cpu")
        tm.load_state_dict(host, strict=True)
        return tm

    return jm, params, port


def _run(engine, batches, to_batch):
    seq = {k: [] for k in ("loss", "grad_norm", "lr", "loss_scale")}
    seq["skipped"] = []
    for b in batches:
        m = engine.train_step(to_batch(b))
        for k in ("loss", "grad_norm", "lr", "loss_scale"):
            seq[k].append(float(m[k]))
        seq["skipped"].append(int(engine.skipped_steps))
    return seq


def _batches(n=5, fp16=False):
    if fp16:  # every token the same: the head's gradient overflows at 2^15
        return [np.full((2, 16), 7, np.int32)] * n
    return [np.random.RandomState(10 + i).randint(0, 512, (2, 16)).astype(
        np.int32) for i in range(n)]


FUSED = {"kernels": {"fused_adam": True}}
CASES = {  # name: (family, dtype, config)
    "llama_adamw_clip": ("llama", jnp.float32, {
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-3,
                                                  "weight_decay": 0.01}},
        "gradient_clipping": 0.5}),
    "mixtral_adam_l2_clip": ("mixtral", jnp.float32, {
        "optimizer": {"type": "Adam", "params": {"lr": 2e-3,
                                                 "weight_decay": 0.02}},
        "gradient_clipping": 1.0}),
    "llama_fp16_overflow_skip": ("llama", jnp.float16, {
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}},
        "fp16": {"enabled": True, "initial_scale_power": 16,
                 "hysteresis": 1, "loss_scale_window": 2}}),
}


def _config(case):
    return dict({"train_micro_batch_size_per_gpu": 2, "steps_per_print": 0},
                **CASES[case][2], **FUSED)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_engine_matches_jax_fused_engine(case):
    family, dtype, _ = CASES[case]
    fp16 = dtype == jnp.float16
    jm, params, port = _pair(family, dtype)
    batches = _batches(fp16=fp16)
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    jengine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                  config=_config(case), mesh=mesh)
    assert jengine.fused_adam_enabled
    want = _run(jengine, batches, lambda b: {"input_ids": jnp.asarray(b)})
    engine, *_ = dst.initialize(model=port(), config=_config(case),
                                device="cpu")
    assert engine.fused_adam_enabled
    got = _run(engine, batches,
               lambda b: {"input_ids": torch.from_numpy(b)})
    np.testing.assert_allclose(np.float32(got["lr"]), np.float32(want["lr"]),
                               rtol=1e-6)
    assert got["loss_scale"] == want["loss_scale"]
    assert got["skipped"] == want["skipped"]
    tol = (2e-2, 5e-2) if fp16 else (1e-5, 1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol[0])
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=tol[1], atol=1e-6)
    if fp16:  # skip, halve, then grow back
        assert got["skipped"] == [1] * 5
        assert engine.optimizer.count == 4
    else:
        assert engine.optimizer.count == 5


def test_fused_and_plain_steps_share_one_state():
    """Fused against unfused in the port, and a run that switches from the
    fused step to the plain one after three steps: the same numbers."""
    _, _, port = _pair("mixtral")
    batches = _batches()
    config = _config("mixtral_adam_l2_clip")
    runs = {}
    for name in ("fused", "plain", "switch"):
        cfg = dict(config, kernels={"fused_adam": name != "plain"})
        engine, *_ = dst.initialize(model=port(), config=cfg, device="cpu")
        assert engine.fused_adam_enabled == (name != "plain")
        seq = []
        for i, b in enumerate(batches):
            if name == "switch" and i == 3:
                engine.fused_adam_enabled = False
            seq.append(float(engine.train_step(
                {"input_ids": torch.from_numpy(b)})["loss"]))
        assert engine.optimizer.count == 5
        runs[name] = seq
    # one arithmetic: the plain step is the fused kernel's plain version,
    # and the clip factor scales the gradients once either way
    assert runs["fused"] == runs["plain"] == runs["switch"]


def test_gate_stays_off_for_sgd():
    _, _, port = _pair("llama")
    config = dict(_config("llama_adamw_clip"),
                  optimizer={"type": "SGD", "params": {"lr": 0.1}})
    runs = {}
    for fused in (True, False):
        engine, *_ = dst.initialize(model=port(), config=dict(
            config, kernels={"fused_adam": fused}), device="cpu")
        assert not engine.fused_adam_enabled
        runs[fused] = [float(engine.train_step({"input_ids": torch.from_numpy(
            b)})["loss"]) for b in _batches(3)]
    assert runs[True] == runs[False]
