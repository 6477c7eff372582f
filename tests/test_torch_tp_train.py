"""Tensor-parallel training of the port against the JAX package.

``initialize`` with ``tensor_parallel.autotp_size`` 2 on 2 and 4 gloo ranks
on the CPU (``launcher.local.launch``, rank bodies in ``torch_tp_ranks``,
no JAX there; one launch per rank count, in a thread while this process
runs the JAX side) trains the tiny Llama and Mixtral (2 layers, fp32
masters, the JAX models' weights carried across by ``models/convert.py``).
The JAX engine runs the same config on a mesh of as many of the 8 virtual
CPU devices, ``MeshLayout.infer(2, tp=2)`` or ``infer(4, dp=2, tp=2)``:

* Llama at tp 2, three AdamW steps with clipping, at ``loss_tiles`` 1
  and 2, split by ``tp_model_init`` before an ``initialize`` whose config
  names no tensor axis (the model's mesh gives it), and dp 2 x tp 2 at
  ZeRO 1 and 3: losses and grad norms within
  1e-5 relative, the masters joined from the ranks within 1e-5 of JAX's
  per leaf in relative norm (the updates within 1e-3, as
  ``test_torch_train``'s), the leaves that every tensor rank holds whole
  bit-equal on the ranks, and no op of a step returning a result as wide
  as the vocabulary (the vocabulary-parallel loss);
* Mixtral at tp 2: the same, and the router ``wg``'s first gradient equal
  on both ranks, bit for bit, and within 1e-5 of JAX's;
* fp16 at tp 2: an Inf in one rank's block of a gradient makes both ranks
  skip;
* checkpoints: tp 2 resumes at tp 2 bit for bit; a tp-2 save loads at tp 1,
  and ``zero_to_fp32`` and the universal layout give the whole leaves; a
  tp-1 save loads at tp 2 as each rank's block;
* the hybrid engine at tp 2: greedy tokens after a step equal one
  process's;
* Llama at tp 2 x sp 2 on the 4-rank launch (Ulysses on the flash route
  and the ring, ``loss_tiles`` 1 and 2) against JAX's engine on
  ``MeshLayout.infer(4, tp=2, sp=2)``: losses and grad norms within 1e-5
  relative, the masters within 1e-5 of JAX's per leaf in relative norm,
  every leaf the ranks hold whole bit-equal on the four, and the two
  ``seq`` coordinates holding the same model bit for bit; its checkpoint
  resumes at tp 2 x sp 2 bit for bit and loads at tp 1 x sp 1 as whole
  leaves;
* ZeRO-Infinity at tp 2 (the stash path, with clipping, and the fused
  path) within 2e-4 of the on-device tp-2 engine (the losses, the grad
  norms, the masters per leaf in relative norm), its save loaded by an
  on-device tp-2 engine bit for bit and by one process as whole leaves;
* OPT, BERT (non-causal flash on ``h/tp`` heads, pad tails) and ResNet
  (every leaf whole) at tp 2 against JAX's engine on a tensor-2 mesh, to
  the tolerances of the Llama cases;
* an HF-shaped client module split by AutoTP's name policy at tp 2
  against the same client at tp 1 and against JAX's engine, which applies
  ``infer_tp_specs`` to the same leaf names on a tensor-2 mesh;
  ``init_inference(tensor_parallel=...)`` on it gives the whole logits;
* a tensor axis with an ``expert`` axis is refused (ROADMAP Queue 1 item
  5d).
"""

import functools
import gc
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import torch_tp_ranks as ranks
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.models import BertConfig as JaxBertConfig
from deepspeed_tpu.models import BertModel as JaxBertModel
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu.models import OPTConfig as JaxOPTConfig
from deepspeed_tpu.models import OPTModel as JaxOPTModel
from deepspeed_tpu.models import ResNetConfig as JaxResNetConfig
from deepspeed_tpu.models import ResNetModel as JaxResNetModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.utils import groups
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import (bert_params_from_jax,
                                        llama_params_from_jax,
                                        opt_params_from_jax,
                                        resnet_params_from_jax)
from deepspeed_tpu_torch.models.llama import tp_split_dim
from deepspeed_tpu_torch.runtime.checkpointing import full_tensors
from deepspeed_tpu_torch.utils import ds_to_universal, zero_to_fp32
from test_torch_train import _assert_lr_equal
from torch_parity import free_jax_cycles  # noqa: F401

TIMEOUT = 300


def _jax_model(kind: str, mesh=None):
    if kind == "mixtral":
        return JaxMixtralModel(JaxMixtralConfig.tiny(
            dtype=jnp.float32, num_layers=2), mesh=mesh)
    return JaxLlamaModel(JaxLlamaConfig.tiny(dtype=jnp.float32,
                                             num_layers=2), mesh=mesh)


def _port_sd(params) -> dict:
    host = jax.tree.map(np.asarray, jax.device_get(params))
    return {k: v.numpy() for k, v in llama_params_from_jax(host).items()}


@pytest.fixture(scope="module")
def weights():
    out = {}
    for kind in ("llama", "mixtral"):
        jm = _jax_model(kind)
        out[kind] = _port_sd(jm.init_params(jax.random.PRNGKey(0)))
    port = ranks.train_model_config("tp2_tiles1")
    jcfg = _jax_model("llama").config
    for f in ranks.TRAIN_MODEL:
        assert getattr(port, f) == getattr(jcfg, f), f
    for kind in ranks.LADDER_KINDS:
        jm = _jax_ladder_model(kind)
        port = ranks.ladder_model(kind).config
        for f in ("vocab_size", "hidden_size", "ffn_dim", "intermediate_size",
                  "num_layers", "num_heads", "max_seq_len", "depth", "width",
                  "num_classes"):
            if hasattr(port, f):
                assert getattr(port, f) == getattr(jm.config, f), (kind, f)
        out[kind] = {k: v.numpy() for k, v in LADDER_FROM_JAX[kind](_host(
            jm.init_params(jax.random.PRNGKey(0)))).items()}
    out["client"] = ranks.np_weights(ranks.ClientLM(seed=0))
    return out


def _host(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


# -- the JAX side of the ladder models and the AutoTP client ---------------

LADDER_FROM_JAX = {"opt": opt_params_from_jax, "bert": bert_params_from_jax,
                   "resnet": resnet_params_from_jax}


def _jax_ladder_model(kind: str, mesh=None):
    if kind == "opt":
        return JaxOPTModel(JaxOPTConfig.tiny(num_layers=2, dtype=jnp.float32),
                           mesh=mesh)
    if kind == "bert":
        return JaxBertModel(JaxBertConfig.tiny(
            num_layers=2, dtype=jnp.float32, attn_impl="flash"), mesh=mesh)
    return JaxResNetModel(JaxResNetConfig.tiny(dtype=jnp.float32))


def _tensor_mesh(world: int = 2, **kw):
    return groups.initialize_mesh(mesh=build_mesh(
        MeshLayout.infer(world, tp=2, **kw), devices=jax.devices()[:world]))


def _jax_steps(engine, batches):
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        m = engine.train_step({k: jnp.asarray(v) for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


@functools.lru_cache(maxsize=None)
def _jax_ladder(kind: str):
    """(params before, metrics, params after) of the JAX engine on a
    tensor-2 mesh, in the port's layout."""
    mesh = _tensor_mesh()
    try:
        jm = _jax_ladder_model(kind, mesh)
        params = jm.init_params(jax.random.PRNGKey(0))
        before = _host(params)
        cfg = ranks.ladder_config(tp=1)
        engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                     config=cfg, mesh=mesh)
        out = _jax_steps(engine, ranks.ladder_batches(kind))
        conv = LADDER_FROM_JAX[kind]
        return ({k: v.numpy() for k, v in conv(before).items()}, out,
                {k: v.numpy() for k, v in conv(_host(
                    engine.state.params)).items()})
    finally:
        groups.reset_mesh()
        gc.collect()  # the engine's cycles hold its device arrays


def _client_to_jax(sd: dict) -> dict:
    """The client's state dict in JAX's layout: every matmul weight
    ``[in, out]`` (the embedding and the vectors as they are)."""
    return {k: (v.T.copy() if v.ndim == 2 and k != "embed_tokens.weight"
                else v) for k, v in sd.items()}


def _jax_layer_norm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / jnp.sqrt(var + eps) * w + b


def _jax_client_loss(p, batch):
    """``ranks.ClientLM.loss`` in jnp over the client's leaves (JAX
    layout, keyed by the torch names)."""
    c = ranks.CLIENT
    ids = batch["input_ids"]
    B, S = ids.shape
    hd = c["H"] // c["heads"]
    x = p["embed_tokens.weight"][ids]
    causal = jnp.tril(jnp.ones((S, S), bool))
    for i in range(c["layers"]):
        def w(n):
            return p[f"layers.{i}.{n}"]
        h = _jax_layer_norm(x, w("input_layernorm.weight"),
                            w("input_layernorm.bias"))
        q = (h @ w("self_attn.q_proj.weight") + w("self_attn.q_proj.bias")
             ).reshape(B, S, c["heads"], hd)
        k, v = ((h @ w(f"self_attn.{n}_proj.weight")
                 + w(f"self_attn.{n}_proj.bias")).reshape(
                     B, S, c["kv_heads"], hd) for n in ("k", "v"))
        rep = c["heads"] // c["kv_heads"]
        k, v = (jnp.repeat(t, rep, axis=2) for t in (k, v))
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        a = jax.nn.softmax(jnp.where(causal, s, -1e30), -1)
        o = jnp.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, -1)
        x = x + o @ w("self_attn.o_proj.weight") + w("self_attn.o_proj.bias")
        h = _jax_layer_norm(x, w("post_attention_layernorm.weight"),
                            w("post_attention_layernorm.bias"))
        m = jax.nn.silu(h @ w("mlp.gate_proj.weight")) * (
            h @ w("mlp.up_proj.weight"))
        x = x + m @ w("mlp.down_proj.weight") + w("mlp.down_proj.bias")
    x = _jax_layer_norm(x, p["norm.weight"], p["norm.bias"])
    logits = (x @ p["lm_head.weight"])[:, :-1]
    lp = jax.nn.log_softmax(logits, -1)
    return -jnp.mean(jnp.take_along_axis(lp, ids[:, 1:, None], -1))


@functools.lru_cache(maxsize=None)
def _jax_client():
    """(metrics, params after in the port's layout, the leaves' specs) of
    JAX's engine on a tensor-2 mesh over the client's leaves: its
    ``infer_tp_specs`` places them (no ``param_specs``)."""
    sd = ranks.np_weights(ranks.ClientLM(seed=0))
    mesh = _tensor_mesh()
    try:
        params = {k: jnp.asarray(v) for k, v in _client_to_jax(sd).items()}
        engine, *_ = jdst.initialize(model=_jax_client_loss,
                                     model_parameters=params,
                                     config=ranks.ladder_config(tp=1),
                                     mesh=mesh)
        specs = {k: v.sharding.spec for k, v in engine.state.params.items()}
        out = _jax_steps(engine, ranks.ladder_batches("opt"))
        after = _client_to_jax(_host(engine.state.params))
        return out, after, specs
    finally:
        groups.reset_mesh()
        gc.collect()  # the engine's cycles hold its device arrays


# -- tp 2 x sp 2 --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tpsp(name: str):
    """(params before, metrics, params after) of JAX's engine on
    ``MeshLayout.infer(4, tp=2, sp=2)``."""
    mesh = _tensor_mesh(4, sp=2)
    try:
        cfg = ranks.tpsp_model_config(name)
        jm = JaxLlamaModel(JaxLlamaConfig.tiny(
            dtype=jnp.float32, num_layers=2, attn_impl=cfg.attn_impl,
            loss_tiles=cfg.loss_tiles), mesh=mesh)
        params = jm.init_params(jax.random.PRNGKey(0))
        before = _port_sd(jax.device_get(params))
        c = dict(ranks.TRAIN_BASE, zero_optimization={"stage": 0})
        engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                     config=c, mesh=mesh)
        out = {"loss": [], "grad_norm": [], "lr": []}
        for b in ranks.train_batches("tp2_tiles1"):
            m = engine.train_step({"input_ids": jnp.asarray(b)})
            for k in out:
                out[k].append(float(m[k]))
        return before, out, _port_sd(jax.device_get(engine.state.params))
    finally:
        groups.reset_mesh()
        gc.collect()  # the engine's cycles hold its device arrays


def _one_process_engine(weights, name: str):
    cfg = ranks.train_config(name)
    cfg.pop("tensor_parallel", None)
    model = dst.LlamaModel(ranks.train_model_config(name), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights["llama"].items()})
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    return model, engine


@pytest.fixture(scope="module")
def launched(weights, tmp_path_factory):
    """In a thread: the one-process tp-1 save, the 2-rank launch, the
    4-rank launch; ``get(world)`` waits for them."""
    root = tmp_path_factory.mktemp("tp_ckpt")
    ckpt = {k: str(root / k) for k in ("tp1", "tp2", "tp2sp2", "inf_tp2")}
    more = {k: weights[k] for k in ranks.LADDER_KINDS + ("client",)}
    more["client_ids"] = CLIENT_IDS
    result = {}

    def run():
        try:
            _, engine = _one_process_engine(weights, "tp2_tiles1")
            for b in ranks.train_batches("tp2_tiles1")[:2]:
                engine.train_step({"input_ids": torch.from_numpy(b)})
            engine.save_checkpoint(ckpt["tp1"])
            for world in (2, 4):
                result[world] = launch(ranks.tp_train_rank, world, (
                    weights["llama"], weights["mixtral"], ckpt, more),
                    timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    for name in ranks.TRAIN_CASES:  # the JAX side meanwhile
        _jax_run(name)
    _jax_wg_grad()
    for kind in ranks.LADDER_KINDS:
        _jax_ladder(kind)
    _jax_client()
    for name in ranks.TPSP_CASES:
        _jax_tpsp(name)

    def get(world):
        thread.join()
        if "error" in result:
            raise result["error"]
        return result[world]
    yield {"get": get, "ckpt": ckpt}
    thread.join()


def _jax_run(name: str):
    """(params before, metrics, params after) of the JAX engine on the
    case's tensor mesh; cases that differ only in how the port splits its
    model share the first such case's run."""
    return _jax_case(next(n for n, c in ranks.TRAIN_CASES.items()
                          if c == ranks.TRAIN_CASES[name]))


@functools.lru_cache(maxsize=None)
def _jax_case(name: str):
    world, stage, tiles, kind = ranks.TRAIN_CASES[name]
    layout = MeshLayout.infer(world, dp=world // 2, tp=2)
    mesh = groups.initialize_mesh(mesh=build_mesh(
        layout, devices=jax.devices()[:world]))
    try:
        jm = _jax_model(kind, mesh)
        if tiles > 1:
            jm = JaxLlamaModel(JaxLlamaConfig.tiny(
                dtype=jnp.float32, num_layers=2, loss_tiles=tiles),
                mesh=mesh)
        params = jm.init_params(jax.random.PRNGKey(0))
        before = jax.device_get(params)
        cfg = ranks.train_config(name)
        cfg.pop("tensor_parallel", None)
        engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                     config=cfg, mesh=mesh)
        out = {"loss": [], "grad_norm": [], "lr": []}
        for b in ranks.train_batches(name):
            m = engine.train_step({"input_ids": jnp.asarray(b)})
            for k in out:
                out[k].append(float(m[k]))
        return (_port_sd(before), out,
                _port_sd(jax.device_get(engine.state.params)))
    finally:
        groups.reset_mesh()
        gc.collect()  # the engine's cycles hold its device arrays


@functools.lru_cache(maxsize=None)
def _jax_wg_grad():
    """JAX's gradient of the Mixtral loss at the initial weights on the
    first batch (one device), in the port's layout."""
    jm = JaxMixtralModel(JaxMixtralConfig.tiny(
        dtype=jnp.float32, num_layers=2, moe_dispatch_impl="sparse"))
    params = jm.init_params(jax.random.PRNGKey(0))
    batch = {"input_ids": jnp.asarray(
        ranks.train_batches("tp2_mixtral")[0])}
    grads = jax.grad(jm.loss)(params, batch)
    return _port_sd(grads)


def _joined(got, key="params"):
    """The whole leaves from the tensor ranks of data coordinate 0: a
    split leaf's blocks concatenated along its dim, a whole leaf rank
    0's (after checking every tensor rank holds it bit for bit)."""
    mine = [g for g in got if g["data_rank"] == 0]
    mine.sort(key=lambda g: g["tp_rank"])
    out = {}
    for k, v in mine[0][key].items():
        dim = tp_split_dim(k)
        if dim is None:
            for other in mine[1:]:
                assert np.array_equal(other[key][k], v), k
            out[k] = v
        else:
            out[k] = np.concatenate([g[key][k] for g in mine], axis=dim)
    return out


def _assert_masters_close(got, before, want, rel=1e-5, upd=1e-3):
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = np.linalg.norm(got[k] - w)
        assert err <= rel * np.linalg.norm(w), (k, err / np.linalg.norm(w))
        du, dw = got[k] - before[k], w - before[k]
        assert np.linalg.norm(du - dw) <= upd * np.linalg.norm(dw), \
            (k, np.linalg.norm(du - dw) / np.linalg.norm(dw))


@pytest.mark.parametrize("name", sorted(ranks.TRAIN_CASES))
def test_tp_training_matches_jax(launched, name):
    world, stage, _, kind = ranks.TRAIN_CASES[name]
    got = [r[name] for r in launched["get"](world)]
    before, want, after = _jax_run(name)
    for g in got:
        _assert_lr_equal(g["lr"], want["lr"])
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        assert g["skipped"] == [0] * ranks.TRAIN_STEPS
        # one model: every rank reports the same numbers
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
        # the head holds V/tp rows and no op result spans the vocabulary
        assert g["logits_shape"][0] == 512 // 2
        assert g["full_vocab_outputs"] == 0
        assert g["cut"] == (0 if stage == 0 else 2 * 7 + 2)
    assert sorted((g["data_rank"], g["tp_rank"]) for g in got) == [
        (d, t) for d in range(world // 2) for t in range(2)]
    joined = _joined(got)
    assert set(joined) == set(after)
    _assert_masters_close(joined, before, after)
    if world == 4:  # data coordinate 1 holds the same model
        other = _joined([dict(g, data_rank=1 - g["data_rank"])
                         for g in got])
        for k in joined:
            assert np.array_equal(joined[k], other[k]), k


def test_mixtral_router_gradient_is_whole_and_equal(launched):
    """The gate values multiply partial expert outputs; *f* on the combine
    weights makes the router's gradient (with the aux loss's share,
    counted once) whole: equal on both ranks and to JAX's."""
    got = [r["tp2_mixtral"] for r in launched["get"](2)]
    want = _jax_wg_grad()
    names = sorted(got[0]["wg_grad"])
    assert names == ["layers.0.wg", "layers.1.wg"]
    for n in names:
        assert np.array_equal(got[0]["wg_grad"][n], got[1]["wg_grad"][n]), n
        np.testing.assert_allclose(got[0]["wg_grad"][n], want[n], rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_fp16_overflow_on_one_rank_skips_both(launched):
    for r in launched["get"](2):
        f = r["fp16"]
        assert f["overflow"] == [True, False]
        assert f["loss_scale"] == [256.0, 128.0]
        assert f["skipped"] == 1 and f["unchanged"]


def test_checkpoints_across_tensor_sizes(launched, weights):
    got = launched["get"](2)
    ckpt = launched["ckpt"]
    for r in got:
        c = r["ckpt"]
        assert c["tp2_equal"]
        assert c["resumed_loss"] == c["original_loss"]
    # tp 2 -> whole leaves: zero_to_fp32, the universal layout and a
    # tp-1 engine
    whole = _joined([r["tp2_tiles1"] for r in got])
    saved = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        ckpt["tp2"])
    assert set(saved) == set(whole)
    universal = str(ckpt["tp2"]) + "_universal"
    meta = ds_to_universal.convert(ckpt["tp2"], universal)
    assert meta["step"] == 3
    for k, v in whole.items():
        assert np.array_equal(saved[k].numpy(), v), k
        assert np.array_equal(np.load(f"{universal}/zero/{k}/fp32.npy"),
                              v), k
    model, engine = _one_process_engine(weights, "tp2_tiles1")
    engine.load_checkpoint(str(ckpt["tp2"]))
    for k, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), whole[k]), k
    assert engine.optimizer.count == 3
    # tp 1 -> tp 2: each rank's block of the one-process save
    one = dict(full_tensors(str(ckpt["tp1"]) + "/global_step2"))
    m_one = dict(full_tensors(str(ckpt["tp1"]) + "/global_step2", "m"))
    for r in got:
        c, t = r["ckpt"], r["tp2_tiles1"]["tp_rank"]
        assert c["from_tp1_count"] == 2
        for k, v in one.items():
            dim = tp_split_dim(k)
            want = v.numpy() if dim is None else np.split(
                v.numpy(), 2, axis=dim)[t]
            assert np.array_equal(c["from_tp1"][k], want), k
            wm = m_one[k].numpy() if dim is None else np.split(
                m_one[k].numpy(), 2, axis=dim)[t]
            assert np.array_equal(c["from_tp1_moments"][f"m:{k}"], wm), k


def test_hybrid_engine_at_tp2_equals_one_process(launched, weights):
    got = [r["hybrid"] for r in launched["get"](2)]
    cfg = ranks.train_config("tp2_tiles1", hybrid_engine={"enabled": True})
    cfg.pop("tensor_parallel", None)
    model = dst.LlamaModel(ranks.train_model_config("tp2_tiles1"),
                           device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights["llama"].items()})
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    engine.train_step({"input_ids": torch.from_numpy(
        ranks.train_batches("tp2_tiles1")[0])})
    want = engine.generate(torch.tensor(ranks.HYBRID_PROMPT),
                           max_new_tokens=ranks.HYBRID_NEW).tolist()
    assert got[0] == got[1] == want


def test_tensor_with_seq_or_expert_axis_is_refused(launched):
    """A tensor axis with an expert axis trains (test_torch_expert_mesh),
    and with a seq axis (the tp 2 x sp 2 parity cases below: every rank
    took the same steps); with both, a Mixtral is refused (item 7c)."""
    got = launched["get"](4)
    for r in got:
        msg = r["refusals"]["expert"]
        assert "MixtralModel at tensor x seq is not ported yet (ROADMAP " \
            "Queue 1 item 7c: with an expert axis too)" in msg, msg
        for name in ranks.TPSP_CASES:
            assert r[name]["loss"] == got[0][name]["loss"], name
            assert np.all(np.isfinite(r[name]["loss"])), name


def _joined_by_dims(got, key="params"):
    """The whole leaves from the tensor ranks of one coordinate: a split
    leaf's blocks (``dims``) concatenated, a whole leaf the first rank's
    after checking every rank holds it bit for bit."""
    got = sorted(got, key=lambda g: g["tp_rank"])
    out = {}
    for k, v in got[0][key].items():
        dim = got[0]["dims"][k]
        if dim is None:
            for other in got[1:]:
                assert np.array_equal(other[key][k], v), k
            out[k] = v
        else:
            out[k] = np.concatenate([g[key][k] for g in got], axis=dim)
    return out


@pytest.mark.parametrize("name", sorted(ranks.TPSP_CASES))
def test_tp_sp_training_matches_jax(launched, name):
    """Llama at tp 2 x sp 2: each rank attends its ``h/tp`` heads of its
    ``S/sp`` chunk (Ulysses: ``h/(tp sp)`` at the full sequence; the
    ring: the ``h/tp`` heads around the seq group), the vocabulary-
    parallel loss over tensor, its share of the token mean over seq."""
    got = [r[name] for r in launched["get"](4)]
    before, want, after = _jax_tpsp(name)
    attn, _ = ranks.TPSP_CASES[name]
    L = ranks.TRAIN_MODEL["num_layers"]
    for g in got:
        _assert_lr_equal(g["lr"], want["lr"])
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
        assert g["skipped"] == [0] * ranks.TRAIN_STEPS
        assert g["full_vocab_outputs"] == 0
        assert g["local_heads"] == ranks.TRAIN_MODEL["num_heads"] // 2
        # Ulysses: 4 exchanges a layer in the forward, 4 in the remat's
        # recompute, 4 in the backward; the ring none
        assert g["all_to_all"] == (12 * L * ranks.TRAIN_STEPS
                                   if attn != "ring" else 0), g["all_to_all"]
    assert sorted((g["data_rank"], g["seq_rank"], g["tp_rank"])
                  for g in got) == [(0, s, t) for s in range(2)
                                    for t in range(2)]
    joined = {}
    for seq in range(2):
        mine = [dict(g, data_rank=0) for g in got if g["seq_rank"] == seq]
        joined[seq] = _joined(mine)
    for k in joined[0]:  # the seq coordinates hold one model
        assert np.array_equal(joined[0][k], joined[1][k]), k
    assert set(joined[0]) == set(after)
    _assert_masters_close(joined[0], before, after)


def test_tp_sp_checkpoint_resumes_and_loads_at_tp1_sp1(launched, weights):
    got = launched["get"](4)
    for r in got:
        c = r["tpsp_ckpt"]
        assert c["equal"]
        assert c["resumed_loss"] == c["original_loss"]
    whole = _joined([r["tp2sp2_ulysses_t1"] for r in got
                     if r["tp2sp2_ulysses_t1"]["seq_rank"] == 0])
    model, engine = _one_process_engine(weights, "tp2_tiles1")
    engine.load_checkpoint(launched["ckpt"]["tp2sp2"])
    for k, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), whole[k]), k
    assert engine.optimizer.count == ranks.TRAIN_STEPS


def test_infinity_under_tp_matches_on_device(launched):
    """ZeRO-Infinity at tp 2: each tensor rank streams its own planes (its
    blocks of the split leaves and the whole norms); within Infinity's
    bound of the on-device tp-2 engine, and the norms whole."""
    got = launched["get"](2)
    names = {"q_proj.weight", "k_proj.weight", "v_proj.weight",
             "o_proj.weight", "gate_proj.weight", "up_proj.weight",
             "down_proj.weight"}
    for r in got:
        inf, dev = r["infinity"], r["tp2_tiles1"]
        assert set(inf["split"]) == names
        assert inf["n_elems"] == inf["layer_numel"]
        st = inf["stash"]
        np.testing.assert_allclose(st["loss"], dev["loss"], rtol=2e-4)
        np.testing.assert_allclose(st["grad_norm"], dev["grad_norm"],
                                   rtol=2e-4)
        # one loss and one norm on the tensor ranks: the split leaves'
        # Σg² summed over tensor, the whole ones' counted once
        assert st["loss"] == got[0]["infinity"]["stash"]["loss"]
        assert st["grad_norm"] == got[0]["infinity"]["stash"]["grad_norm"]
        assert inf["fused"]["streamed"]["grad_norm"] == \
            got[0]["infinity"]["fused"]["streamed"]["grad_norm"]
        assert set(st["state"]) == set(dev["params"])
        for k, v in st["state"].items():
            w = dev["params"][k]
            assert np.linalg.norm(v - w) <= 2e-4 * np.linalg.norm(w), k
        f = inf["fused"]
        np.testing.assert_allclose(f["streamed"]["loss"],
                                   f["on_device"]["loss"], rtol=2e-4)
        np.testing.assert_allclose(f["streamed"]["grad_norm"],
                                   f["on_device"]["grad_norm"], rtol=2e-4)
        # the save, loaded by an on-device tp-2 engine: this rank's blocks
        assert inf["loaded_equal"] and inf["loaded_count"] == \
            ranks.TRAIN_STEPS


def test_infinity_tp_save_loads_at_tp1(launched, weights):
    got = launched["get"](2)
    whole = _joined([dict(r["infinity"]["stash"], params=r["infinity"][
        "stash"]["state"], tp_rank=r["infinity"]["tp_rank"], data_rank=0)
        for r in got])
    model, engine = _one_process_engine(weights, "tp2_tiles1")
    engine.load_checkpoint(launched["ckpt"]["inf_tp2"])
    for k, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), whole[k]), k
    assert engine.optimizer.count == ranks.TRAIN_STEPS


def _assert_biased_masters_close(got, before, want, rel=1e-5, upd=1e-3):
    """:func:`_assert_masters_close` for models with biases: a leaf that
    starts at zero (a bias, a LayerNorm shift) is its own update and is
    held to the update bound alone.  The key projection's bias adds one
    constant to each query's scores, which the softmax removes: its
    gradient is zero in exact arithmetic and its Adam steps are rounding
    noise in both frameworks.  A leaf with a real gradient moves about lr
    a step under Adam (every other leaf here: 8.9e-3 to 9.0e-3 in three
    steps); the key biases are held below a tenth of that."""
    lr = ranks.TRAIN_BASE["optimizer"]["params"]["lr"]
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.endswith("k_proj.bias"):
            for m in (got[k], w):
                assert np.abs(m - before[k]).max() <= \
                    0.1 * lr * ranks.TRAIN_STEPS, k
            continue
        if np.any(before[k]):
            err = np.linalg.norm(got[k] - w)
            assert err <= rel * np.linalg.norm(w), \
                (k, err / np.linalg.norm(w))
        du, dw = got[k] - before[k], w - before[k]
        assert np.linalg.norm(du - dw) <= upd * np.linalg.norm(dw), \
            (k, np.linalg.norm(du - dw) / np.linalg.norm(dw))


@pytest.mark.parametrize("kind", ranks.LADDER_KINDS)
def test_ladder_models_at_tp2_match_jax(launched, kind):
    """OPT and BERT split by their own ``shard_`` (JAX ``param_specs``),
    ResNet whole, against JAX's engine on a tensor-2 mesh."""
    got = [r[kind] for r in launched["get"](2)]
    before, want, after = _jax_ladder(kind)
    for g in got:
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
    split = {k for k, d in got[0]["dims"].items() if d is not None}
    if kind == "resnet":
        assert not split
    else:
        assert split == {f"layers.{i}.{n}" for i in range(2) for n in (
            "q_proj.weight", "q_proj.bias", "k_proj.weight", "k_proj.bias",
            "v_proj.weight", "v_proj.bias", "o_proj.weight", "fc_in.weight",
            "fc_in.bias", "fc_out.weight")}
    joined = _joined_by_dims(got)
    assert set(joined) == set(after)
    _assert_biased_masters_close(joined, before, after)


CLIENT_IDS = np.random.RandomState(7).randint(0, 512, (2, 12))


def test_autotp_client_matches_tp1_and_jax(launched, weights):
    """A client module without a split of its own: AutoTP's name policy
    splits q/k/v, gate/up and lm_head by rows, o_proj and down_proj by
    columns (their biases whole), divides the attention's head counts and
    all-gathers lm_head's output; at tp 2 it trains as the same client at
    tp 1 in one process and as JAX's engine placing the same names by
    ``infer_tp_specs``."""
    got = [r["client"] for r in launched["get"](2)]
    want, after, specs = _jax_client()
    model = ranks.ClientLM()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights["client"].items()})
    with torch.no_grad():
        logits = model(torch.from_numpy(CLIENT_IDS)).numpy()
    engine, *_ = dst.initialize(model=model, config=ranks.ladder_config(
        tp=1), device="cpu")
    one = ranks.train_steps(engine, ranks.ladder_batches("opt"))
    for g in got:
        for ref in (want, one):
            np.testing.assert_allclose(g["loss"], ref["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], ref["grad_norm"],
                                       rtol=1e-5)
        assert g["heads"] == [ranks.CLIENT["heads"] // 2,
                              ranks.CLIENT["kv_heads"] // 2]
        assert g["lm_head_gathers"]
        np.testing.assert_allclose(g["v1_logits"], logits, rtol=1e-5,
                                   atol=1e-5)
    dims = got[0]["dims"]
    for k, d in dims.items():
        # JAX's placement of the same leaf, transposed to torch's layout
        spec = tuple(specs[k])
        jdim = next((i for i, a in enumerate(spec) if a == "tensor"), None)
        if k.endswith("bias"):
            want_dim = 0 if any(n in k for n in ("q_proj", "k_proj",
                                                 "v_proj")) else None
        else:
            want_dim = None if jdim is None else 1 - jdim
        assert d == want_dim, (k, d, spec)
        if jdim is not None:
            assert d is not None, k
    joined = _joined_by_dims(got)
    tp1 = {k: p.detach().numpy() for k, p in model.named_parameters()}
    for ref in (tp1, after):
        assert set(joined) == set(ref)
        _assert_biased_masters_close(joined, weights["client"], ref)
