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
* a tensor axis with a ``seq`` or an ``expert`` axis is refused (ROADMAP
  Queue 1 item 5c).
"""

import functools
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
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.utils import groups
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import llama_params_from_jax
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
    return out


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
    ckpt = {k: str(root / k) for k in ("tp1", "tp2")}
    result = {}

    def run():
        try:
            _, engine = _one_process_engine(weights, "tp2_tiles1")
            for b in ranks.train_batches("tp2_tiles1")[:2]:
                engine.train_step({"input_ids": torch.from_numpy(b)})
            engine.save_checkpoint(ckpt["tp1"])
            for world in (2, 4):
                result[world] = launch(ranks.tp_train_rank, world, (
                    weights["llama"], weights["mixtral"], ckpt),
                    timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    for name in ranks.TRAIN_CASES:  # the JAX side meanwhile
        _jax_run(name)
    _jax_wg_grad()

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
    for r in launched["get"](4):
        for what in ("seq", "expert"):
            msg = r["refusals"][what]
            assert "not ported yet (ROADMAP Queue 1 item 5c)" in msg, msg
            assert f"a{'n' if what == 'expert' else ''} {what} axis" in msg
