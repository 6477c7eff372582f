"""Sequence parallelism of the port (Ulysses and ring, ALST's tiled loss
and MLP) against the JAX package.

One gloo launch on 2 ranks (sp 2) and one on 4 (sp 2 x dp 2 at ZeRO-3,
and the ring at sp 4), rank bodies in ``torch_sp_ranks`` (no JAX there);
the launches run in a thread while this process runs the JAX side on
device subsets of the 8 virtual CPU devices.  fp32 throughout.

* ``SequenceTiledCompute``, ``TiledMLP`` and ``sequence_tiled_loss``
  (with its one-tile fallback when ``S % tiles``) and their gradients
  against JAX's, to 1e-6; the Llama loss with ``loss_tiles`` 4;
* the dataloader adapter's slices equal JAX's; ``register_with_
  transformers`` returns the mpu or raises on the geometry;
  ``DistributedAttention`` refuses other layouts; the typed
  ``sequence_parallel`` group;
* ``ulysses_attention`` (and ``DistributedAttention``) at sp 2 and the
  ring at sp 4 (GQA at kv width, with and without a window), outputs and
  gradients against JAX's to 1e-5;
* Llama trained through ``initialize`` with ``sequence_parallel.sp_size``
  (3 steps): sp 2 on the flash route (the kernels' plain versions here),
  sp 2 with ``loss_tiles`` 4, sp 2 with ``-100`` on most of the first
  half (the global token mean and the chunk-boundary labels), sp 2 x dp 2
  at ZeRO-3, and the ring at sp 4 on a 2-head model, each against JAX's
  engine on the same mesh: losses and grad norms within 2e-4 relative,
  the final fp32 masters within 2e-4; every rank reports the same; the
  all-to-all count of the formula;
* checkpoints at sp 2 resume bit for bit and load in one process at sp 1;
  one rank file per data coordinate, whatever the seq size;
* the loader hands both seq ranks of a data coordinate the same rows;
* the refusals: ``S % sp``, heads % sp on the Ulysses route, ResNet
  under ``seq``; ZeRO-Infinity at sp 2 with dp 1 trains, and Mixtral and
  BERT are accepted under ``seq``.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
import torch_sp_ranks as ranks
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.config import \
    SequenceParallelConfig as JaxSequenceParallelConfig
from deepspeed_tpu.runtime.sequence_parallel import ring as jax_ring
from deepspeed_tpu.runtime.sequence_parallel import ulysses_sp as jax_sp
from deepspeed_tpu.sequence import DistributedAttention as JaxDistAttn
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import (llama_params_from_jax,
                                        llama_tree_to_jax_layout)
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                SequenceParallelConfig)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.sequence_parallel import (
    SequenceTiledCompute, TiledMLP, UlyssesSPDataLoaderAdapter,
    sequence_tiled_loss)
from test_torch_train import _assert_lr_equal
from torch_parity import free_jax_cycles, jax_tiny, port_model  # noqa: F401

TIMEOUT = 300
RTOL = 2e-4


def _jax_model(model: dict, attn: str = "xla", tiles: int = 1, mesh=None):
    return JaxLlamaModel(JaxLlamaConfig(**model, dtype=jnp.float32,
                                        attn_impl=attn, loss_tiles=tiles),
                         mesh=mesh)


def _weights(model: dict):
    params = jax.device_get(_jax_model(model).init_params(
        jax.random.PRNGKey(0)))
    return {k: v.numpy() for k, v in llama_params_from_jax(
        jax.tree.map(np.asarray, params)).items()}


def _jax_mesh(world: int, sp: int):
    return groups.initialize_mesh(mesh=build_mesh(
        MeshLayout.infer(world, sp=sp, dp=world // sp),
        devices=jax.devices()[:world]))


@functools.lru_cache(maxsize=None)
def _jax_train(name: str):
    """(params before, the step metrics, params after) of the JAX engine on
    the case's mesh."""
    world, sp, model, attn, tiles, _, _ = ranks.CASES[name]
    mesh = _jax_mesh(world, sp)
    jm = _jax_model(model, attn, tiles, mesh)
    params = jm.init_params(jax.random.PRNGKey(0))
    before = jax.device_get(params)
    engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                 config=ranks.case_config(name), mesh=mesh)
    want = {k: [] for k in ("loss", "grad_norm", "lr")}
    for b in ranks.global_batches(name):
        m = engine.train_step({k: jnp.asarray(v) for k, v in b.items()})
        for k in want:
            want[k].append(float(m[k]))
    return before, want, jax.device_get(engine.state.params)


def _jax_with_grads(fn, inputs):
    """``fn``'s output and the gradients of Σ out·cot (jitted vjp)."""
    q, k, v, cot = (jnp.asarray(x) for x in inputs)

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(cot)

    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(t) for t in run(q, k, v, cot))))


def _jax_attn(q, k, v):
    S = q.shape[1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """In a thread: the 2-rank launch, then the 4-rank one; the JAX side
    meanwhile.  ``get(world)`` waits for them."""
    root = tmp_path_factory.mktemp("sp_ckpt")
    weights, ring_weights = _weights(ranks.MODEL), _weights(ranks.RING_MODEL)
    result = {}

    def run():
        try:
            for world in (2, 4):
                result[world] = launch(
                    ranks.sp_rank, world,
                    (weights, ring_weights, str(root / f"w{world}")),
                    timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    for name in ranks.CASES:
        _jax_train(name)

    def get(world):
        thread.join()
        if "error" in result:
            raise result["error"]
        return result[world]
    yield {"get": get, "root": root, "weights": weights}
    thread.join()


def _chunks(got_ranks, key, what):
    """The ranks' chunks of ``got[key][what]`` along the sequence."""
    return np.concatenate([r[key][what] for r in got_ranks], axis=1)


# -- tiled compute ------------------------------------------------------------

def _silu_affine(t):
    return torch.nn.functional.silu(t) * 2.0 + 1.0


@pytest.mark.parametrize("tiles", [1, 4, 8])
def test_tiled_compute_matches_jax(tiles):
    x = np.random.RandomState(0).randn(2, 64, 8).astype(np.float32)
    jfn = lambda t: jax.nn.silu(t) * 2.0 + 1.0  # noqa: E731
    want, jvjp = jax.vjp(lambda t: jax_sp.SequenceTiledCompute.apply(
        jfn, t, tiles=tiles), jnp.asarray(x))
    cot = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    (want_grad,) = jvjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    got = SequenceTiledCompute.apply(_silu_affine, xt, tiles)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)
    mlp = TiledMLP.apply(_silu_affine, torch.from_numpy(x), tiles)
    np.testing.assert_allclose(mlp.numpy(), np.asarray(
        jax_sp.TiledMLP.apply(jfn, jnp.asarray(x), tiles)), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        SequenceTiledCompute.apply(_silu_affine, torch.zeros(2, 63, 8), 4)


@pytest.mark.parametrize("tiles", [1, 4, 5])
def test_tiled_loss_matches_jax(tiles):
    """Tiles 5 do not divide S 32: one tile, as JAX falls back."""
    rng = np.random.RandomState(0)
    B, S, H, V = 2, 32, 16, 64
    hidden = rng.randn(B, S, H).astype(np.float32)
    head = (rng.randn(H, V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, size=(B, S))
    labels[0, :5] = -100

    def jloss(h, w):
        return jax_sp.sequence_tiled_loss(
            lambda t: jnp.einsum("bsH,HV->bsV", t, w), h,
            jnp.asarray(labels), tiles)

    want, (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    got = sequence_tiled_loss(lambda t: t @ w, h, torch.from_numpy(labels),
                              tiles)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(gh), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), rtol=1e-6,
                               atol=1e-7)


def test_llama_loss_tiles_matches_jax():
    """``LlamaConfig.loss_tiles`` 4: the loss and every gradient equal the
    untiled port's and JAX's tiled loss."""
    jm, params = jax_tiny(num_layers=2, loss_tiles=4)
    ids = np.random.RandomState(0).randint(0, 512, size=(2, 32))
    want = float(jm.loss(params, {"input_ids": jnp.asarray(ids)}))
    model = port_model(jm, params)
    untiled = model.loss({"input_ids": torch.from_numpy(ids)})
    untiled.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    model.config = dataclasses_replace(model.config, loss_tiles=4)
    tiled = model.loss({"input_ids": torch.from_numpy(ids)})
    tiled.backward()
    np.testing.assert_allclose(tiled.item(), want, rtol=1e-6)
    np.testing.assert_allclose(tiled.item(), untiled.item(), rtol=1e-6)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-5, atol=1e-7)


def dataclasses_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


# -- adapter, registration, layout, config -------------------------------------

def test_adapter_slices_like_jax():
    groups.initialize_mesh(MeshLayout.infer(8, dp=4, sp=2))
    batch = {"input_ids": np.arange(2 * 16).reshape(2, 16),
             "mask": np.arange(2 * 16 * 3).reshape(2, 16, 3),
             "lengths": np.array([16, 9])}
    for rank in (0, 1):
        want = list(jax_sp.UlyssesSPDataLoaderAdapter(
            [batch], sp_rank=rank, sp_world_size=2))[0]
        for data in (batch, {k: torch.from_numpy(v)
                             for k, v in batch.items()}):
            got = list(UlyssesSPDataLoaderAdapter(
                [data], sp_rank=rank, sp_world_size=2))[0]
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]))
    assert len(UlyssesSPDataLoaderAdapter([batch] * 3, sp_rank=0,
                                          sp_world_size=2)) == 3
    with pytest.raises(ValueError, match="not divisible"):
        list(UlyssesSPDataLoaderAdapter([{"x": np.zeros((1, 15))}],
                                        sp_rank=0, sp_world_size=2))


def test_distributed_attention_refuses_other_layouts():
    for scatter, gather in ((1, 2), (2, 0)):
        with pytest.raises(NotImplementedError):
            JaxDistAttn(_jax_attn, scatter_idx=scatter, gather_idx=gather)
        with pytest.raises(NotImplementedError, match="layout"):
            dst.DistributedAttention(ranks._attn, scatter_idx=scatter,
                                     gather_idx=gather)


def test_sequence_parallel_config_group_is_jaxs():
    jax_default, port = JaxSequenceParallelConfig(), SequenceParallelConfig()
    for name in ("sp_size", "seq_length_is_variable", "attention_backend"):
        assert getattr(port, name) == getattr(jax_default, name), name
    cfg = DeepSpeedConfig.from_dict({"sequence_parallel": {
        "sp_size": 4, "attention_backend": "dot",
        "seq_length_is_variable": False}})
    sp = cfg.sequence_parallel
    assert (sp.sp_size, sp.attention_backend,
            sp.seq_length_is_variable) == (4, "dot", False)
    assert sp.extra == {} and cfg.extra == {}


def test_ring_without_a_mesh_is_plain_attention():
    """``attn_impl="ring"`` on a model without a mesh trains on plain
    attention (GQA expanded), as JAX's meshless ring model does."""
    jm, params = jax_tiny(num_layers=2, attn_impl="ring")
    ids = np.random.RandomState(3).randint(0, 512, size=(2, 16))
    want = float(jm.loss(params, {"input_ids": jnp.asarray(ids)}))
    model = port_model(jm, params)
    model.config = dataclasses_replace(model.config, attn_impl="ring")
    ring = float(model.loss({"input_ids": torch.from_numpy(ids)}))
    model.config = dataclasses_replace(model.config, attn_impl="xla")
    plain = float(model.loss({"input_ids": torch.from_numpy(ids)}))
    assert ring == plain
    np.testing.assert_allclose(ring, want, rtol=1e-6)


# -- the launches ---------------------------------------------------------------

def test_ulysses_attention_matches_jax(launched):
    got = launched["get"](2)
    inputs = ranks.attention_inputs(8, 8, 0)
    mesh = _jax_mesh(2, 2)
    want = _jax_with_grads(lambda q, k, v: jax_sp.ulysses_attention(
        _jax_attn, q, k, v, mesh=mesh), inputs)
    for key in ("ulysses", "distributed_attention"):
        for what in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(_chunks(got, key, what), want[what],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 12])
def test_ring_attention_matches_jax(launched, window):
    """Sp 4, 8 query heads over 2 kv heads rotating at kv width."""
    got = launched["get"](4)
    inputs = ranks.attention_inputs(8, 2, 1)
    mesh = _jax_mesh(4, 4)
    want = _jax_with_grads(lambda q, k, v: jax_ring.ring_attention(
        q, k, v, causal=True, mesh=mesh, window=window), inputs)
    for what in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(_chunks(got, f"ring_w{window}", what),
                                   want[what], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_training_matches_jax(launched, name):
    world, sp, model, attn, _, stage, _ = ranks.CASES[name]
    got = [r[name] for r in launched["get"](world)]
    before, want, after = _jax_train(name)
    base = launched["weights"] if model is ranks.MODEL else None
    if base is not None:  # the ranks started from JAX's weights
        np.testing.assert_array_equal(
            base["embed.weight"], np.asarray(before["embed"]))
    g = got[0]
    _assert_lr_equal(g["lr"], want["lr"])
    np.testing.assert_allclose(g["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(g["grad_norm"], want["grad_norm"], rtol=RTOL)
    port_after = llama_tree_to_jax_layout(
        {k: torch.from_numpy(v) for k, v in g["params"].items()},
        model["num_heads"], model["num_kv_heads"])
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=RTOL), port_after, after)
    assert g["loss"][-1] < g["loss"][0]
    # one model: every rank reports the same, bit for bit
    for r in got[1:]:
        assert r["loss"] == g["loss"] and r["grad_norm"] == g["grad_norm"]
        for k in g["params"]:
            np.testing.assert_array_equal(r["params"][k], g["params"][k])
    assert sorted((r["dp_rank"], r["sp_rank"]) for r in got) == sorted(
        (d, s) for d in range(world // sp) for s in range(sp))
    # per step and layer: 4 forward exchanges (q, k, v, out), 4 again in
    # the remat recompute, 4 in the backward; the ring exchanges none
    L = model["num_layers"]
    assert g["all_to_all"] == (0 if attn == "ring"
                               else ranks.STEPS * L * 12)
    assert g["cut"] == (2 * 7 + 2 if stage == 3 else 0)
    # eval_loss: the ranks' shares summed over seq, averaged over the data
    # coordinates: one process's mean of its rows' losses, on the weights
    # the ranks hold
    one = dst.LlamaModel(dataclasses_replace(ranks.model_config(name),
                                             attn_impl="xla"), device="cpu")
    one.load_state_dict({k: torch.from_numpy(v)
                         for k, v in g["params"].items()})
    dp = world // sp
    with torch.no_grad():
        want_eval = np.mean([float(one.loss(ranks.local_rows(
            ranks.global_batches(name)[0], d, dp))) for d in range(dp)])
    for r in got:
        np.testing.assert_allclose(r["eval"], want_eval, rtol=1e-5)


def test_checkpoint_resumes_bit_for_bit_and_loads_at_sp1(launched):
    got = [r["checkpoint"] for r in launched["get"](2)]
    for r in got:
        assert r["again"]["loss"] == r["first"]["loss"]
        assert r["again"]["grad_norm"] == r["first"]["grad_norm"]
        assert r["params_equal"]
        assert [f for f in r["files"] if f.endswith(".pt")] == [
            "dp_rank_00000.pt"]
    # one process at sp 1 loads the sp-2 save and takes the third step
    cfg = ranks.model_config("sp2")
    model = dst.LlamaModel(cfg, device="cpu", seed=7)
    config = dict(ranks.case_config("sp2"), sequence_parallel={"sp_size": 1})
    engine, *_ = dst.initialize(model=model, config=config, device="cpu")
    engine.load_checkpoint(str(launched["root"] / "w2"), tag="sp2")
    for k, v in model.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      got[0]["at_save"][k])
    m = engine.train_step({k: torch.from_numpy(v) for k, v in
                           ranks.global_batches("sp2")[2].items()})
    np.testing.assert_allclose(float(m["loss"]), got[0]["first"]["loss"][0],
                               rtol=1e-5)


def test_zero3_save_writes_one_file_a_data_coordinate(launched):
    """sp 2 x dp 2 at ZeRO-3 through the async engine: two rank files
    (seq rank 0 of each data coordinate), loaded in one process at stage
    0 and sp 1 bit for bit."""
    got = [r["sp2_dp2_zero3"] for r in launched["get"](4)]
    for r in got:
        assert [f for f in r["files"] if f.endswith(".pt")] == [
            "dp_rank_00000.pt", "dp_rank_00001.pt"]
    model = dst.LlamaModel(ranks.model_config("sp2_dp2_zero3"), device="cpu",
                           seed=9)
    engine, *_ = dst.initialize(model=model, config=dict(
        ranks.case_config("sp2"), sequence_parallel={"sp_size": 1}),
        device="cpu")
    engine.load_checkpoint(str(launched["root"] / "w4"), tag="zero3")
    for k, v in model.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      got[0]["params"][k])


def test_loader_rows_follow_the_data_coordinate(launched):
    got = launched["get"](4)
    cfg = DeepSpeedConfig.from_dict(ranks.case_config("sp2_dp2_zero3"))
    data = [{"input_ids": np.arange(i * ranks.SEQ, (i + 1) * ranks.SEQ)}
            for i in range(16)]
    for r in got:
        d = r["sp2_dp2_zero3"]["dp_rank"]
        want = DeepSpeedDataLoader(data, batch_size=2, dp_rank=d,
                                   dp_world_size=2, shuffle=True,
                                   seed=cfg.seed)
        for rows, batch in zip(r["loader_rows"], want):
            np.testing.assert_array_equal(rows, batch["input_ids"].numpy())
    assert not np.array_equal(got[0]["loader_rows"][0],
                              got[2]["loader_rows"][0])


def test_register_with_transformers(launched):
    for rank, r in enumerate(launched["get"](2)):
        assert r["mpu"] == [2, rank, 2, True, 2]
        assert "requested sp=4" in r["mpu_sp4"]
        assert "max_length 33 not divisible" in r["mpu_max_length"]


def test_refusals(launched):
    for r in launched["get"](2):
        v = r["refusals"]
        assert v["seq_not_divisible"].startswith("ValueError") and \
            "not divisible by sp=2" in v["seq_not_divisible"]
        # ZeRO-Infinity at sp 2 trains: finite, falling, one model
        assert np.all(np.isfinite(v["infinity"]))
        assert v["infinity"][1] < v["infinity"][0]
        assert v["infinity"] == launched["get"](2)[0]["refusals"]["infinity"]
        # Mixtral and BERT train under seq now (test_torch_seq_models);
        # ResNet has no sequence to cut (item 7d)
        assert v["mixtral"] == v["bert"] == "accepted", v
        assert v["resnet"].startswith("NotImplementedError") and \
            "ResNetModel under a seq axis is not ported yet (ROADMAP Queue " \
            "1 item 7d" in v["resnet"], v["resnet"]
    for r in launched["get"](4):
        assert "use attn_impl='ring'" in r["heads_not_divisible"]
