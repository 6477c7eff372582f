"""Mixtral, BERT and OPT trained under a ``seq`` axis, against the JAX
package.

One gloo launch on 2 ranks (rank bodies in ``torch_seq_ranks``, no JAX
there) in a thread while this process runs the JAX side on 2 of the 8
virtual CPU devices.  fp32 throughout.

* the MoE layer at sp 2 (sparse and dense rungs): each rank routes its
  ``S/sp`` chunk of the rows over the global tokens in JAX's ``(b, s)``
  order; the routing (expert ids, slots, keep mask) equals JAX's exactly,
  with tokens dropped; its output chunk, ``l_aux`` and the gradients of
  the tokens, the router and the experts (through the all-gather and its
  permutation) within 1e-5 of JAX's ``MOELayer`` on a ``seq`` mesh (the
  router's and the experts', summed over the ranks, within 1e-5
  absolute);
* Mixtral (capacity factor 0.75: tokens drop every step; ``aux_loss_coef``
  1, where an aux loss counted once a ``seq`` rank would add ~2 to the
  loss), BERT (pad tails across the chunk boundary,
  the flash route with the whole rows' padding as segment ids) and OPT
  (the flash route, causal) trained 3 steps through ``initialize`` with
  ``sequence_parallel.sp_size`` 2 against JAX's engine on a ``seq``
  mesh: losses and grad norms within 2e-4 relative, the final fp32
  masters within 2e-4 and their updates within 1e-3 (per leaf, relative
  in Frobenius norm: :func:`assert_masters_close`); both ranks hold one
  model bit for bit;
* the compositions with ``seq`` left unported are refused by name: BERT,
  OPT and Mixtral at tensor x ``seq`` (ROADMAP Queue 1 item 7c), ep x tp x
  ``seq`` (7c), Mixtral under ``offload_param`` with ``seq`` (9c), ResNet
  under ``seq`` (7d).
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
import torch_seq_ranks as ranks
from deepspeed_tpu.models import BertConfig as JaxBertConfig
from deepspeed_tpu.models import BertModel as JaxBertModel
from deepspeed_tpu.models import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models import MixtralModel as JaxMixtralModel
from deepspeed_tpu.models import OPTConfig as JaxOPTConfig
from deepspeed_tpu.models import OPTModel as JaxOPTModel
from deepspeed_tpu.moe.layer import swiglu_expert_fn as jax_swiglu
from deepspeed_tpu.moe.sharded_moe import MOELayer as JaxMOELayer
from deepspeed_tpu.moe.sharded_moe import TopKGate as JaxTopKGate
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import (bert_params_from_jax,
                                        mixtral_params_from_jax,
                                        opt_params_from_jax)
from deepspeed_tpu_torch.models.llama import is_expert_leaf, tp_split_dim
from test_torch_train import _assert_lr_equal
from torch_parity import free_jax_cycles  # noqa: F401

TIMEOUT = 300
RTOL = 2e-4
FROM_JAX = {"mixtral": mixtral_params_from_jax, "bert": bert_params_from_jax,
            "opt": opt_params_from_jax}


def jax_model(name: str, mesh=None):
    kind, _, over = ranks.TRAIN_CASES[name]
    if kind == "mixtral":
        return JaxMixtralModel(JaxMixtralConfig.tiny(
            dtype=jnp.float32, num_layers=2,
            capacity_factor=ranks.CAPACITY_FACTOR, **over), mesh=mesh)
    if kind == "bert":
        return JaxBertModel(JaxBertConfig.tiny(
            num_layers=2, dtype=jnp.float32, attn_impl="flash"), mesh=mesh)
    return JaxOPTModel(JaxOPTConfig.tiny(num_layers=2, dtype=jnp.float32),
                       mesh=mesh)


def _port_tree(name: str, params) -> dict:
    host = jax.tree.map(np.asarray, jax.device_get(params))
    return {k: v.numpy() for k, v in
            FROM_JAX[ranks.TRAIN_CASES[name][0]](host).items()}


def jax_mesh(ep: int = 1, sp: int = 1, tp: int = 1):
    world = ep * sp * tp
    return groups.initialize_mesh(mesh=build_mesh(
        MeshLayout.infer(world, ep=ep, sp=sp, tp=tp),
        devices=jax.devices()[:world]))


def case_weights(names) -> dict:
    """The reference weights of each case (JAX's init, carried across),
    after checking that the port's config is JAX's."""
    out = {}
    for name in names:
        jm = jax_model(name)
        port = ranks.model_config(name)
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "ffn_dim", "num_layers", "num_heads", "num_kv_heads",
                  "max_seq_len", "num_experts", "top_k", "capacity_factor",
                  "aux_loss_coef", "remat"):
            if hasattr(jm.config, f):
                assert getattr(port, f) == getattr(jm.config, f), (name, f)
        out[name] = _port_tree(name, jm.init_params(jax.random.PRNGKey(0)))
    return out


@functools.lru_cache(maxsize=None)
def jax_train(name: str):
    """(metrics, params after) of JAX's engine on the case's mesh, in the
    port's layout."""
    ep, sp, tp = ranks.TRAIN_CASES[name][1]
    mesh = jax_mesh(ep, sp, tp)
    try:
        jm = jax_model(name, mesh)
        params = jm.init_params(jax.random.PRNGKey(0))
        cfg = ranks.case_config(name)
        cfg.pop("tensor_parallel")
        engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                     config=cfg, mesh=mesh)
        out = {k: [] for k in ("loss", "grad_norm", "lr")}
        for b in ranks.batches(name):
            m = engine.train_step({k: jnp.asarray(v) for k, v in b.items()})
            for k in out:
                out[k].append(float(m[k]))
        return out, _port_tree(name, engine.state.params)
    finally:
        groups.reset_mesh()
        gc.collect()  # the engine's cycles hold its device arrays


@functools.lru_cache(maxsize=None)
def jax_route(name: str):
    """JAX's ``MOELayer`` on the case's mesh over the global input: the
    output, the capacity, ``l_aux``, the routing of the global tokens and
    the gradients of ``Σ y·cot + ROUTE_AUX·l_aux``."""
    ep, sp, impl = ranks.ROUTE_CASES[name]
    inp = ranks.route_inputs(name)
    gate = JaxTopKGate(num_experts=ranks.ROUTE_E, k=ranks.ROUTE_K,
                       capacity_factor=ranks.CAPACITY_FACTOR)
    layer = JaxMOELayer(gate, jax_swiglu, mesh=build_mesh(
        MeshLayout.infer(ep * sp, ep=ep, sp=sp),
        devices=jax.devices()[:ep * sp]), dispatch_impl=impl)
    names = ranks.EXPERT_LEAVES

    def f(wg, experts, x):
        y, l_aux, meta = layer(wg, experts, x)
        return ((y * jnp.asarray(inp["cot"])).sum()
                + ranks.ROUTE_AUX * l_aux), (y, l_aux, meta)

    args = (jnp.asarray(inp["wg"]), {k: jnp.asarray(inp[k]) for k in names},
            jnp.asarray(inp["x"]))
    (_, (y, l_aux, meta)), (dwg, dex, dx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(*args)
    tokens = jnp.asarray(inp["x"]).reshape(-1, ranks.ROUTE_H)
    gi, _, _ = gate.route(args[0], tokens)
    T = tokens.shape[0]
    return dict(y=np.asarray(y), capacity=gate.capacity(T),
                l_aux=float(l_aux), drop_rate=float(meta["drop_rate"]),
                dwg=np.asarray(dwg), dx=np.asarray(dx),
                dexperts={k: np.asarray(v) for k, v in dex.items()},
                routing={k: np.asarray(getattr(gi, k))
                         for k in ("expert_idx", "slot", "keep")})


def start(world: int, names, ckpt: str = ""):
    """The launch of ``world`` ranks in a thread while this process runs
    JAX's routing and engines for ``names``; ``get()`` waits for it."""
    weights = case_weights(names)
    result = {}

    def run():
        try:
            result["got"] = launch(ranks.seq_rank, world, (weights, ckpt),
                                   timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    for name, (ep, sp, _) in ranks.ROUTE_CASES.items():
        if ep * sp == world:
            jax_route(name)
    for name in names:
        jax_train(name)

    def get():
        thread.join()
        if "error" in result:
            raise result["error"]
        return result["got"]
    return get, thread, weights


def check_route(got, name: str) -> None:
    """Each rank's output chunk, the global routing, ``l_aux`` and the
    gradients against JAX's (the router's and the experts' summed over
    the ranks that share them)."""
    ep, sp, impl = ranks.ROUTE_CASES[name]
    want = jax_route(name)
    m, n = ranks.SEQ // sp, ranks.ROUTE_E // ep
    mine = [g["route"][name] for g in got]
    for g in mine:
        rows = slice(g["expert"] * 2 // ep, (g["expert"] + 1) * 2 // ep)
        cols = slice(g["seq"] * m, (g["seq"] + 1) * m)
        assert g["impl"] == impl and g["capacity"] == want["capacity"]
        np.testing.assert_allclose(g["y"], want["y"][rows, cols], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g["dx"], want["dx"][rows, cols],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["l_aux"], want["l_aux"], rtol=1e-6)
        np.testing.assert_allclose(g["drop_rate"], want["drop_rate"],
                                   rtol=1e-6)
        if impl == "sparse":
            for k, v in want["routing"].items():
                np.testing.assert_array_equal(g["routing"][k], v, err_msg=k)
    assert want["drop_rate"] > 0 and not want["routing"]["keep"].all()
    # the summed gradients: within 1e-5 (a sum over the ranks in another
    # order than JAX's)
    np.testing.assert_allclose(sum(g["dwg"] for g in mine), want["dwg"],
                               rtol=1e-5, atol=1e-5)
    for k in ranks.EXPERT_LEAVES:
        for e in range(ep):
            part = sum(g["dexperts"][k] for g in mine if g["expert"] == e)
            np.testing.assert_allclose(part, want["dexperts"][k][
                e * n:(e + 1) * n], rtol=1e-5, atol=1e-5, err_msg=k)


def joined(got, key: str) -> dict:
    """The whole leaves from the ranks of ``seq`` coordinate 0: an expert
    stack's blocks concatenated over the expert axis (dim 0) and a split
    leaf's over ``tensor``; every leaf equal across ``seq`` and a whole
    leaf on every rank, bit for bit."""
    by = {(g["coords"]["expert"], g["coords"]["seq"],
           g["coords"]["tensor"]): g[key] for g in got}
    ep, sp, tp = (1 + max(c[i] for c in by) for i in range(3))
    out = {}
    for k in by[0, 0, 0]:
        for (e, s, t), v in by.items():
            assert np.array_equal(v[k], by[e, 0, t][k]), (k, e, s, t)
        dim = tp_split_dim(k) if tp > 1 else None
        expert = ep > 1 and is_expert_leaf(k)
        blocks = []
        for e in range(ep if expert else 1):
            parts = [by[e, 0, t][k] for t in range(tp)]
            blocks.append(np.concatenate(parts, dim) if dim is not None
                          else parts[0])
            if dim is None:
                for p in parts[1:]:
                    assert np.array_equal(p, parts[0]), k
        out[k] = np.concatenate(blocks, 0) if expert else blocks[0]
        if not expert and dim is None:
            for v in by.values():
                assert np.array_equal(v[k], out[k]), k
    return out


def assert_masters_close(got, before, want) -> None:
    """Per leaf, the master within ``RTOL`` of JAX's and its update
    within 1e-3 of JAX's, both relative in Frobenius norm: where a
    gradient entry is near 0, Adam's ``m / sqrt(v)`` turns a last-bit
    difference into a visible one (one element of a Mixtral expert stack
    in 90112 ends 8e-4 apart).  A key projection's bias has a zero
    gradient in exact arithmetic (the softmax removes a constant a query
    adds to its scores), so its Adam steps are rounding noise in both
    frameworks, and the loss does not see it: under ``seq`` its entries
    moved up to 2.5e-3 in three steps in both (where a leaf with a real
    gradient moves ~9e-3), past the tenth of ``lr`` a step that
    ``test_torch_tp_train`` holds them to at tp 2; here each is held to
    Adam's own bound, ``lr`` a step."""
    lr = ranks.OPTIMIZER["params"]["lr"]
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.endswith("k_proj.bias"):
            for m in (got[k], w):
                assert np.abs(m - before[k]).max() <= lr * ranks.STEPS, k
            continue
        if np.any(before[k]):  # a leaf born at zero is its update alone
            err = np.linalg.norm(got[k] - w)
            assert err <= RTOL * np.linalg.norm(w), \
                (k, err / np.linalg.norm(w))
        du, dw = got[k] - before[k], w - before[k]
        assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw), \
            (k, np.linalg.norm(du - dw) / np.linalg.norm(dw))


def check_training(got, name: str, weights) -> None:
    """Losses and grad norms against JAX's engine, the masters after the
    steps, every rank of one model reporting the same; the ranks started
    from the reference weights' slices."""
    want, after = jax_train(name)
    g0 = got[0]
    _assert_lr_equal(g0["lr"], want["lr"])
    np.testing.assert_allclose(g0["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(g0["grad_norm"], want["grad_norm"],
                               rtol=RTOL)
    for g in got[1:]:
        assert g["loss"] == g0["loss"] and g["grad_norm"] == g0["grad_norm"]
    start_ = joined(got, "before")
    for k, v in weights.items():
        assert np.array_equal(start_[k], v), k
    port = joined(got, "after")
    assert set(port) == set(after)
    assert_masters_close(port, weights, after)
    if ranks.TRAIN_CASES[name][0] == "mixtral":
        assert all(0 < kept < 1 for kept in g0["kept"]), g0["kept"]


SP2_CASES = [n for n, c in ranks.TRAIN_CASES.items()
             if ranks.world_of(c[1]) == 2]


@pytest.fixture(scope="module")
def launched():
    get, thread, weights = start(2, SP2_CASES)
    yield {"get": get, "weights": weights}
    thread.join()


@pytest.mark.parametrize("name", [n for n, c in ranks.ROUTE_CASES.items()
                                  if c[0] == 1])
def test_routing_over_seq_matches_jax(launched, name):
    check_route(launched["get"](), name)


@pytest.mark.parametrize("name", SP2_CASES)
def test_training_under_seq_matches_jax(launched, name):
    got = [r[name] for r in launched["get"]()]
    assert sorted(g["coords"]["seq"] for g in got) == [0, 1]
    assert all(g["sp"] == 2 for g in got)
    check_training(got, name, launched["weights"][name])


def test_aux_loss_counts_once_under_seq(launched):
    """Mixtral at sp 2 trains with ``aux_loss_coef`` 1, where the layers'
    aux losses add more than 1 to the loss (one process, on the reference
    weights and the first batch): one ``l_aux`` of the global micro-batch
    a ``seq`` rank would put every loss that far above JAX's, which it
    matches within 2e-4 (``test_training_under_seq_matches_jax``)."""
    import deepspeed_tpu_torch as dst
    model = dst.MixtralModel(ranks.model_config("mixtral_sp2"),
                             device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           launched["weights"]["mixtral_sp2"].items()})
    with torch.no_grad():
        _, aux = model.hidden_states(torch.from_numpy(
            ranks.batches("mixtral_sp2")[0]["input_ids"]))
    assert model.config.aux_loss_coef * float(aux) > 1.0
    got = launched["get"]()[0]["mixtral_sp2"]["loss"][0]
    np.testing.assert_allclose(got, jax_train("mixtral_sp2")[0]["loss"][0],
                               rtol=RTOL)


@pytest.mark.parametrize("what, item", [
    ("bert_tp_sp", "7c"), ("opt_tp_sp", "7c"), ("mixtral_tp_sp", "7c"),
    ("mixtral_ep_tp_sp", "7c"), ("mixtral_infinity_sp", "9c"),
    ("resnet_sp", "7d")])
def test_unported_seq_compositions_are_refused(launched, what, item):
    for r in launched["get"]():
        msg = r["refusals"][what]
        assert "is not ported yet (ROADMAP Queue 1 item " + item in msg, msg
