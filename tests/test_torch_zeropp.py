"""ZeRO++ of the port (qwZ, qgZ, hpZ) against the JAX package's.

``initialize`` on 2 and 4 gloo ranks on the CPU (``launcher.local.launch``,
rank bodies in ``torch_zeropp_ranks``, no JAX there) trains the tiny
Llama of ``torch_zero_ranks.MODEL`` (fp32 masters, the JAX model's
weights); the JAX engine runs the same config on a data mesh of as many
of the 8 virtual CPU devices (hpZ: ``ep 2 x dp 2``).  One launch a rank
count runs every body; the four-rank one first (it writes hpZ's
checkpoint, which the two-rank one loads).

* the quantizers equal JAX's (``jit``, as its engine runs them) bit for
  bit: a last dim of 256 groups and one of row groups, an all-zero group,
  values on rounding ties; qwZ's gradient is straight-through;
* ``quantized_allreduce`` and ``quantized_reduce_scatter`` on 2 and 4
  ranks equal JAX's under ``shard_map`` on the same per-worker arrays
  (JAX's shapes ``[W, 31, 9]`` and ``[W, 64, 24]``, a padded one, one
  with an Inf);
* the weights the model computes with under qwZ equal JAX's
  ``qwz_compress_tree(cast_tree(params))`` bit for bit at stages 0, 2 and
  3, fp32 and bf16, at a threshold of 200 (JAX counts its stacked norms:
  256 elements), with the groups that a rank's chunk cuts (``gate_proj``'s
  352-row groups at dp 2, ``lm_head``'s 256 at dp 4);
* five steps of each engine case within the bounds below of JAX's ZeRO++
  engine: qwZ and hpZ 1e-5 (``test_torch_zero``'s), qgZ ``QGZ_RTOL``; hpZ
  within 1e-6 of the port's plain stage 3 on the same ranks and mesh;
* the bytes of a step's collectives by verb and dtype equal the count
  from the shapes: the cut leaves' gathers and qgZ's exchanges move int8;
* hpZ's placement (JAX ``test_hpz_secondary_partition``: masters over
  ``data``, optimizer state over the whole data-parallel group) and its
  ``ValueError``; the checkpoint resumes bit for bit and reshards into
  plain stage 3 on 4 and 2 ranks;
* JAX's refusals in its words, and the port's by their ROADMAP items;
* fp16 under qgZ: an overflow that forms on one rank skips the port's
  step, where JAX's two-hop wire zeroes the group that holds it and steps
  on (a reference-side note, ROADMAP Queue 3).
"""

import functools
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import torch_zeropp_ranks as ranks
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.precision import cast_tree
from deepspeed_tpu.runtime.zero import qgz as jqgz
from deepspeed_tpu.runtime.zero import qwz as jqwz
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import (llama_params_from_jax,
                                        llama_tree_to_jax_layout)
from deepspeed_tpu_torch.runtime import checkpointing
from deepspeed_tpu_torch.runtime.zero import qgz, qwz
from test_torch_train import (_assert_lr_equal, _assert_updates_close,
                              _jax_batch, _run)
from torch_parity import free_jax_cycles  # noqa: F401
from torch_zero_ranks import MODEL, THRESHOLD

P = jax.sharding.PartitionSpec
TIMEOUT = 300
#: qgZ's losses and grad norms against JAX's, a tenth of JAX's own
#: ZeRO++-vs-exact 5e-2 (``test_zeropp.py:77``).  The first step's loss
#: is JAX's; from the second on the two engines' fp32 gradients, equal to
#: ~1e-7, quantize to codes that differ where a gradient sits within that
#: of a rounding tie (a step of amax/127 in that element, which Adam's
#: ``m / sqrt(v)`` turns into a step of ``lr``).  Readings over five
#: steps: losses within 9.6e-4, grad norms within 3.4e-3.
QGZ_RTOL = 5e-3
#: qwZ's bound where the weights a step reads quantize to JAX's codes;
#: Adam moves the masters of near-zero gradients apart by up to 8e-4 of a
#: leaf's largest weight in one step (without qwZ too: ``test_torch_train.
#: _assert_updates_close``), and once such a weight leads its group or
#: crosses a tie, codes differ: 0, 0, 1, 38 and 178 of 499,712 before the
#: five steps; the losses then stay within ``QGZ_RTOL``
QWZ_RTOL = 1e-5
JNP = {"float32": jnp.float32, "float16": jnp.float16,
       "bfloat16": jnp.bfloat16}


def _jax_model(dtype=jnp.float32):
    return JaxLlamaModel(JaxLlamaConfig.tiny(dtype=dtype, num_layers=2))


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(_jax_model().init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def weights(jax_params):
    host = jax.tree.map(np.asarray, jax_params)
    return {k: v.numpy() for k, v in llama_params_from_jax(host).items()}


def _arrays(world):
    rng = np.random.RandomState(world)
    inf = rng.randn(world, 600).astype(np.float32)
    inf[world - 1, 5] = np.inf
    return {"allreduce": rng.randn(world, 31, 9).astype(np.float32),
            "allreduce_inf": inf,
            "reduce_scatter": rng.randn(world, 64, 24).astype(np.float32),
            "reduce_scatter_pad": rng.randn(world, 8, 40)
            .astype(np.float32) * 1e-3}


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """rank count -> every rank's results.  Two threads launch the four
    and the two ranks side by side (the two-rank bodies load the
    checkpoint the four-rank ones save, once it is there); the JAX side
    meanwhile, into the caches the tests read."""
    root = tmp_path_factory.mktemp("zeropp")
    save, resave = str(root / "hpz"), str(root / "resaved")
    result = {}

    def run(world):
        try:
            result[world] = launch(ranks.zeropp_rank, world,
                                   (weights, _arrays(world), save, resave),
                                   timeout=TIMEOUT)
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    threads = [threading.Thread(target=run, args=(w,), daemon=True)
               for w in (4, 2)]
    for t in threads:
        t.start()
    for name in ENGINE_CASES:
        _jax_run(name)
    for dtype in ("float32", "bfloat16"):
        _jax_compute_weights(dtype)

    def get(world):
        for t in threads:
            t.join()
        if "error" in result:
            raise result["error"]
        return result[world]
    get.save, get.resave = save, resave
    yield get
    for t in threads:
        t.join()


def _mesh(world, ep=1):
    layout = MeshLayout.infer(world, ep=ep, dp=world // ep)
    return groups.initialize_mesh(mesh=build_mesh(
        layout, devices=jax.devices()[:world]))


# -- the functions ------------------------------------------------------------

def _quant_inputs():
    rng = np.random.RandomState(3)
    ties = np.zeros((4, 256), np.float32)
    ties[:, 0] = 127.0                  # scale 127 * float32(1/127)
    ties[:, 1:] = (np.arange(255) % 40 - 20 + 0.5).astype(np.float32)
    zeros = rng.randn(3, 512).astype(np.float32)
    zeros[1, 256:] = 0.0                # one all-zero group
    return {"groups_256": rng.randn(6, 768).astype(np.float32) * 3.0,
            "row_groups": rng.randn(5, 2, 352).astype(np.float32),
            "all_zero_group": zeros, "ties": ties,
            "ties_rows": ties[:, :200] * np.float32(0.37)}


@pytest.mark.parametrize("case", sorted(_quant_inputs()))
def test_quantizers_bit_equal_jax(case):
    """``_quant`` / ``_dequant`` (qwZ) and ``_quant_groups`` (qgZ) equal
    JAX's compiled functions on the same inputs, codes and scales bit for
    bit (ties included: the scale is XLA's ``amax * float32(1/127)``)."""
    x = _quant_inputs()[case]
    jq, js = jax.jit(jqwz._quant)(jnp.asarray(x))
    q, s = qwz._quant(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = jax.jit(functools.partial(jqwz._dequant, shape=x.shape))(jq, js)
    np.testing.assert_array_equal(qwz._dequant(q, s, x.shape).numpy(),
                                  np.asarray(back))
    if x.size % qgz.GROUP == 0:
        jq, js = jax.jit(jqgz._quant_groups)(jnp.asarray(x.reshape(-1)))
        q, s = qgz._quant_groups(torch.from_numpy(x.reshape(-1)))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if case == "ties":  # the ties sit where the two rounding rules differ
        assert np.any(np.abs(np.round(x / s[:, None].numpy())
                             - np.floor(x / s[:, None].numpy() + 0.5)) > 0)


def test_qwz_straight_through_gradient():
    """JAX ``test_qwz_straight_through_gradient``: the gradient of
    ``sum(qwz(x)^2)`` is ``2 qwz(x)``, passed through unchanged."""
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 256)
                         .astype(np.float32)).requires_grad_()
    compress = qwz.make_qwz()
    (compress(x) ** 2).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(),
                                  2 * compress(x).detach().numpy())
    mesh = _mesh(8)
    jfn = jqwz.make_qwz(mesh)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jfn(p) ** 2)))(jnp.asarray(
        x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


def test_wire_bytes_equal_jax():
    params = {"w": np.zeros((1024, 512)), "b": np.zeros((300,))}
    assert qgz.wire_bytes(params) == jqgz.wire_bytes(params)
    assert qgz.wire_bytes(list(params.values())) == \
        jqgz.wire_bytes(params)


@pytest.mark.parametrize("world", [2, 4])
def test_qgz_functions_match_jax(port_runs, world):
    """Each rank's ``quantized_allreduce`` / ``quantized_reduce_scatter``
    equals JAX's under ``shard_map`` on the same per-worker arrays, codes
    and scales alike: XLA's CPU code contracts the dequantized sum into
    fused multiply-adds (``fma(q1, s1, q0 * s0)``: checked against
    numpy), the port rounds each product, so an output may differ by the
    rounding of a partial sum, at most ``world`` ulps of ``world x
    max|g|``; a code taken differently (a step of ``amax/127``) would show
    far above that, and none is (the one-rank Inf too: both zero its
    group)."""
    got = [r["functions"] for r in port_runs(world)]
    mesh = _mesh(world)
    for key, a in _arrays(world).items():
        if key.startswith("allreduce"):
            def f(x):
                return jqgz.quantized_allreduce(x[0], ("data",))[None]
        else:
            def f(x):
                return jqgz.quantized_reduce_scatter(x[0], ("data",),
                                                     0)[None]
        want = np.asarray(jax.jit(shard_map(
            f, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
            check_vma=False))(jnp.asarray(a)))
        atol = world * np.spacing(np.float32(world * np.abs(
            a[np.isfinite(a)]).max()))
        for r, g in enumerate(got):
            np.testing.assert_allclose(g[key], want[r], rtol=0, atol=atol,
                                       err_msg=key)
            if key in g["tree"]:  # qgz_reduce_tree: each leaf's two hops
                np.testing.assert_array_equal(g["tree"][key], g[key])
        if key == "allreduce_inf":
            assert np.isfinite(want).all()
            assert (want[0, :256] == 0).all()


# -- the compute weights ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_compute_weights(dtype):
    params = _jax_model().init_params(jax.random.PRNGKey(0))
    mesh = _mesh(1)
    fn = jax.jit(lambda p: jqwz.qwz_compress_tree(
        cast_tree(p, JNP[dtype]), mesh, threshold=ranks.QWZ_THRESHOLD))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(fn(params)))
    return {k: v.numpy() for k, v in llama_params_from_jax(tree).items()}


@pytest.mark.parametrize("stage,dtype", [(0, "float32"), (2, "float32"),
                                         (3, "float32"), (3, "bfloat16")])
@pytest.mark.parametrize("world", [2, 4])
def test_qwz_compute_weights_bit_equal_jax(port_runs, world, stage, dtype):
    """Every weight the model reads under qwZ, on every rank, equals JAX's
    compressed tree bit for bit; at stage 3 the cut leaves arrive as int8
    over the wire, the groups a chunk cuts through a max all-reduce of
    their amax."""
    want = _jax_compute_weights(dtype)
    for r, res in enumerate(port_runs(world)):
        got = res["weights"][f"stage{stage}_{dtype}"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {r} {k}")
    quantized = port_runs(world)[0]["weights"]["quantized"]
    # every leaf but the final norm (128 elements; JAX's stacked norms 256)
    assert quantized == sorted(k for k in want if k != "final_norm")


# -- the engines --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(params before, the step metrics, params after) of JAX's engine;
    under qwZ the metrics' ``masters``: the parameters before each step
    (the port's layout)."""
    world = ranks.CASES[name][0]
    dtype = "float16" if "fp16" in name else "float32"
    jm = _jax_model(JNP[dtype])
    params = jm.init_params(jax.random.PRNGKey(0))
    if "overflow" in name:
        params = dict(params, final_norm=params["final_norm"]
                      * ranks.OVERFLOW_NORM)
    before = jax.device_get(params)
    config = dict(ranks.case_config(name))
    ep = (config.pop("moe", None) or {}).get("expert_parallel_size", 1)
    mesh = _mesh(world, ep)
    engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                 config=config, mesh=mesh)
    # the 0-d state leaves start with no sharding and leave the first step
    # replicated over the mesh, which retraces the step: give them that
    # placement now (the same values), so the engine compiles once
    rep = jax.sharding.NamedSharding(mesh, P())
    engine.state = jax.tree.map(
        lambda x: jax.device_put(x, rep) if np.ndim(x) == 0 else x,
        engine.state)
    batches = ranks.global_batches(name, world)
    if not config["zero_optimization"].get("zero_quantized_weights"):
        want = _run(engine, batches, _jax_batch)
        return before, want, jax.device_get(engine.state.params)
    want = {"masters": []}
    for b in batches:
        tree = jax.tree.map(np.asarray, jax.device_get(engine.state.params))
        want["masters"].append({k: v.numpy() for k, v in
                                llama_params_from_jax(tree).items()})
        for k, v in _run(engine, [b], _jax_batch).items():
            want.setdefault(k, []).extend(v)
    return before, want, jax.device_get(engine.state.params)


def _code_flips(got, want):
    """Per leaf, the int8 codes of the port's masters that differ from
    those of JAX's (both through the quantizer, bit-equal to JAX's)."""
    from deepspeed_tpu_torch import LlamaConfig, LlamaModel

    model = LlamaModel(LlamaConfig(dtype=torch.float32, **MODEL),
                       device="cpu")
    flips = 0
    for k, v in want.items():
        axis = qwz.qwz_axis(*model.qwz_view(k), THRESHOLD)
        if axis is None:
            continue
        codes = [qwz.quant_runs(torch.from_numpy(t).movedim(axis.dim, -1),
                                axis.run)[0] for t in (got[k], v)]
        flips += int((codes[0] != codes[1]).sum())
    return flips


def _port_params(got):
    return llama_tree_to_jax_layout(
        {k: torch.from_numpy(v) for k, v in got["params"].items()}, 8, 4)


ENGINE_CASES = [n for n in ranks.CASES if "overflow" not in n
                and "ep2" not in n and n != "stage3_hpz_qwz_qgz"]


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_cases_match_jax(port_runs, name):
    world = ranks.CASES[name][0]
    got_ranks = [r[name] for r in port_runs(world)]
    got = got_ranks[0]
    before, want, after = _jax_run(name)
    _assert_lr_equal(got["lr"], want["lr"])
    assert got["skipped"] == want["skipped"] == [0] * ranks.STEPS
    assert got["loss"][0] == pytest.approx(want["loss"][0], rel=1e-6)
    quantized = "qgz" in name or "qwz" in name
    tol = QGZ_RTOL if quantized else 1e-5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=tol, atol=1e-6)
    if "qwz" in name and "qgz" not in name:
        flips = [_code_flips(g, w) for g, w in zip(got["masters"],
                                                   want["masters"])]
        print(f"{name}: codes that differ from JAX's before each step "
              f"{flips}")
        same = [k for k, f in enumerate(flips) if f == 0]
        assert same[:2] == [0, 1]
        np.testing.assert_allclose([got["loss"][k] for k in same],
                                   [want["loss"][k] for k in same],
                                   rtol=QWZ_RTOL)
    if not quantized:  # Adam spreads the code differences over a leaf
        _assert_updates_close(before, _port_params(got), after)
    assert got["loss"][-1] < got["loss"][0]
    for other in got_ranks[1:]:  # one model: every rank the same
        assert other["loss"] == got["loss"]
        assert other["grad_norm"] == got["grad_norm"]
        for k, v in got["params"].items():
            assert np.array_equal(v, other["params"][k]), k


@pytest.mark.parametrize("hpz,plain", [
    ("stage3_hpz", "stage3_ep2"),
    ("stage3_hpz_qwz_qgz", "stage3_ep2_qwz_qgz")])
def test_hpz_equals_stage3_on_the_same_ranks(port_runs, hpz, plain):
    """hpZ changes no number (``ZERO_STAGE_RTOL`` of ``chip_smoke.py``,
    1e-6), alone and with qwZ and qgZ (their groups and chunks are the
    same whoever holds them), and every rank ends with the same
    parameters."""
    for r in port_runs(4):
        for what in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[hpz][what], r[plain][what],
                                       rtol=1e-6)
        for k, v in port_runs(4)[0][hpz]["params"].items():
            assert np.array_equal(r[hpz]["params"][k], v), k
    assert port_runs(4)[0][hpz]["loss"][-1] < port_runs(4)[0][hpz]["loss"][0]


def test_qgz_fp16_overflow_skips_where_jax_steps_on(port_runs):
    """fp16 under qgZ, rank 1's lm_head gradient Inf at the first two loss
    scales (the ``stage2_fp16_overflow`` pattern of ``test_torch_zero``):
    the port sees it before the int8 wire and skips twice, halving, in
    lockstep, as it does without qgZ.  JAX's two-hop wire turns the group
    that holds it into zeros (scale Inf, codes NaN → 0, then a NaN amax →
    scale 1: ``test_qgz_functions_match_jax``'s ``allreduce_inf``) and its
    engine steps on with no overflow (a JAX engine at this case reports
    none skipped and grows its scale to 2^17 over the five steps): the
    reference-side note of ROADMAP Queue 3."""
    got = [r["stage2_qgz_fp16_overflow"] for r in port_runs(2)]
    assert got[0]["skipped"] == [1, 2, 2, 2, 2]
    assert got[0]["loss_scale"] == [2.0 ** 15, 2.0 ** 14, 2.0 ** 13,
                                    2.0 ** 13, 2.0 ** 14]
    assert got[1]["skipped"] == got[0]["skipped"]
    assert got[1]["loss_scale"] == got[0]["loss_scale"]
    assert np.all(np.isfinite(got[0]["loss"]))


# -- the wire -----------------------------------------------------------------

def _leaves(world):
    """Per port leaf: (name, elements, reads a step, cut dim or None,
    qwZ (dim, run) or None) of the tiny model at ``THRESHOLD`` (under
    remat a layer's weights are read twice: the forward and the
    recompute)."""
    from deepspeed_tpu_torch import LlamaConfig, LlamaModel
    from deepspeed_tpu_torch.runtime.zero import dp_shardable_dim

    model = LlamaModel(LlamaConfig(dtype=torch.float32, **MODEL),
                       device="cpu")
    out = []
    for name, p in model.named_parameters():
        dim, last, jax_numel = model.qwz_view(name)
        cut = (dp_shardable_dim(tuple(p.shape), world)
               if p.numel() > THRESHOLD else None)
        axis = (dim, qwz.group_run(last)) if jax_numel > THRESHOLD else None
        out.append((name, p.numel(), 2 if name.startswith("layers.") else 1,
                    cut, axis, tuple(p.shape)))
    return out


def _expected_wire(name, world):
    """Bytes by ``verb/dtype`` of the last step, from the shapes alone
    (hpZ: masters cut over ``data`` = 2 ranks, the updated pieces
    gathered into them)."""
    _, stage, extra, top = ranks.CASES[name]
    data = 2 if extra.get("zero_hpz_partition_size") else world
    q_w = extra.get("zero_quantized_weights", False)
    q_g = extra.get("zero_quantized_gradients", False)
    gas = top.get("gradient_accumulation_steps", 1)  # reads a microbatch
    want = {}

    def add(key, n):
        want[key] = want.get(key, 0) + int(n)

    def two_hop(n):  # quantized_allreduce of n elements
        n_pad = -(-n // (world * 256)) * world * 256
        add("all_to_all/int8", n_pad)
        add("all_to_all/float32", n_pad // 256 * 4)
        add("all_gather/int8", n_pad)
        add("all_gather/float32", n_pad // 256 * 4)

    for leaf, n, reads, cut, axis, shape in _leaves(world):
        reads *= gas
        if stage < 3 or cut is None:
            if q_g:
                two_hop(n)
            elif stage == 2 and cut is not None:
                add("reduce_scatter/float32", n * 4)
            else:
                add("all_reduce/float32", n * 4 * 2)
            continue
        if q_w and axis is not None:
            dim, run = axis
            add("all_gather/int8", n * reads)
            straddle = cut == dim and (shape[cut] // data) % run
            add("all_reduce/float32" if straddle else "all_gather/float32",
                n // run * 4 * (2 if straddle else 1) * reads)
        else:
            add("all_gather/float32", n * 4 * reads)
        if q_g:
            per = n // world
            per_pad = -(-per // 256) * 256
            add("all_to_all/int8", world * per_pad)
            add("all_to_all/float32", world * per_pad // 256 * 4)
        else:
            add("reduce_scatter/float32", n * 4)
        if data < world:
            add("all_gather/float32", n * 4 // data)
    if stage == 2:  # the updated chunks' all-gather into the masters
        add("all_gather/float32", sum(
            n * 4 for _, n, _, cut, _, _ in _leaves(world)
            if cut is not None))
    add("all_reduce/float32", 8)  # the loss
    if stage >= 2:  # the norm's partial Σg²: the gradients are cut
        add("all_reduce/float32", 8)
    return want


@pytest.mark.parametrize("name", ["stage3_qwz", "stage2_qgz", "stage3_qgz",
                                  "stage3_qgz_gas2",
                                  "stage3_qwz_qgz_fused_adam_clip",
                                  "stage3_hpz", "stage3_hpz_qwz_qgz"])
def test_wire_bytes_a_step_from_the_shapes(port_runs, name):
    """The last step's bytes by verb and dtype on each rank equal the
    count from the shapes: qwZ gathers a cut leaf as int8 codes and fp32
    scales (1 + 4/256 bytes an element, fp32's 4 here), qgZ moves
    int8 and fp32 scales over its all-to-alls and all-gathers, and
    nothing of fp32 crosses for the gradients of qgZ's leaves."""
    world = ranks.CASES[name][0]
    want = _expected_wire(name, world)
    for r, res in enumerate(port_runs(world)):
        assert res[name]["wire"] == want, (r, res[name]["wire"], want)
    if "qwz" in name:
        assert want["all_gather/int8"] > 0
    if "qgz" in name:
        assert "reduce_scatter/float32" not in want
        assert want["all_to_all/int8"] > 0


# -- hpZ ----------------------------------------------------------------------

def test_hpz_secondary_partition(port_runs):
    """JAX ``test_hpz_secondary_partition``: each cut master is a 1/2
    chunk over the ``data`` axis alone, its m and v 1/4 over the whole
    data-parallel group; ``zero_hpz_partition_size=3`` (not the ``data``
    axis) raises JAX's ``ValueError``."""
    res = port_runs(4)
    for r in res:
        got = r["stage3_hpz"]
        big = [k for k, v in got["params"].items() if v.size >= 4096]
        assert big
        for k in big:
            whole = got["params"][k].size
            assert got["master_group"][k] == 2, k
            assert got["master_numel"][k] == whole // 2, k
            assert got["state_numel"][k] == whole // 4, k
        plain = r["stage3_ep2"]
        for k in big:
            assert plain["master_numel"][k] == got["params"][k].size // 4
        assert "must equal the inner 'data' mesh axis size (2)" in \
            r["ckpt"]["hpz3"]


def test_hpz_checkpoint_resumes_and_reshards(port_runs):
    """hpZ's save resumes bit for bit in a fresh hpZ engine, loads into
    plain stage 3 on the same four ranks (the same losses, 1e-6) and on
    two (its rank files hold the same masters and moments)."""
    four = port_runs(4)
    for r in four:
        c = r["ckpt"]
        assert c["hpz_resumed"] == c["continued"]
        np.testing.assert_allclose(c["plain_resumed"], c["continued"],
                                   rtol=1e-6)
        for k, v in four[0]["ckpt"]["saved"].items():
            assert np.array_equal(c["hpz_loaded"][k], v), k
            assert np.array_equal(c["plain_loaded"][k], v), k
    two = port_runs(2)
    for r in two:
        for k, v in four[0]["ckpt"]["saved"].items():
            assert np.array_equal(r["reshard"]["loaded"][k], v), k
        assert r["reshard"]["count"] == ranks.CKPT_STEPS[0]
    tag = f"{port_runs.save}/{four[0]['ckpt']['tag']}"
    for key in ("master", "m", "v"):
        saved = dict(checkpointing.full_tensors(tag, key))
        again = dict(checkpointing.full_tensors(
            f"{port_runs.resave}/resaved", key))
        assert sorted(saved) == sorted(again)
        for k in saved:
            assert torch.equal(saved[k], again[k]), (key, k)


# -- refusals -----------------------------------------------------------------

def test_refusals():
    """JAX's refusals in its words (qwZ and qgZ with offload or Infinity),
    and the port's named ones: ZeRO++ under a tensor or ``seq`` axis or on
    another model (item 4c), the ring overlap (4b), MiCS (10)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    def model(cls="llama"):
        if cls == "mixtral":
            return dst.MixtralModel(dst.MixtralConfig.tiny(
                num_layers=1, dtype=torch.float32,
                param_dtype=torch.float32), device="cpu")
        if cls == "bert":
            return dst.BertModel(dst.BertConfig.tiny(dtype=torch.float32),
                                 device="cpu")
        return dst.LlamaModel(dst.LlamaConfig(
            dtype=torch.float32, param_dtype=torch.float32, **MODEL),
            device="cpu")

    def config(zero, **top):
        return {"train_micro_batch_size_per_gpu": 1, **top,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "zero_optimization": zero}

    qw, qg = {"zero_quantized_weights": True}, \
        {"zero_quantized_gradients": True}
    offload = {"offload_optimizer": {"device": "cpu"}}
    infinity = {"offload_param": {"device": "cpu"}}
    for zero, err, words in (
            ({"stage": 2, **qw, **offload}, NotImplementedError,
             "zero_quantized_weights + offload/infinity not supported"),
            ({"stage": 3, **qw, **infinity}, NotImplementedError,
             "zero_quantized_weights + offload/infinity not supported"),
            ({"stage": 1, **qg, **offload}, NotImplementedError,
             "zero_quantized_gradients + offload not supported yet"),
            ({"stage": 3, **qg, **infinity}, NotImplementedError,
             "zero_quantized_gradients + offload not supported yet"),
            ({"stage": 3, "zero_hpz_partition_size": 2, **offload},
             NotImplementedError, "(ROADMAP Queue 1 item 4c)")):
        with pytest.raises(err, match=re.escape(words)):
            dst.initialize(model=model(), config=config(zero), device="cpu")
    for zero, top, cls in (
            (qw, {"tensor_parallel": {"autotp_size": 2}}, "llama"),
            (qg, {"sequence_parallel": {"sp_size": 2}}, "llama"),
            ({"zero_hpz_partition_size": 2, "stage": 3}, {}, "mixtral"),
            (qg, {}, "bert"), (qw, {}, "mixtral")):
        with pytest.raises(NotImplementedError,
                           match=r"not ported yet \(ROADMAP Queue 1 item "
                                 r"4c"):
            dst.initialize(model=model(cls), config=config(
                {"stage": 1, **zero}, **top), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 4b\)"):
        DeepSpeedConfig.from_dict({"kernels": {"overlap_collectives": True}})
    with pytest.raises(NotImplementedError, match=r"item 10\)"):
        DeepSpeedConfig.from_dict({"zero_optimization": {
            "mics_shard_size": 2}})
    z = DeepSpeedConfig.from_dict({"zero_optimization": {
        "stage": 3, **qw, **qg, "zero_quantized_nontrainable_weights": True,
        "zero_hpz_partition_size": 2}}).zero_optimization
    assert (z.zero_quantized_weights, z.zero_quantized_gradients,
            z.zero_quantized_nontrainable_weights,
            z.zero_hpz_partition_size) == (True, True, True, 2)
