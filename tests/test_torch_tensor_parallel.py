"""Tensor-parallel serving of the port (Llama and OPT) against the JAX
package.

The mesh arithmetic and the weight split are held against the JAX
package's ``MeshLayout``, ``ProcessTopology`` and ``param_specs``; the
head-sharded paged decode against JAX's ``paged_decode_attention_tp`` on a
2-way ``tensor`` mesh of the test CPU devices.  The slice runs in two
ranks over gloo on the CPU (``launcher.local.launch``, one spawn a test,
each with a timeout, rank bodies in ``torch_tp_ranks``): the v2 engine at
``tp=2`` must give exactly the greedy tokens of JAX's meshless engine
(the JAX package's own TP test holds its TP engine to the same), with the
first logits within 1e-4, and v1 ``init_inference(tensor_parallel=...)``
JAX v1's tokens; the front-end the ``tp=1`` front-end's tokens; and the
communication verbs numpy's results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference.v2 import KVCacheConfig as JaxKVCacheConfig
from deepspeed_tpu.inference.v2 import build_engine_v2 as jax_build_engine_v2
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_decode_attention_tp as jax_paged_decode_attention_tp
from deepspeed_tpu.parallel.mesh import MeshLayout as JaxMeshLayout
from deepspeed_tpu.parallel.mesh import ProcessTopology as JaxTopology
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize as dst_initialize
from deepspeed_tpu_torch import (DeepSpeedConfig, KVCacheConfig,
                                 LlamaConfig, LlamaModel, MixtralConfig,
                                 MixtralModel, OPTModel, build_engine_v2,
                                 build_serving_frontend, init_distributed,
                                 init_inference)
from deepspeed_tpu_torch.launcher import launch, rank_env
from deepspeed_tpu.models import OPTConfig as JaxOPTConfig
from deepspeed_tpu.models import OPTModel as JaxOPTModel
from deepspeed_tpu_torch.models import (OPTConfig, llama_params_from_jax,
                                        opt_params_from_jax,
                                        shard_llama_params, shard_opt_params)
from deepspeed_tpu_torch.ops.kernels import (paged_decode_attention,
                                             paged_decode_attention_tp)
from deepspeed_tpu_torch.parallel import (MESH_AXIS_ORDER, MeshLayout,
                                          ProcessMesh, ProcessTopology)
from torch_parity import jax_tiny, port_config
from torch_parity import free_jax_cycles  # noqa: F401

#: every launch's limit: a rank that hangs fails the test, not the suite
TIMEOUT = 120
#: the JAX TP test's model, cache and engine (test_v2.py:362-376)
CACHE = dict(num_blocks=64, block_size=4, max_seq_len=64)
ENGINE = dict(max_batch_slots=2, prefill_chunk=8, decode_burst=4)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its params, the port's config kwargs, the weights as
    numpy): 2 layers, 8 query and 4 kv heads, fp32."""
    jm, params = jax_tiny(num_layers=2, max_seq_len=64, num_heads=8,
                          num_kv_heads=4)
    host = jax.tree.map(np.asarray, jax.device_get(params))
    weights = {k: v.numpy() for k, v in llama_params_from_jax(host).items()}
    cfg = port_config(jm.config)
    cfg_kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    return jm, params, cfg_kw, weights


@pytest.fixture(scope="module")
def opt_tiny():
    """(JAX OPT, its params with random biases, the port's config kwargs,
    the weights as numpy): 2 layers, 8 heads, fp32."""
    jm = JaxOPTModel(JaxOPTConfig.tiny(dtype=jnp.float32, num_layers=2))
    host = jax.tree.map(np.asarray, jax.device_get(
        jm.init_params(jax.random.PRNGKey(2))))
    rng = np.random.RandomState(9)
    for k in ("bq", "bk", "bv", "bo"):
        host["layers"]["attn"][k] = (rng.randn(*host["layers"]["attn"][k]
                                               .shape) * 0.1).astype(
                                                   np.float32)
    for k in ("b_in", "b_out"):
        host["layers"]["mlp"][k] = (rng.randn(*host["layers"]["mlp"][k]
                                              .shape) * 0.1).astype(
                                                  np.float32)
    weights = {k: v.numpy() for k, v in opt_params_from_jax(host).items()}
    kw = dict(vocab_size=512, hidden_size=128, ffn_dim=256, num_layers=2,
              num_heads=8, max_seq_len=128, dtype=torch.float32)
    return jm, host, kw, weights


def _mesh(tp, rank):
    """A process mesh without groups: enough for what runs in one
    process (construction, the head split)."""
    return ProcessMesh(MeshLayout(tp=tp), rank=rank)


# -- mesh and groups ------------------------------------------------------

LAYOUTS = [(8, dict(tp=2)), (8, dict(tp=2, sp=2)), (8, dict(tp=4, pp=2)),
           (4, dict(tp=4))]


@pytest.mark.parametrize("world,kw", LAYOUTS, ids=[str(k) for _, k in LAYOUTS])
def test_layout_and_comm_lists_equal_jax(world, kw):
    got, want = MeshLayout.infer(world, **kw), JaxMeshLayout.infer(world, **kw)
    assert got.axis_sizes == want.axis_sizes
    assert got.dp_world_size == want.dp_world_size
    mine = ProcessTopology.from_layout(got)
    ref = JaxTopology.from_layout(want)
    for axis in MESH_AXIS_ORDER:
        assert mine.get_axis_comm_lists(axis) == \
            ref.get_axis_comm_lists(axis), axis
    for rank in range(world):
        assert mine.get_coord(rank) == ref.get_coord(rank)
        assert mine.get_rank(**mine.get_coord(rank)) == rank


def test_layout_infer_reads_the_torch_world():
    assert MeshLayout.infer().world_size == 1  # no process group: one rank
    with pytest.raises(ValueError, match="not divisible"):
        MeshLayout.infer(6, tp=4)
    assert rank_env(1, 2, "127.0.0.1", 1234)["LOCAL_RANK"] == "1"


# -- the weight split -------------------------------------------------------

def _jax_shard(params, specs, tp, rank):
    """Rank ``rank``'s block of every leaf along the axis its JAX
    ``param_specs`` entry names ``tensor``."""
    if isinstance(params, dict):
        return {k: _jax_shard(params[k], specs[k], tp, rank) for k in params}
    a = np.asarray(params)
    if "tensor" not in tuple(specs):
        return a
    axis = tuple(specs).index("tensor")
    n = a.shape[axis] // tp
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)


def test_shards_follow_the_jax_param_specs(tiny):
    """``shard_llama_params`` of the carried-across weights equals the
    carry-across of JAX's own shard (``param_specs``), leaf for leaf, and
    the shards concatenate back to the whole."""
    jm, params, _, weights = tiny
    host = jax.tree.map(np.asarray, jax.device_get(params))
    whole = llama_params_from_jax(host)
    specs = jm.param_specs()
    shards = [shard_llama_params(whole, 2, r) for r in range(2)]
    for r in range(2):
        want = llama_params_from_jax(_jax_shard(host, specs, 2, r))
        assert set(want) == set(shards[r])
        for k in want:
            assert torch.equal(shards[r][k], want[k]), (r, k)
    for k, w in whole.items():
        if shards[0][k].shape == w.shape:
            assert torch.equal(shards[0][k], w) and torch.equal(
                shards[1][k], w)
        else:
            dim = [a != b for a, b in zip(shards[0][k].shape,
                                          w.shape)].index(True)
            assert torch.equal(torch.cat([s[k] for s in shards], dim), w)


def test_opt_shards_follow_the_jax_param_specs(opt_tiny):
    """``shard_opt_params`` equals the carry-across of JAX's own OPT shard
    (``param_specs`` :123-143: q/k/v/fc1 and their biases by output rows,
    out_proj/fc2 by input columns, their biases and the tied embedding
    whole), and a model built on a tensor mesh holds that slice of the
    seed's whole model."""
    jm, host, kw, _ = opt_tiny
    whole = opt_params_from_jax(host)
    specs = jm.param_specs()
    for r in range(2):
        want = opt_params_from_jax(_jax_shard(host, specs, 2, r))
        got = shard_opt_params(whole, 2, r)
        assert set(want) == set(got)
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)
        assert got["layers.0.o_proj.bias"].shape == (128,)
        assert got["layers.0.q_proj.bias"].shape == (64,)
        part = OPTModel(OPTConfig(**kw), device="cpu", seed=4,
                        mesh=_mesh(2, r))
        seeded = shard_opt_params(OPTModel(OPTConfig(**kw), device="cpu",
                                           seed=4).state_dict(), 2, r)
        for k, v in part.state_dict().items():
            assert torch.equal(v, seeded[k]), k
        assert part.num_local_heads == 4


def test_seeded_shards_are_slices_of_the_whole_model():
    cfg = LlamaConfig.tiny(num_layers=2, dtype=torch.float32)
    whole = LlamaModel(cfg, device="cpu", seed=5).state_dict()
    for r in range(2):
        part = LlamaModel(cfg, device="cpu", seed=5, mesh=_mesh(2, r))
        assert (part.num_local_heads, part.num_local_kv_heads) == (4, 2)
        got = part.state_dict()
        want = shard_llama_params(whole, 2, r)
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k


def test_what_tensor_parallelism_refuses():
    cfg = LlamaConfig.tiny(num_layers=1, dtype=torch.float32)
    with pytest.raises(ValueError, match="must divide the kv heads"):
        LlamaModel(cfg, device="cpu", mesh=_mesh(8, 0))
    moe = MixtralModel(MixtralConfig.tiny(num_layers=1), device="cpu",
                       mesh=_mesh(2, 0))
    assert moe.layers[0].w_gate.shape[2] == moe.config.intermediate_size // 2
    # training under tensor parallelism is ported (test_torch_tp_train
    # runs it on gloo ranks): the config group is typed, the models train
    assert DeepSpeedConfig.from_dict({"tensor_parallel": {
        "autotp_size": 2}}).tensor_parallel.autotp_size == 2
    assert LlamaModel.tensor_parallel_training
    assert MixtralModel.tensor_parallel_training
    # OPT trains under tensor parallelism too (test_torch_tp_train)
    assert OPTModel.tensor_parallel_training
    # with a seq axis Ulysses splits each rank's h/tp heads: a count that
    # does not divide is named as h/tp (the ring takes any)
    seq = LlamaModel(cfg, device="cpu", mesh=ProcessMesh(
        MeshLayout(tp=2, sp=8), rank=0, groups={("seq",): None}))
    with pytest.raises(ValueError, match=r"h/tp = 8/2 = 4 heads not "
                       "divisible by sp=8"):
        seq.loss(torch.zeros(1, 16, dtype=torch.long))
    # an expert axis under it trains (test_torch_expert_mesh); a MoE at
    # tensor x seq is refused (item 7c), before any mesh
    with pytest.raises(NotImplementedError, match="MixtralModel at tensor "
                       r"x seq is not ported yet \(ROADMAP Queue 1 item "
                       "7c"):
        dst_initialize(model=moe, device="cpu", config={
            "train_micro_batch_size_per_gpu": 1,
            "sequence_parallel": {"sp_size": 2},
            "moe": {"expert_parallel_size": 2}})
    model = LlamaModel(cfg, device="cpu", mesh=_mesh(2, 1))
    with pytest.raises(ValueError, match="built for 2"):
        build_engine_v2(model, cache_config=KVCacheConfig(**CACHE),
                        device="cpu", mesh=_mesh(1, 0), **ENGINE)
    with pytest.raises(ValueError, match="needs device='cuda'"):
        init_distributed(dist_backend="nccl", device="cpu")


# -- #2b: the head-sharded paged decode ----------------------------------

@pytest.mark.parametrize("window", [None, 6])
def test_paged_tp_matches_jax_on_a_two_way_mesh(window):
    """GQA 8/4, pages of 4, ragged lengths: each rank's heads through the
    port, concatenated, within 1e-5 of JAX's shard_map over ``tensor``."""
    rng = np.random.RandomState(3)
    B, h, kv, d, bs, mb = 3, 8, 4, 16, 4, 5
    q = rng.randn(B, h, d).astype(np.float32)
    k_pool = rng.randn(B * mb + 1, bs, kv, d).astype(np.float32)
    v_pool = rng.randn(B * mb + 1, bs, kv, d).astype(np.float32)
    tables = (rng.permutation(B * mb) + 1).reshape(B, mb).astype(np.int32)
    lengths = np.array([1, 9, 20], np.int32)
    mesh = build_mesh(JaxMeshLayout.infer(8, tp=2))
    # under jit, as the JAX engine calls it (the installed JAX refuses an
    # eager shard_map that is manual over only some of the mesh's axes)
    want = np.asarray(jax.jit(lambda *a: jax_paged_decode_attention_tp(
        *a, mesh=mesh, window=window))(
        *map(jnp.asarray, (q, k_pool, v_pool, tables, lengths))))
    t = {n: torch.from_numpy(a) for n, a in
         dict(q=q, k=k_pool, v=v_pool, tables=tables, lengths=lengths).items()}
    parts = [paged_decode_attention_tp(
        t["q"][:, r * 4:(r + 1) * 4], t["k"][:, :, r * 2:(r + 1) * 2],
        t["v"][:, :, r * 2:(r + 1) * 2], t["tables"], t["lengths"],
        _mesh(2, r), window=window) for r in range(2)]
    got = torch.cat(parts, dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    whole = paged_decode_attention(t["q"], t["k"], t["v"], t["tables"],
                                   t["lengths"], window=window)
    assert torch.equal(got, whole)
    assert paged_decode_attention_tp.launches == 0  # the CPU never counts


# -- the slice in two ranks over gloo ---------------------------------------

def test_engines_tp_match_jax(tiny, opt_tiny):
    """v2 at ``tp=2``: JAX's meshless engine's greedy tokens on both ranks,
    through the paged kernel on each rank's heads, over a pool of 2 of the
    4 kv heads, first logits within 1e-4.  v1 with ``tensor_parallel=
    {"tp_size": 2}`` on a whole model: JAX v1's greedy tokens.  OPT: v2
    and v1 at ``tp=2`` give the ``tp=1`` port's tokens, the first logits
    within 1e-4 of JAX's OPT."""
    jm, params, cfg_kw, weights = tiny
    ojm, ohost, opt_kw, opt_weights = opt_tiny
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 512, size=n).tolist() for n in (4, 13)]
    want = jax_build_engine_v2(
        jm, params, cache_config=JaxKVCacheConfig(**CACHE),
        **ENGINE).generate(prompts, max_new_tokens=5)
    first = jnp.asarray([prompts[0]])
    logits, _ = jm.prefill(params, first, jm.init_cache(1, first.shape[1]))
    ids = np.random.RandomState(0).randint(1, 512, size=(2, 11))
    want_v1 = np.asarray(jax_init_inference(
        model=jm, model_params=params, dtype=jnp.float32).generate(
        jnp.asarray(ids), max_new_tokens=6))
    got = launch(ranks.engines_rank, 2, (
        cfg_kw, weights, prompts, 5, CACHE, ENGINE, ids, 6,
        {"kw": opt_kw, "weights": opt_weights}), timeout=TIMEOUT)
    one = OPTModel(OPTConfig(**opt_kw), device="cpu")
    one.load_state_dict(ranks._state_dict(opt_weights))
    opt_v2 = build_engine_v2(one, cache_config=KVCacheConfig(**CACHE),
                             device="cpu", **ENGINE).generate(
                                 prompts, max_new_tokens=5)
    opt_v1 = init_inference(one, device="cpu").generate(
        torch.from_numpy(ids), max_new_tokens=6).numpy()
    ofirst = jnp.asarray([prompts[0]])
    opt_logits, _ = ojm.prefill(ohost, ofirst,
                                ojm.init_cache(1, ofirst.shape[1]))
    for r in got:
        assert r["tokens"] == want
        assert r["attn_path"] == "pallas_tp_shard_map"
        assert r["pool_heads"] == 2
        np.testing.assert_allclose(r["logits"], np.asarray(logits),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r["v1_tokens"], want_v1)
        assert r["v1_tp"] == 2 and r["v1_q_rows"] == 4 * 16
        o = r["opt"]
        assert o["tokens"] == opt_v2
        assert o["attn_path"] == "pallas_tp_shard_map"
        assert o["pool_heads"] == 4
        np.testing.assert_array_equal(o["v1_tokens"], opt_v1)
        assert o["v1_tp"] == 2 and o["v1_fc_in_rows"] == 256 // 2
        np.testing.assert_allclose(o["logits"], np.asarray(opt_logits),
                                   rtol=1e-4, atol=1e-4)


def test_frontend_tp_matches_the_tp1_frontend(tiny):
    _, _, cfg_kw, weights = tiny
    rng = np.random.RandomState(5)
    header = rng.randint(1, 512, size=8).tolist()
    prompts = [header + rng.randint(1, 512, size=n).tolist()
               for n in (3, 11, 6)] + [rng.randint(1, 512, size=9).tolist()]
    model = LlamaModel(LlamaConfig(**cfg_kw), device="cpu")
    model.load_state_dict(ranks._state_dict(weights))
    engine = dict(ENGINE, prefill_batch=2)
    want = ranks.serve_script(build_serving_frontend(
        model, cache_config=KVCacheConfig(**CACHE), device="cpu", **engine),
        prompts, 6)
    got = launch(ranks.frontend_rank, 2, (cfg_kw, weights, prompts, 6, CACHE,
                                          engine), timeout=TIMEOUT)
    for r in got:
        assert r["tokens"] == want
        assert "pump() itself" in r["start_refused"]


def test_comm_verbs_equal_numpy():
    rng = np.random.RandomState(11)
    inputs = [rng.randn(3, 4).astype(np.float32) for _ in range(2)]
    got = launch(ranks.comm_rank, 2, (inputs,), timeout=TIMEOUT)
    for name, dtype in ranks.DTYPES.items():
        # the values each rank holds in this dtype, back in fp32 (exact)
        a, b = (torch.from_numpy(x).to(dtype).float().numpy()
                for x in inputs)
        total = torch.from_numpy(a + b).to(dtype).float().numpy()
        want = {"sum": total, "max": np.maximum(a, b),
                "gather0": np.concatenate([a, b], 0),
                "gather1": np.concatenate([a, b], 1), "bcast": b}
        for r in got:
            for k, v in want.items():
                np.testing.assert_array_equal(r[name][k], v,
                                              err_msg=f"{name} {k}")


def test_a_failing_rank_fails_the_launch_fast():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch(ranks.comm_rank, 2, ([np.zeros((2, 2), np.float32)],),
               timeout=TIMEOUT)


def test_a_collective_one_rank_never_joins_times_out():
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2 did not"):
        launch(ranks.stray_rank, 2, timeout=6)
    assert time.monotonic() - t0 < 30  # the stray rank was killed
