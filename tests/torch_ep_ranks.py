"""Rank bodies of the expert-parallel tests (``test_torch_expert_parallel``).

``launcher.local.launch`` runs :func:`ep_rank` in fresh processes that
import this module by name; it imports no JAX, so a rank starts with
PyTorch alone.  Each rank joins a gloo group on the CPU (one thread a
rank) and runs every case of its world size, each on the mesh of its
layout (``MeshLayout.infer(world, ep=, dp=)``, built inside the launch):
the MoE layer's global routing, training a tiny Mixtral, checkpoints
across expert-parallel sizes and, on two ranks, Mixtral served under
tensor parallelism.  It returns plain values (numpy arrays and lists).
"""

from typing import Any, Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch import (KVCacheConfig, MixtralConfig, MixtralModel,
                                 build_engine_v2, comm, init_distributed,
                                 init_inference, initialize, zero)
from deepspeed_tpu_torch.models import shard_mixtral_params
from deepspeed_tpu_torch.moe import MOELayer, TopKGate, swiglu_expert_fn
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups

#: the tiny Mixtral of the tests: 2 layers, GQA 8/4, 4 experts, top-2,
#: fp32 masters (``MixtralConfig.tiny``)
MODEL = dict(num_layers=2)
#: layout name -> (ep, dp)
LAYOUTS = {"ep2": (2, 1), "dp2": (1, 2), "ep2dp2": (2, 2)}
#: the layouts a world of each size runs
WORLD_LAYOUTS = {2: ("ep2", "dp2"), 4: ("ep2dp2",)}

SEQ, STEPS, THRESHOLD = 16, 4, 1000
BASE = {"train_micro_batch_size_per_gpu": 1, "steps_per_print": 0,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 3e-3, "weight_decay": 0.01}},
        "moe": {"dispatch_impl": "sparse"}}

#: name -> (layout, ZeRO stage, config overrides); the first four are held
#: against the JAX engine on the same mesh, the last two against the same
#: run in one process
TRAIN_CASES = {
    "ep2_z0": ("ep2", 0, {}), "dp2_z0": ("dp2", 0, {}),
    "ep2dp2_z0": ("ep2dp2", 0, {}), "ep2dp2_z3": ("ep2dp2", 3, {}),
    # capacity 16 of 32 tokens top-2 over 4 experts: tokens drop
    "ep2_capacity": ("ep2", 0, {"moe": {"capacity_factor": 1.0,
                                        "dispatch_impl": "sparse"}}),
    "ep2_gas2": ("ep2", 0, {"gradient_accumulation_steps": 2}),
}
JAX_CASES = ("ep2_z0", "dp2_z0", "ep2dp2_z0", "ep2dp2_z3")

#: the routing cases of the MoE layer: (layout, impl, rows a rank,
#: tokens a row, capacity factor); ``pad`` makes C 5, padded to 6 at ep 2
ROUTE_CASES = {
    "ep2_dense": ("ep2", "dense", 2, 8, 2.0),
    "ep2_sparse": ("ep2", "sparse", 2, 8, 2.0),
    "dp2_dense": ("dp2", "dense", 2, 8, 2.0),
    "dp2_sparse": ("dp2", "sparse", 2, 8, 2.0),
    "ep2_pad": ("ep2", "sparse", 1, 5, 1.0),
    "ep2dp2_dense": ("ep2dp2", "dense", 2, 8, 2.0),
    "ep2dp2_sparse": ("ep2dp2", "sparse", 2, 8, 1.0),
}
ROUTE_H, ROUTE_I, ROUTE_E, ROUTE_K = 16, 24, 4, 2

#: the tensor-parallel serving case (``test_torch_tensor_parallel``'s)
CACHE = dict(num_blocks=64, block_size=4, max_seq_len=64)
ENGINE = dict(max_batch_slots=2, prefill_chunk=8, decode_burst=4)


def config(**kw) -> MixtralConfig:
    return MixtralConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                              **dict(MODEL, **kw))


def case_config(name: str) -> Dict[str, Any]:
    layout, stage, overrides = TRAIN_CASES[name]
    ep = LAYOUTS[layout][0]
    moe = dict(BASE["moe"], **overrides.get("moe", {}),
               expert_parallel_size=ep)
    return {**BASE, **overrides, "moe": moe, "zero_optimization": {
        "stage": stage, "stage3_param_persistence_threshold": THRESHOLD}}


def world_of(layout: str) -> int:
    ep, dp = LAYOUTS[layout]
    return ep * dp


def microbatches(name: str) -> List[List[np.ndarray]]:
    """Each step's global microbatches: ``gas`` arrays of one row a rank,
    step ``i`` drawn from seed ``10 + i`` as in ``torch_zero_ranks`` (where
    one embedding entry's gradient cancels to rounding noise, Adam's first
    steps turn the two frameworks' summation orders into opposite updates
    of it, in one process as on a mesh; these batches have none)."""
    gas = TRAIN_CASES[name][2].get("gradient_accumulation_steps", 1)
    world = world_of(TRAIN_CASES[name][0])
    return [[np.random.RandomState(10 + i + 100 * j).randint(
        0, 512, (world, SEQ)).astype(np.int32) for j in range(gas)]
        for i in range(STEPS)]


def rank_rows(step: List[np.ndarray], rank: int) -> np.ndarray:
    """This rank's rows of a step: its row of each microbatch (the rows
    JAX's batch sharding gives device ``rank``), in microbatch order."""
    return np.concatenate([mb[rank:rank + 1] for mb in step])


def route_inputs(name: str) -> Dict[str, np.ndarray]:
    """The global input ``[rows x world, S, H]``, the router and the
    expert stacks of a routing case."""
    layout, _, rows, seq, _ = ROUTE_CASES[name]
    rng = np.random.RandomState(sorted(ROUTE_CASES).index(name))
    H, I, E = ROUTE_H, ROUTE_I, ROUTE_E

    def normal(*shape):
        return rng.randn(*shape).astype(np.float32)

    return {"x": normal(rows * world_of(layout), seq, H),
            "wg": normal(H, E),
            "w_gate": normal(E, H, I) / np.sqrt(H),
            "w_up": normal(E, H, I) / np.sqrt(H),
            "w_down": normal(E, I, H) / np.sqrt(I)}


def _mesh(layout: str):
    ep, dp = LAYOUTS[layout]
    return groups.initialize_mesh(MeshLayout.infer(ep * dp, ep=ep, dp=dp))


def _route(name: str, mesh) -> Dict[str, Any]:
    """This rank's rows through ``MOELayer(mesh=...)``: its output rows,
    the capacity, ``l_aux`` and the gate metadata."""
    _, impl, rows, _, factor = ROUTE_CASES[name]
    inp = {k: torch.from_numpy(v) for k, v in route_inputs(name).items()}
    ep, r = mesh.shape["expert"], comm.get_rank(mesh.group("expert", "data"))
    e = mesh.axis_rank("expert")
    n = ROUTE_E // ep
    experts = {k: inp[k][e * n:(e + 1) * n] for k in
               ("w_gate", "w_up", "w_down")}
    gate = TopKGate(num_experts=ROUTE_E, k=ROUTE_K, capacity_factor=factor)
    layer = MOELayer(gate, swiglu_expert_fn, mesh=mesh, dispatch_impl=impl)
    y, l_aux, meta = layer(inp["wg"], experts, inp["x"][r * rows:
                                                        (r + 1) * rows])
    return {"y": y.numpy(), "capacity": layer.last_capacity,
            "impl": layer.last_impl, "l_aux": float(l_aux),
            "exp_counts": meta["exp_counts"].numpy(),
            "drop_rate": float(meta["drop_rate"])}


def _gathered(model) -> Dict[str, np.ndarray]:
    """This rank's parameters, ZeRO-3 chunks gathered (the expert stacks
    hold this rank's experts)."""
    params = list(model.parameters())
    with zero.GatheredParameters(params):
        return {k: v.detach().numpy().copy()
                for k, v in model.named_parameters()}


def _train(name: str, weights: Dict[str, np.ndarray], mesh
           ) -> Dict[str, Any]:
    """Every step of a training case on this rank: its metrics, the
    placements and the parameters after the steps.  Rank 0 holds the
    reference weights; the others draw their own (``initialize``
    broadcasts rank 0's over each leaf's group)."""
    rank = comm.get_rank()
    model = MixtralModel(config(), device="cpu", seed=100 + rank, mesh=mesh)
    if rank == 0 or mesh.axis_rank("data") == 0:
        # the data group's rank 0 holds its experts' reference weights
        sd = shard_mixtral_params(
            {k: torch.from_numpy(v) for k, v in weights.items()}, 1,
            model.ep, 0, model.ep_rank)
        own = {k: v for k, v in sd.items() if rank == 0 or ".w_" in k}
        model.load_state_dict(own, strict=False)
    engine, *_ = initialize(model=model, config=case_config(name),
                            device="cpu", mesh=mesh)
    out: Dict[str, Any] = {k: [] for k in ("loss", "grad_norm", "lr")}
    out["cut"] = {n: [pl.dim, pl.dp] for n, pl in zip(engine.param_names,
                                                      engine.placements)
                  if pl is not None}
    for step in microbatches(name):
        m = engine.train_step({"input_ids": torch.from_numpy(
            rank_rows(step, rank))})
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
    out["capacity"] = model._moe_layer.last_capacity
    out["capacity_factor"] = model._moe_layer.gate.capacity_factor
    out["params"] = _gathered(model)
    return out


#: the reference-shaped MoE block of the placement case: Residual-MoE,
#: top-2 of 4 experts, no drops
BLOCK = dict(hidden_size=16, num_experts=4, k=2, capacity_factor=2.0,
             use_residual=True, use_rts=False)
BLOCK_I, BLOCK_SEED = 24, 5


def block_input(world: int) -> np.ndarray:
    """The global input of the block case: 2 rows of 8 tokens a rank."""
    return np.random.RandomState(9).randn(2 * world, 8, 16).astype(
        np.float32)


def block_cotangent(world: int) -> np.ndarray:
    """The cotangent of the block's output (the global input's shape)."""
    return np.random.RandomState(10).randn(2 * world, 8, 16).astype(
        np.float32)


def _moe_block(mesh) -> Dict[str, Any]:
    """``MoE`` on ``mesh`` with its JAX placement (experts over
    ``expert``, the FFN dim over ``tensor``): ``init_params`` keeps this
    rank's slice of the seed's whole weights; on a data axis the rank feeds
    its rows, under tensor parallelism every rank the whole batch.  The
    gradients of ``Σ y·ct + l_aux`` come back too: under tensor
    parallelism the input's, the router's and the coefficient's must be
    whole on every rank."""
    from deepspeed_tpu_torch.moe import MoE
    world = comm.get_world_size()
    moe = MoE(**BLOCK, ep_size=mesh.shape["expert"], mesh=mesh,
              enable_expert_tensor_parallelism=True)
    params = moe.init_params(torch.Generator().manual_seed(BLOCK_SEED),
                             BLOCK_I)
    leaves = [params["wg"], params["coefficient"],
              params["residual_mlp"]["w_gate"],
              params["experts"]["w_gate"]]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(block_input(world))
    ct = torch.from_numpy(block_cotangent(world))
    if mesh.shape["tensor"] == 1:
        r = comm.get_rank(mesh.group("expert", "data"))
        x, ct = x[2 * r:2 * r + 2], ct[2 * r:2 * r + 2]
    x.requires_grad_(True)
    y, l_aux, _ = moe(params, x)
    ((y * ct).sum() + l_aux).backward()
    return {"y": y.detach().numpy(), "l_aux": float(l_aux.detach()),
            "w_gate": list(params["experts"]["w_gate"].shape),
            "grads": {name: t.grad.numpy() for name, t in zip(
                ("x", "wg", "coefficient", "residual_w_gate",
                 "expert_w_gate"), [x] + leaves)}}


def _ckpt_model(mesh):
    return MixtralModel(config(), device="cpu", seed=7, mesh=mesh)


def _load_save(mesh, load_dir: str, save_dir: str, stage: int,
               train_steps: int) -> Dict[str, Any]:
    """Load ``load_dir`` at ``stage`` on ``mesh``, report this rank's
    masters, take ``train_steps`` steps, then save to ``save_dir``."""
    rank = comm.get_rank()
    model = _ckpt_model(mesh)
    cfg = dict(case_config("ep2_z0"), zero_optimization={
        "stage": stage, "stage3_param_persistence_threshold": THRESHOLD})
    cfg["moe"] = dict(cfg["moe"], expert_parallel_size=mesh.shape["expert"])
    engine, *_ = initialize(model=model, config=cfg, device="cpu", mesh=mesh)
    tag, _ = engine.load_checkpoint(load_dir)
    loaded = _gathered(model)
    for step in microbatches("ep2_z0")[:train_steps]:
        engine.train_step({"input_ids": torch.from_numpy(
            rank_rows(step, rank))})
    engine.save_checkpoint(save_dir)
    return {"loaded": loaded, "tag": tag, "ep_rank": model.ep_rank,
            "steps": engine.global_steps}


def _serve_tp(weights: Dict[str, np.ndarray], prompts, n_new: int, ids,
              v1_new: int) -> Dict[str, Any]:
    """Mixtral at ``tp=2``: v2 greedy tokens and the first prompt's
    logits on this rank's shard, then v1 ``init_inference(tensor_parallel=
    {"tp_size": 2})`` on a whole model, which it splits."""
    mesh = groups.initialize_mesh(MeshLayout.infer(tp=2))
    block = _moe_block(mesh)
    sd = {k: torch.from_numpy(v) for k, v in weights.items()}
    model = MixtralModel(config(), device="cpu", mesh=mesh)
    model.load_state_dict(shard_mixtral_params(sd, 2, 1, model.tp_rank, 0))
    eng = build_engine_v2(model, cache_config=KVCacheConfig(**CACHE),
                          device="cpu", mesh=mesh, **ENGINE)
    tokens = eng.generate(prompts, max_new_tokens=n_new)
    first = torch.tensor([prompts[0]])
    logits, _ = model.prefill(first, model.init_cache(1, first.shape[1]))
    whole = MixtralModel(config(), device="cpu")
    whole.load_state_dict(sd)
    v1 = init_inference(whole, tensor_parallel={"tp_size": 2}, device="cpu")
    out = v1.generate(torch.from_numpy(ids), max_new_tokens=v1_new)
    return {"tokens": tokens, "logits": logits.numpy(),
            "attn_path": eng.last_attn_path, "v1_tokens": out.numpy(),
            "v1_tp": whole.tp,
            "v1_expert_cols": whole.layers[0].w_gate.shape[2],
            "block": block}


def _whole_model_cut(rank: int) -> Dict[str, Any]:
    """A whole Mixtral given to ``initialize`` with
    ``moe.expert_parallel_size`` 2 and no mesh: ``initialize`` builds the
    ``ep=2 x dp=2`` mesh and keeps this rank's experts; one step."""
    model = MixtralModel(config(), device="cpu")
    cfg = case_config("ep2dp2_z0")
    engine, *_ = initialize(model=model, config=cfg, device="cpu")
    step = microbatches("ep2dp2_z0")[0]
    loss = engine.train_step({"input_ids": torch.from_numpy(
        rank_rows(step, rank))})["loss"]
    return {"w_gate": list(model.layers[0].w_gate.shape),
            "ep_rank": model.ep_rank, "loss": float(loss)}


def _refusals(mesh) -> Dict[str, str]:
    """What the slice still refuses: ``zero.Init`` on an expert axis."""
    try:
        with zero.Init(config_dict_or_path=case_config("ep2dp2_z3"),
                       mesh=mesh):
            pass
        return {"zero_init": "accepted"}
    except NotImplementedError as e:
        return {"zero_init": str(e)}


def ep_rank(rank: int, weights: Dict[str, np.ndarray], ckpt: Dict[str, str],
            serve: Dict[str, Any]) -> Dict[str, Any]:
    """Every case of this world size on this rank.  ``ckpt``: the
    directories to load from and save to; ``serve``: the two-rank
    serving case's inputs (None on four ranks)."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    out: Dict[str, Any] = {"route": {}, "train": {}}
    for layout in WORLD_LAYOUTS[world]:
        mesh = _mesh(layout)
        for name, case in ROUTE_CASES.items():
            if case[0] == layout:
                out["route"][name] = _route(name, mesh)
        for name, case in TRAIN_CASES.items():
            if case[0] == layout:
                out["train"][name] = _train(name, weights, mesh)
    mesh = _mesh(WORLD_LAYOUTS[world][0])
    out["block"] = _moe_block(mesh)
    if world == 2:
        # the one process's save loads at ep 2; a step on, the ranks save
        out["ckpt"] = _load_save(mesh, ckpt["one"], ckpt["ep2"], 0, 1)
        out["serve"] = _serve_tp(weights, **serve)
    else:
        out["ckpt"] = _load_save(mesh, ckpt["ep2"], ckpt["ep2dp2"], 3, 0)
        out["refusals"] = _refusals(mesh)
        out["whole_cut"] = _whole_model_cut(comm.get_rank())
    return out


__all__ = ["BASE", "BLOCK", "BLOCK_I", "BLOCK_SEED", "CACHE", "ENGINE", "JAX_CASES", "LAYOUTS", "MODEL",
           "ROUTE_CASES", "SEQ", "STEPS", "THRESHOLD", "TRAIN_CASES",
           "block_input", "case_config", "config", "ep_rank",
           "microbatches",
           "rank_rows", "route_inputs", "world_of"]
