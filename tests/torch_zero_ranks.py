"""Rank bodies of the ZeRO parity tests (``test_torch_zero``).

``launcher.local.launch`` runs :func:`zero_rank` in fresh processes that
import this module by name; it imports no JAX, so a rank starts with
PyTorch alone.  Each rank joins a gloo group on the CPU (one thread a
rank), runs every case of :data:`CASES` (a fresh model and engine each),
and returns plain values: per case the metrics of every step and the
parameters gathered after the steps, plus the checks of the collective
verbs, ``zero.Init`` / ``GatheredParameters``, Mixtral on the data axis
and the refusals.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                 MixtralModel, comm, init_distributed,
                                 initialize, zero)
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups

#: the tiny Llama of the parity tests: 2 layers, GQA 8/4, fp32 masters
MODEL = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
             num_layers=2, num_heads=8, num_kv_heads=4, max_seq_len=256)

#: leaves of at most this many elements stay replicated: the norms (128)
#: do, every matrix (16384 and up) is cut
THRESHOLD = 1000

#: one row a rank: the global batch of four ranks is four rows, as in
#: test_torch_train's engine cases (at eight rows one embedding entry's
#: gradient cancels to a few ulps, and Adam turns the two frameworks'
#: scatter-add orders into opposite updates of it, with or without data
#: parallelism)
BASE = {"train_micro_batch_size_per_gpu": 1, "steps_per_print": 0,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 3e-3, "weight_decay": 0.01}}}

STEPS = 5

#: name -> (stage, compute dtype, config overrides); every rank count runs
#: the four stages, two ranks also the three others
STAGE_CASES = {f"stage{s}": (s, "float32", {}) for s in range(4)}
EXTRA_CASES = {
    # the norm crosses 0.5, so the clip factor reads the global norm
    "stage2_gas2_clip": (2, "float32", {"gradient_accumulation_steps": 2,
                                        "gradient_clipping": 0.5}),
    # rank 1's row all one token, rank 0's without it, the final norm at
    # OVERFLOW_NORM: rank 1's fp16 gradient of that token's lm_head row
    # overflows at 2^15 and 2^14 (JAX's, reduced in fp16, too) and not
    # after; under stage 2 the Inf lands in group rank 0's chunk only
    "stage2_fp16_overflow": (2, "float16", {
        "fp16": {"enabled": True, "initial_scale_power": 16,
                 "hysteresis": 1, "loss_scale_window": 2}}),
    "stage3_fused_adam_clip": (3, "float32", {
        "kernels": {"fused_adam": True}, "gradient_clipping": 0.5}),
}
#: ZeRO-Offload on two ranks: this rank's chunk of the masters and
#: moments in host memory, the C++ Adam over it
OFFLOAD_CASES = {
    f"offload_stage{s}": (s, "float32", {
        "zero_optimization": {"stage": s,
                              "stage3_param_persistence_threshold":
                              THRESHOLD,
                              "offload_optimizer": {"device": "cpu"}}})
    for s in (1, 2, 3)}
DTYPES = {"float32": torch.float32, "float16": torch.float16}
#: the overflow case's final-norm weight (ones times this)
OVERFLOW_NORM = 4.0
OVERFLOW_TOKEN = 7


def all_cases() -> Dict[str, Any]:
    return {**STAGE_CASES, **EXTRA_CASES, **OFFLOAD_CASES}


def case_config(name: str) -> Dict[str, Any]:
    stage, _, overrides = all_cases()[name]
    return {**BASE, "zero_optimization": {
        "stage": stage, "stage3_param_persistence_threshold": THRESHOLD},
        **overrides}


def global_batches(name: str, world: int) -> List[np.ndarray]:
    """The global batch of each step: ``micro x gas x world`` rows."""
    gas = case_config(name).get("gradient_accumulation_steps", 1)
    rows = BASE["train_micro_batch_size_per_gpu"] * gas * world
    if "overflow" in name:
        out = []
        for i in range(STEPS):
            b = np.random.RandomState(10 + i).randint(
                OVERFLOW_TOKEN + 1, 512, (rows, 16)).astype(np.int32)
            b[rows // 2:] = OVERFLOW_TOKEN
            out.append(b)
        return out
    return [np.random.RandomState(10 + i).randint(0, 512, (rows, 16))
            .astype(np.int32) for i in range(STEPS)]


def local_rows(batch: np.ndarray, rank: int, world: int) -> np.ndarray:
    """The rows JAX's batch sharding gives device ``rank``: the ``rank``-th
    of ``world`` contiguous blocks."""
    n = batch.shape[0] // world
    return batch[rank * n:(rank + 1) * n]


def _model(dtype, seed: int) -> LlamaModel:
    return LlamaModel(LlamaConfig(dtype=dtype, param_dtype=torch.float32,
                                  **MODEL), device="cpu", seed=seed)


def _gathered(model) -> Dict[str, np.ndarray]:
    params = list(model.parameters())
    with zero.GatheredParameters(params):
        return {k: v.detach().numpy().copy()
                for k, v in model.named_parameters()}


def _run_case(rank: int, world: int, name: str,
              weights: Dict[str, np.ndarray]) -> Dict[str, Any]:
    _, dtype, _ = all_cases()[name]
    # rank 0 holds the reference weights; the others draw their own, which
    # initialize replaces with rank 0's
    model = _model(DTYPES[dtype], seed=100 + rank)
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
        if "overflow" in name:
            with torch.no_grad():
                model.final_norm.mul_(OVERFLOW_NORM)
    engine, *_ = initialize(model=model, config=case_config(name),
                            device="cpu")
    out: Dict[str, Any] = {k: [] for k in ("loss", "grad_norm", "lr",
                                           "loss_scale", "skipped")}
    out["cut"] = sum(p is not None for p in engine.placements)
    out["chunk_numel"] = sum(p.numel() for p in engine.params)
    if engine.offload_opt is not None:  # this rank's share, on the host
        opt = engine.offload_opt
        out["host_state_bytes"] = opt.state_bytes
        out["host_numel"] = sum(m.numel() for m in opt.masters)
        out["host_devices"] = sorted({str(t.device) for t in opt.masters
                                      + opt.opt.exp_avg})
    for batch in global_batches(name, world):
        m = engine.train_step({"input_ids": torch.from_numpy(
            local_rows(batch, rank, world))})
        for k in ("loss", "grad_norm", "lr", "loss_scale"):
            out[k].append(float(m[k]))
        out["skipped"].append(engine.skipped_steps)
    out["params"] = _gathered(model)
    return out


def _verbs(rank: int, world: int) -> Dict[str, Any]:
    x = torch.arange(world * 6 * 4, dtype=torch.float32).view(world * 6, 4)
    x = x * (rank + 1)
    y = torch.arange(6 * world * 8, dtype=torch.float32).view(6, world * 8)
    y = y + rank
    return {"rs0": comm.reduce_scatter(x).numpy(),
            "rs1": comm.reduce_scatter(y, dim=1).numpy(),
            "rs1_avg": comm.reduce_scatter(y, comm.ReduceOp.AVG,
                                           dim=1).numpy(),
            "a2a": comm.all_to_all_single(
                torch.arange(world * 3, dtype=torch.float32)
                + 100 * rank).numpy()}


def _init_and_gathered(rank: int, world: int) -> Dict[str, Any]:
    """``zero.Init`` builds each rank's chunks of the seed-0 model whatever
    its seed; ``GatheredParameters`` reads the whole tensors and, with
    ``modifier_rank``, keeps that rank's edit; the built model trains at
    stage 3 as the whole model does at stage 0."""
    config = case_config("stage3")
    whole = _model(torch.float32, seed=0)
    with zero.Init(config_dict_or_path=config):
        model = _model(torch.float32, seed=0 if rank == 0 else 100 + rank)
    out: Dict[str, Any] = {
        "chunk_shapes": {k: list(v.shape)
                         for k, v in model.named_parameters()},
        "cut": sorted(k for k, v in model.named_parameters()
                      if zero.placement_of(v) is not None)}
    got = _gathered(model)
    out["gathered_equal_whole"] = all(
        np.array_equal(got[k], v.detach().numpy())
        for k, v in whole.named_parameters())
    out["chunk_back"] = [list(p.shape) for p in model.parameters()] == [
        out["chunk_shapes"][k] for k, _ in model.named_parameters()]
    emb = model.embed.weight
    with zero.GatheredParameters([emb], modifier_rank=1):
        with torch.no_grad():
            emb.fill_(float(rank + 1))  # only rank 1's edit survives
    out["modified"] = np.unique(_gathered(model)["embed.weight"]).tolist()
    model = None
    with zero.Init(config_dict_or_path=config):
        model = _model(torch.float32, seed=0 if rank == 0 else 100 + rank)
    batches = global_batches("stage3", world)[:2]
    losses = {}
    for what, m, stage in (("init", model, 3), ("whole", whole, 0)):
        engine, *_ = initialize(model=m, config=case_config(f"stage{stage}"),
                                device="cpu")
        losses[what] = [float(engine.train_step({"input_ids":
                                                 torch.from_numpy(local_rows(
                                                     b, rank, world))})
                              ["loss"]) for b in batches]
    out["losses"] = losses
    return out


def uneven_batch() -> Dict[str, np.ndarray]:
    """Four rows whose labels are masked unevenly: the first two keep 3
    labelled tokens a row, the last two 15."""
    ids = np.random.RandomState(5).randint(0, 512, (4, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], 1)
    labels[:2, :12] = -100
    return {"input_ids": ids, "labels": labels.astype(np.int32)}


def _uneven_eval(rank: int, world: int,
                 weights: Dict[str, np.ndarray]) -> float:
    """``eval_loss`` of :func:`uneven_batch`'s rows of this rank (averaged
    over the ranks by the engine)."""
    model = _model(torch.float32, seed=100 + rank)
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
    engine, *_ = initialize(model=model, config=case_config("stage0"),
                            device="cpu")
    rows = {k: torch.from_numpy(local_rows(v, rank, world))
            for k, v in uneven_batch().items()}
    return float(engine.eval_loss(rows))


#: the hybrid engine's prompt and greedy length at ZeRO-3
HYBRID_PROMPT, HYBRID_NEW = [[5, 40, 311, 2, 77, 9]], 6


def hybrid_z3_config() -> Dict[str, Any]:
    return dict(case_config("stage3"), hybrid_engine={"enabled": True})


def _hybrid_z3(rank: int, world: int,
               weights: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The hybrid engine at ZeRO-3: one step of the stage-3 case's first
    global batch, then greedy tokens, the model reading its cut weights
    through ``compute_weight`` (gathered over the ranks)."""
    model = _model(torch.float32, seed=0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    engine, *_ = initialize(model=model, config=hybrid_z3_config(),
                            device="cpu")
    engine.train_step({"input_ids": torch.from_numpy(local_rows(
        global_batches("stage3", world)[0], rank, world))})
    tokens = engine.generate(torch.tensor(HYBRID_PROMPT),
                             max_new_tokens=HYBRID_NEW).tolist()
    return {"tokens": tokens, "cut": sum(p is not None
                                         for p in engine.placements),
            "kind": type(engine).__name__}


def _refusals(rank: int) -> Dict[str, Any]:
    """Mixtral trains on the data axis (its routing is the global
    micro-batch's: two steps' losses), and so does ZeRO-Infinity, on the
    data axis and on a tensor axis; serving a model cut under ZeRO-3 is
    refused."""
    out: Dict[str, Any] = {}
    moe = MixtralModel(MixtralConfig.tiny(num_layers=1, dtype=torch.float32,
                                          param_dtype=torch.float32),
                       device="cpu")
    engine, *_ = initialize(model=moe, config=BASE, device="cpu")
    ids = torch.arange(16)[None] * 3 + 50 * rank
    out["mixtral"] = [float(engine.train_step({"input_ids": ids})["loss"])
                      for _ in range(2)]
    from deepspeed_tpu_torch import build_engine_v2, init_inference
    from deepspeed_tpu_torch.inference.v2 import KVCacheConfig
    with zero.Init(config_dict_or_path=case_config("stage3")):
        model = _model(torch.float32, seed=0)
    for what, build in (
            ("init_inference", lambda: init_inference(model, device="cpu")),
            ("build_engine_v2", lambda: build_engine_v2(
                model, cache_config=KVCacheConfig(
                    num_blocks=8, block_size=4, max_seq_len=64),
                prefill_chunk=8, device="cpu"))):
        try:
            build()
            out[what] = "accepted"
        except ValueError as e:
            out[what] = str(e)
    # ZeRO-Infinity on two data ranks trains (two steps, one batch)
    engine, *_ = initialize(model=_model(torch.float32, seed=rank),
                            config=dict(BASE, zero_optimization={
                                "stage": 3, "offload_param": {
                                    "device": "cpu"}}), device="cpu")
    ids = torch.arange(16)[None] * 3 + 50 * rank
    out["infinity_2_ranks"] = [float(engine.train_step(
        {"input_ids": ids})["loss"]) for _ in range(2)]
    # ... and on a tensor axis of 2 (each rank streams its blocks): two
    # steps on one batch, the same on both ranks
    mesh = groups.initialize_mesh(MeshLayout.infer(2, tp=2))
    try:
        engine, *_ = initialize(model=LlamaModel(LlamaConfig(
            dtype=torch.float32, param_dtype=torch.float32, **MODEL),
            device="cpu", mesh=mesh),
            config=dict(BASE, zero_optimization={
                "stage": 3, "offload_param": {"device": "cpu"}}),
            mesh=mesh, device="cpu")
        ids = torch.arange(16)[None] * 3
        out["infinity_tp"] = [float(engine.train_step(
            {"input_ids": ids})["loss"]) for _ in range(2)]
    finally:
        groups.reset_mesh()
    return out


def zero_rank(rank: int, weights: Dict[str, np.ndarray],
              extras: bool) -> Dict[str, Any]:
    """Every case on this rank (``extras``: also the extra cases, the
    ``Init`` / ``GatheredParameters`` checks and the refusals)."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    names = list(STAGE_CASES) + (list(EXTRA_CASES) + list(OFFLOAD_CASES)
                                 if extras else [])
    out: Dict[str, Any] = {name: _run_case(rank, world, name, weights)
                           for name in names}
    out["verbs"] = _verbs(rank, world)
    if extras:
        out["init"] = _init_and_gathered(rank, world)
        out["refusals"] = _refusals(rank)
        out["uneven_eval"] = _uneven_eval(rank, world, weights)
        out["hybrid_z3"] = _hybrid_z3(rank, world, weights)
    return out


__all__ = ["BASE", "EXTRA_CASES", "HYBRID_NEW", "HYBRID_PROMPT", "MODEL",
           "OFFLOAD_CASES", "OVERFLOW_NORM", "hybrid_z3_config",
           "STAGE_CASES", "STEPS", "all_cases",
           "THRESHOLD", "case_config", "global_batches", "local_rows",
           "uneven_batch", "zero_rank"]
