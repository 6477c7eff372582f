"""Rank bodies of the ZeRO++ parity tests (``test_torch_zeropp``).

``launcher.local.launch`` runs :func:`zeropp_rank` in fresh processes
that import this module by name; it imports no JAX.  Each rank joins a
gloo group on the CPU (one thread a rank) and returns plain values: the
qgZ functions on the per-worker arrays it was handed, the compute weights
under qwZ at stages 0, 2 and 3, every engine case of its rank count (the
metrics of each step, the parameters gathered after the steps, the bytes
of the last step's collectives), hpZ's placement and checkpoints.
"""

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, comm,
                                 init_distributed, initialize, zero)
from deepspeed_tpu_torch.runtime.zero import qgz
from deepspeed_tpu_torch.runtime.zero.sharder import compute_weight
from deepspeed_tpu_torch.utils import groups
from torch_zero_ranks import BASE, MODEL, THRESHOLD, local_rows

STEPS = 5
#: the threshold of the compute-weight checks: JAX's stacked norms
#: (``attn_norm [2, 128]``, 256 elements) are quantized, the final norm
#: (128) is not, where a per-layer count would spare every norm
QWZ_THRESHOLD = 200
#: name -> (rank count, stage, ``zero_optimization`` extras, other config
#: keys); ``moe.expert_parallel_size`` builds the ep 2 x dp 2 mesh of hpZ
CASES = {
    "stage3_qwz": (2, 3, {"zero_quantized_weights": True}, {}),
    "stage2_qgz": (2, 2, {"zero_quantized_gradients": True}, {}),
    "stage3_qgz": (2, 3, {"zero_quantized_gradients": True}, {}),
    "stage3_qgz_gas2": (2, 3, {"zero_quantized_gradients": True},
                        {"gradient_accumulation_steps": 2}),
    "stage3_qwz_qgz_fused_adam_clip": (
        2, 3, {"zero_quantized_weights": True,
               "zero_quantized_gradients": True},
        {"kernels": {"fused_adam": True}, "gradient_clipping": 0.5}),
    # fp16: rank 1's gradient overflows before the int8 wire (the
    # test_torch_zero overflow pattern)
    "stage2_qgz_fp16_overflow": (
        2, 2, {"zero_quantized_gradients": True},
        {"fp16": {"enabled": True, "initial_scale_power": 16,
                  "hysteresis": 1, "loss_scale_window": 2}}),
    "stage3_hpz": (4, 3, {"zero_hpz_partition_size": 2},
                   {"moe": {"expert_parallel_size": 2}}),
    # plain stage 3 on hpZ's ranks and mesh
    "stage3_ep2": (4, 3, {}, {"moe": {"expert_parallel_size": 2}}),
    # the three together, beside qwZ and qgZ without hpZ
    "stage3_hpz_qwz_qgz": (4, 3, {"zero_hpz_partition_size": 2,
                                  "zero_quantized_weights": True,
                                  "zero_quantized_gradients": True},
                           {"moe": {"expert_parallel_size": 2}}),
    "stage3_ep2_qwz_qgz": (4, 3, {"zero_quantized_weights": True,
                                  "zero_quantized_gradients": True},
                           {"moe": {"expert_parallel_size": 2}}),
}
OVERFLOW_NORM, OVERFLOW_TOKEN = 4.0, 7
#: hpZ's checkpoint: steps before the save, steps after it; how long the
#: two-rank launch waits for the four-rank one's save
CKPT_STEPS, LOAD_WAIT_S = (2, 2), 240


def case_config(name: str) -> Dict[str, Any]:
    _, stage, extra, top = CASES[name]
    return {**BASE, "zero_optimization": {
        "stage": stage, "stage3_param_persistence_threshold": THRESHOLD,
        **extra}, **top}


def case_dtype(name: str) -> torch.dtype:
    return torch.float16 if "fp16" in name else torch.float32


def global_batches(name: str, world: int) -> List[np.ndarray]:
    """The global batch of each step (``micro x gas x world`` rows); the
    overflow case's second half all one token, the first without it."""
    gas = case_config(name).get("gradient_accumulation_steps", 1)
    rows = BASE["train_micro_batch_size_per_gpu"] * gas * world
    out = []
    for i in range(STEPS):
        rng = np.random.RandomState(10 + i)
        if "overflow" in name:
            b = rng.randint(OVERFLOW_TOKEN + 1, 512, (rows, 16))
            b[rows // 2:] = OVERFLOW_TOKEN
        else:
            b = rng.randint(0, 512, (rows, 16))
        out.append(b.astype(np.int32))
    return out


def _model(dtype, seed: int) -> LlamaModel:
    return LlamaModel(LlamaConfig(dtype=dtype, param_dtype=torch.float32,
                                  **MODEL), device="cpu", seed=seed)


def _loaded(weights, rank: int, dtype=torch.float32,
            scale_norm: float = 1.0) -> LlamaModel:
    """Rank 0 holds the reference weights; the others draw their own,
    which ``initialize`` replaces with rank 0's."""
    model = _model(dtype, seed=100 + rank)
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()})
        with torch.no_grad():
            model.final_norm.mul_(scale_norm)
    return model


def _gathered(model) -> Dict[str, np.ndarray]:
    with zero.GatheredParameters(list(model.parameters())):
        return {k: v.detach().numpy().copy()
                for k, v in model.named_parameters()}


def _steps(engine, name: str, rank: int, world: int,
           batches=None) -> Dict[str, Any]:
    """Each step's metrics; under qwZ (on rank 0) also the masters each
    step reads."""
    out: Dict[str, Any] = {k: [] for k in ("loss", "grad_norm", "lr",
                                           "loss_scale", "skipped",
                                           "masters")}
    for batch in batches if batches is not None else \
            global_batches(name, world):
        if engine.qwz_enabled:
            masters = _gathered(engine.module)
            if rank == 0:
                out["masters"].append(masters)
        m = engine.train_step({"input_ids": torch.from_numpy(
            local_rows(batch, rank, world))})
        for k in ("loss", "grad_norm", "lr", "loss_scale"):
            out[k].append(float(m[k]))
        out["skipped"].append(engine.skipped_steps)
    out["wire"] = dict(engine.last_wire)
    return out


def _run_case(rank: int, world: int, name: str,
              weights: Dict[str, np.ndarray]) -> Dict[str, Any]:
    norm = OVERFLOW_NORM if "overflow" in name else 1.0
    model = _loaded(weights, rank, case_dtype(name), norm)
    try:
        engine, *_ = initialize(model=model, config=case_config(name),
                                device="cpu")
        out = _steps(engine, name, rank, world)
        out["params"] = _gathered(model)
        out["master_numel"] = {n: p.numel() for n, p in zip(
            engine.param_names, engine.params)}
        out["state_numel"] = {n: m.numel() for n, m in zip(
            engine.param_names, engine.optimizer.m)}
        out["master_group"] = {n: zero.placement_of(p).dp
                               for n, p in zip(engine.param_names,
                                               engine.params)
                               if zero.placement_of(p) is not None}
        return out
    finally:
        groups.reset_mesh()


def _functions(arrays: Dict[str, np.ndarray], rank: int) -> Dict[str, Any]:
    """The qgZ functions on this worker's slice of each ``[W, ...]``
    array: the all-reduce of ``allreduce*`` and the dim-0 reduce-scatter
    of ``reduce_scatter*``."""
    out = {}
    for key, a in arrays.items():
        g = torch.from_numpy(np.ascontiguousarray(a[rank]))
        out[key] = (qgz.quantized_allreduce(g) if key.startswith("allreduce")
                    else qgz.quantized_reduce_scatter(g, dim=0)).numpy()
    tree = qgz.qgz_reduce_tree({k: torch.from_numpy(np.ascontiguousarray(
        a[rank])) for k, a in arrays.items() if k.startswith("allreduce")})
    out["tree"] = {k: v.numpy() for k, v in tree.items()}
    return out


def _compute_weights(rank: int, weights: Dict[str, np.ndarray]
                     ) -> Dict[str, Any]:
    """Under qwZ (threshold ``QWZ_THRESHOLD``) at stages 0, 2 and 3 in
    fp32, and at stage 3 in bf16: every weight as the model reads it
    (whole)."""
    out = {}
    for dtype, stages in ((torch.float32, (0, 2, 3)),
                          (torch.bfloat16, (3,))):
        for stage in stages:
            model = _loaded(weights, rank, dtype)
            engine, *_ = initialize(model=model, config={
                **BASE, "bf16": {"enabled": dtype == torch.bfloat16},
                "zero_optimization": {
                    "stage": stage, "zero_quantized_weights": True,
                    "stage3_param_persistence_threshold": QWZ_THRESHOLD}},
                device="cpu")
            with torch.no_grad():
                out[f"stage{stage}_{str(dtype)[6:]}"] = {
                    n: compute_weight(p, dtype).float().numpy()
                    for n, p in model.named_parameters()}
            out.setdefault("quantized", sorted(
                n for n, p in model.named_parameters()
                if p.ds_qwz is not None))
            del engine
            groups.reset_mesh()
    return out


def _hpz_checkpoint(rank: int, world: int, weights, save_dir: str
                    ) -> Dict[str, Any]:
    """hpZ at stage 3: steps, a save, more steps; a fresh hpZ engine and a
    plain stage-3 engine (the same ranks, one data axis) each load the
    save and take the same steps.  hpz 3 raises JAX's ValueError."""
    batches = global_batches("stage3_hpz", world)
    before, after = batches[:CKPT_STEPS[0]], \
        batches[CKPT_STEPS[0]:sum(CKPT_STEPS)]
    out: Dict[str, Any] = {}
    try:
        engine, *_ = initialize(model=_loaded(weights, rank),
                                config=case_config("stage3_hpz"),
                                device="cpu")
        _steps(engine, "", rank, world, before)
        tag = engine.save_checkpoint(save_dir)
        out["saved"] = _gathered(engine.module)
        out["continued"] = _steps(engine, "", rank, world, after)["loss"]
    finally:
        groups.reset_mesh()
    plain = dict(case_config("stage3_hpz"))
    plain.pop("moe")
    plain["zero_optimization"] = dict(plain["zero_optimization"],
                                      zero_hpz_partition_size=1)
    for label, config in (("hpz", case_config("stage3_hpz")),
                          ("plain", plain)):
        try:
            engine, *_ = initialize(model=_model(torch.float32, 7 + rank),
                                    config=config, device="cpu")
            engine.load_checkpoint(save_dir)
            out[f"{label}_loaded"] = _gathered(engine.module)
            out[f"{label}_resumed"] = _steps(engine, "", rank, world,
                                             after)["loss"]
        finally:
            groups.reset_mesh()
    out["tag"] = os.path.basename(tag)
    try:
        bad = dict(case_config("stage3_hpz"))
        bad["zero_optimization"] = dict(bad["zero_optimization"],
                                        zero_hpz_partition_size=3)
        initialize(model=_model(torch.float32, 0), config=bad, device="cpu")
        out["hpz3"] = "accepted"
    except ValueError as e:
        out["hpz3"] = str(e)
    finally:
        groups.reset_mesh()
    return out


def _load_hpz_save(rank: int, world: int, save_dir: str,
                   resave_dir: str) -> Dict[str, Any]:
    """A plain stage-3 engine on two ranks loads hpZ's four-rank save (the
    four-rank launch runs beside this one: wait for its ``latest``) and
    saves it again (its files must hold the same state)."""
    deadline = time.monotonic() + LOAD_WAIT_S
    while not os.path.exists(os.path.join(save_dir, "latest")):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint under {save_dir}")
        time.sleep(0.5)
    try:
        engine, *_ = initialize(model=_model(torch.float32, 7 + rank),
                                config=dict(BASE, zero_optimization={
                                    "stage": 3,
                                    "stage3_param_persistence_threshold":
                                    THRESHOLD}), device="cpu")
        engine.load_checkpoint(save_dir)
        engine.save_checkpoint(resave_dir, tag="resaved")
        return {"loaded": _gathered(engine.module),
                "count": engine.optimizer.count}
    finally:
        groups.reset_mesh()


def zeropp_rank(rank: int, weights: Dict[str, np.ndarray],
                arrays: Dict[str, np.ndarray], save_dir: str,
                resave_dir: str) -> Dict[str, Any]:
    """Every body of this rank count."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    out: Dict[str, Any] = {"functions": _functions(arrays, rank),
                           "weights": _compute_weights(rank, weights)}
    for name, (w, _, _, _) in CASES.items():
        if w == world:
            out[name] = _run_case(rank, world, name, weights)
    if world == 4:
        out["ckpt"] = _hpz_checkpoint(rank, world, weights, save_dir)
    else:
        out["reshard"] = _load_hpz_save(rank, world, save_dir, resave_dir)
    return out


__all__ = ["CASES", "CKPT_STEPS", "OVERFLOW_NORM", "QWZ_THRESHOLD", "STEPS",
           "case_config", "case_dtype", "global_batches", "zeropp_rank"]
