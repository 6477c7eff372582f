"""Rank bodies of the checkpoint tests (``test_torch_checkpoint``).

``launcher.local.launch`` runs these functions in fresh processes that
import this module by name; it imports no JAX.  Each rank joins a gloo
group on the CPU (one thread a rank), trains the tiny Llama of
``torch_zero_ranks`` on its rows of a global batch of :data:`ROWS` rows,
saves or loads checkpoints, and returns plain values: losses, and its
slices of the fp32 masters and Adam's moments with their placements.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, comm,
                                 init_distributed, initialize, zero)
from deepspeed_tpu_torch.runtime.checkpointing import placement_values
from torch_zero_ranks import MODEL, THRESHOLD

#: the global batch: one row a rank at 4 ranks, 2 at 2, 4 in one process
ROWS = 4
#: steps before the first save, and after it
SAVE_AT, AFTER = 3, 2


def config(stage: int, **over) -> Dict[str, Any]:
    return dict({"train_batch_size": ROWS, "steps_per_print": 0,
                 "optimizer": {"type": "AdamW",
                               "params": {"lr": 3e-3, "weight_decay": 0.01}},
                 "zero_optimization": {
                     "stage": stage,
                     "stage3_param_persistence_threshold": THRESHOLD}},
                **over)


def batches(n: int, first: int = 0) -> List[np.ndarray]:
    """The global batches of steps ``first .. first + n - 1``."""
    return [np.random.RandomState(10 + i).randint(0, 512, (ROWS, 16))
            .astype(np.int64) for i in range(first, first + n)]


def model(seed: int, dtype=torch.float32) -> LlamaModel:
    return LlamaModel(LlamaConfig(dtype=dtype, param_dtype=torch.float32,
                                  **MODEL), device="cpu", seed=seed)


def rows(batch: np.ndarray, rank: int, world: int) -> Dict[str, torch.Tensor]:
    n = batch.shape[0] // world
    return {"input_ids": torch.from_numpy(batch[rank * n:(rank + 1) * n])}


def train(engine, rank: int, world: int, n: int, first: int) -> List[float]:
    return [float(engine.train_step(rows(b, rank, world))["loss"])
            for b in batches(n, first)]


def state_slices(engine) -> Dict[str, Any]:
    """Per leaf: its placement on this rank and this rank's slices of the
    master, m and v (numpy), and the step count."""
    opt = engine.optimizer
    out = {"count": opt.count, "leaves": {}}
    for i, (name, pl) in enumerate(zip(engine.param_names,
                                       engine.placements)):
        out["leaves"][name] = {
            "placement": placement_values(pl),
            "master": engine._masters()[i].detach().numpy().copy(),
            "m": opt.m[i].numpy().copy(), "v": opt.v[i].numpy().copy()}
    return out


def save_rank(rank: int, ckpt: str) -> Dict[str, Any]:
    """Two ranks at stage 3: ``SAVE_AT`` steps, save, then ``AFTER``
    steps more (the oracle of every resume)."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    engine, *_ = initialize(model=model(0 if rank == 0 else 100 + rank),
                            config=config(3), device="cpu")
    out: Dict[str, Any] = {"losses": train(engine, rank, world, SAVE_AT, 0)}
    out["tag_dir"] = engine.save_checkpoint(ckpt, client_state={
        "consumed_samples": SAVE_AT * ROWS})
    out["saved"] = state_slices(engine)
    sd16 = engine._zero3_consolidated_16bit_state_dict()
    with zero.GatheredParameters(list(engine.params)):
        out["sd16_equal"] = all(
            torch.equal(sd16[n], p.detach().to(torch.bfloat16))
            for n, p in zip(engine.param_names, engine.params))
    out["losses"] += train(engine, rank, world, AFTER, SAVE_AT)
    return out


class _SubGroupMPU:
    """An mpu whose data-parallel group is ranks 0 and 1 of the world."""

    def __init__(self, group):
        self.group = group

    def get_data_parallel_group(self):
        return self.group

    def get_data_parallel_world_size(self) -> int:
        return 2


def resume_rank(rank: int, ckpt2: str, ckpt4: str) -> Dict[str, Any]:
    """Four ranks at stage 2 load the two-rank stage-3 checkpoint, take
    ``AFTER`` steps and save; then ranks 0 and 1, as a data-parallel group
    of two at stage 1, load that four-rank checkpoint."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    world = comm.get_world_size()
    engine, *_ = initialize(model=model(50 + rank), config=config(2),
                            device="cpu")
    path, client = engine.load_checkpoint(ckpt2)
    out: Dict[str, Any] = {"client": client, "loaded": state_slices(engine),
                           "global_steps": engine.global_steps}
    out["losses"] = train(engine, rank, world, AFTER, SAVE_AT)
    engine.save_checkpoint(ckpt4)
    out["saved"] = state_slices(engine)
    pair = dist.new_group([0, 1])  # every rank joins the call
    back: Optional[Dict[str, Any]] = None
    if rank < 2:
        e2, *_ = initialize(model=model(70 + rank), config=config(1),
                            mpu=_SubGroupMPU(pair), device="cpu")
        e2.load_checkpoint(ckpt4)
        back = state_slices(e2)
        back["dp"] = e2.dp_world_size
    out["back"] = back
    comm.barrier()
    return out


__all__ = ["AFTER", "ROWS", "SAVE_AT", "batches", "config", "model",
           "resume_rank", "rows", "save_rank", "state_slices", "train"]
