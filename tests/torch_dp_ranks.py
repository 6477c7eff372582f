"""Rank bodies of the data-parallel tests (``test_torch_data_parallel``).

``launcher.local.launch`` runs each in fresh processes, which import this
module by name; it imports no JAX, so a rank starts with PyTorch alone.
Every body joins a gloo process group on the CPU (one thread a rank) and
returns plain values to the test.
"""

import types

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, init_distributed,
                                 initialize)
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups

#: a global batch of 8 in micro-batches of 4: two accumulation steps on one
#: rank, one on each of two
CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
          "steps_per_print": 0,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def tiny_model(seed: int = 0) -> LlamaModel:
    return LlamaModel(LlamaConfig.tiny(dtype=torch.float32), device="cpu",
                      seed=seed)


def batch() -> dict:
    ids = np.random.RandomState(0).randint(0, 512, (8, 16))
    return {"input_ids": torch.from_numpy(ids)}


def train_steps(engine, steps: int = 2, rank: int = 0,
                world: int = 1) -> list:
    """The losses of ``steps`` train steps on the same global batch, of
    which this rank feeds the ``rank``-th of ``world`` blocks of rows."""
    rows = {k: v[rank * 8 // world:(rank + 1) * 8 // world]
            for k, v in batch().items()}
    return [float(engine.train_step(rows)["loss"]) for _ in range(steps)]


def initialize_rank(rank: int, how: str):
    """``initialize`` in a joined world: on the world alone (``"world"``),
    with the world's data-parallel mesh (``"world_and_mesh"``) or with an
    mpu naming the world (``"world_and_mpu"``); every rank builds the model
    from its own seed.  The losses of two steps on this rank's rows."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    kw = {}
    if how == "world_and_mesh":
        kw["mesh"] = groups.initialize_mesh(MeshLayout.infer())
    elif how == "world_and_mpu":
        kw["mpu"] = types.SimpleNamespace(
            get_data_parallel_world_size=dist.get_world_size,
            get_data_parallel_group=lambda: dist.group.WORLD)
    engine, *_ = initialize(model=tiny_model(seed=rank), config=CONFIG,
                            device="cpu", **kw)
    return train_steps(engine, rank=rank, world=dist.get_world_size())


__all__ = ["CONFIG", "initialize_rank", "tiny_model", "train_steps"]
