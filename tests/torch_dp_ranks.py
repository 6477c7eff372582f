"""Rank bodies of the data-parallel refusal tests
(``test_torch_data_parallel``).

``launcher.local.launch`` runs each in fresh processes, which import this
module by name; it imports no JAX, so a rank starts with PyTorch alone.
Every body joins a gloo process group on the CPU (one thread a rank) and
returns plain values to the test.
"""

import numpy as np
import torch

from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, init_distributed,
                                 initialize)
from deepspeed_tpu_torch.parallel import MeshLayout
from deepspeed_tpu_torch.utils import groups

#: a global batch of 8 in micro-batches of 4: two accumulation steps on one
#: rank, one on each of two
CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
          "steps_per_print": 0,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def tiny_model() -> LlamaModel:
    return LlamaModel(LlamaConfig.tiny(dtype=torch.float32), device="cpu",
                      seed=0)


def batch() -> dict:
    ids = np.random.RandomState(0).randint(0, 512, (8, 16))
    return {"input_ids": torch.from_numpy(ids)}


def train_steps(engine, steps: int = 2) -> list:
    """The losses of ``steps`` train steps on the same batch."""
    return [float(engine.train_step(batch())["loss"]) for _ in range(steps)]


def initialize_rank(rank: int, with_mesh: bool):
    """``initialize`` in a joined world (with the world's data-parallel mesh
    when ``with_mesh``); the refusal's message, or the losses of two steps
    when it trains."""
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    kw = {}
    if with_mesh:
        kw["mesh"] = groups.initialize_mesh(MeshLayout.infer())
    try:
        engine, *_ = initialize(model=tiny_model(), config=CONFIG,
                                device="cpu", **kw)
    except NotImplementedError as e:
        return str(e)
    return train_steps(engine)


__all__ = ["CONFIG", "initialize_rank", "tiny_model", "train_steps"]
