"""``initialize``: a model and a ds_config to a training engine.

Counterpart of ``deepspeed_tpu/runtime/entry.py`` (``initialize``
101-167): join the process group, take the data-parallel group from a
``mesh=`` or ``mpu=`` or build the mesh from the world, resolve the batch
sizes over the data-parallel ranks, make every rank hold rank 0's
parameters, and build the engine (one data-parallel rank under
``zero_optimization.stage``) and, from ``training_data``, this rank's
dataloader (with the seqlen curriculum when the config enables one).  The
JAX entry also builds the telemetry, tuning and resilience planes; none
of those is ported yet, so their config groups are accepted without
effect (``runtime/config.py``) and a client optimizer raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..comm import comm
from ..parallel.mesh import AXIS_PIPE, AXIS_SEQ, AXIS_TENSOR, DP_AXES
from ..utils.device import DeviceLike, resolve_device
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader
from .engine import DeepSpeedEngine
from .lr_schedules import LRScheduler
from .optimizers import Optimizer
from .zero.sharder import placement_of

ConfigLike = Union[str, os.PathLike, Dict[str, Any], DeepSpeedConfig]


def _data_parallel(mesh: Any, mpu: Any) -> Tuple[Any, int, Dict[str, int]]:
    """(the data-parallel group or None, its size, the other parallel
    sizes) from ``mesh`` (its ``DP_AXES``), else ``mpu``, else the world
    (a mesh of data-parallel ranks built over it)."""
    from ..parallel.mesh import MeshLayout
    from ..utils import groups

    world = comm.get_world_size() if comm.is_initialized() else 1
    if mesh is None and mpu is None and world > 1:
        mesh = groups.initialize_mesh(MeshLayout.infer(world))
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        dp = 1
        for axis in DP_AXES:
            dp *= int(shape.get(axis, 1))
        others = {a: int(shape.get(a, 1))
                  for a in (AXIS_TENSOR, AXIS_PIPE, AXIS_SEQ)}
        what = f"the mesh's data axes ({dp})"
        group = (lambda: mesh.group(*DP_AXES)) if dp > 1 else None
    elif mpu is not None:
        dp = int(mpu.get_data_parallel_world_size())
        others = {}
        what = f"the mpu's data-parallel world ({dp})"
        group = mpu.get_data_parallel_group if dp > 1 else None
    else:
        return None, 1, {}
    if dp > world:
        raise ValueError(f"{what} asks for more ranks than the process "
                         f"group holds ({world}): launch {dp} ranks and "
                         "join them (init_distributed) first")
    if group is None:
        return None, dp, others
    return group() or dist.group.WORLD, dp, others


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, distributed_port: Any = None,
               mpu: Any = None, dist_init_required: Optional[bool] = None,
               collate_fn: Any = None, config: Optional[ConfigLike] = None,
               config_params: Optional[ConfigLike] = None, mesh: Any = None,
               device: DeviceLike = "cuda"
               ) -> Tuple[DeepSpeedEngine, Optimizer, Any, LRScheduler]:
    """``(engine, optimizer, dataloader, lr_scheduler)``, as the reference
    returns them (the dataloader None without ``training_data``).

    ``model`` is an ``nn.Module`` with ``.loss(batch)`` (its trainable
    parameters are the fp32 masters, unless ``model_parameters`` names
    them) or a callable ``batch -> loss`` with ``model_parameters``.
    ``config`` (or ``config_params``) is a dict, a JSON path or a
    :class:`DeepSpeedConfig`.  ``lr_scheduler`` may be a callable ``step ->
    lr`` that overrides the config's scheduler.  ``device`` defaults to
    ``"cuda"`` and raises without a card.

    Data parallelism: unless ``dist_init_required`` is False, the process
    joins the world its launcher's environment describes (``WORLD_SIZE``
    above 1; always with ``dist_init_required=True``).  The data-parallel
    group is a ``mesh``'s (``utils.groups.initialize_mesh``) data axes, an
    ``mpu``'s ``get_data_parallel_group()``, or the whole world; each rank
    then feeds ``train_step`` its own ``micro x gas`` rows, and
    ``train_batch_size`` counts every rank's.  Rank 0's parameters are
    broadcast to the group first, so ranks that built the model from
    different seeds train one model.  A mixture-of-experts model on more
    than one data-parallel rank raises "not ported yet" (expert
    parallelism).

    ``training_data`` (an indexable of samples) gives a
    :class:`~.dataloader.DeepSpeedDataLoader` of ``train_batch_size``
    samples a step, shuffled with the config's ``seed``, that yields this
    rank's rows (collated by ``collate_fn``; pinned CPU tensors on the
    card); with a curriculum (``curriculum_learning`` or
    ``data_efficiency.data_sampling.curriculum_learning``) it is wrapped by
    the seqlen truncation at the engine's step, and the scheduler is
    ``engine.curriculum_scheduler``.  Accepted without effect: ``args``
    (the argparse namespace) and ``distributed_port`` (the environment's
    ``MASTER_PORT`` is used)."""
    del args, distributed_port
    if optimizer is not None:
        raise NotImplementedError("a client optimizer is not ported yet; "
                                  "name it in the config's optimizer block")
    dev = resolve_device(device)
    spec = config if config is not None else config_params
    if spec is None:
        raise ValueError("initialize needs config= (a dict or a JSON path)")
    cfg = DeepSpeedConfig.load(spec)
    if dist_init_required or (dist_init_required is None and int(
            os.environ.get("WORLD_SIZE", "1")) > 1):
        comm.init_distributed(device=dev)
    dp_group, dp, others = _data_parallel(mesh, mpu)
    tp, pp, sp = (others.get(a, 1) for a in (AXIS_TENSOR, AXIS_PIPE,
                                             AXIS_SEQ))
    cfg.resolve_batch_sizes(world_size=dp * tp * pp * sp, tp=tp, pp=pp,
                            sp=sp)
    cfg.resolve_auto_precision()
    if dp > 1 and not getattr(model, "data_parallel_ported", True):
        raise NotImplementedError(
            f"training {type(model).__name__} on a data axis of {dp} is not "
            "ported yet (expert parallelism, ROADMAP Queue 1 item 5)")

    if callable(getattr(model, "loss", None)):
        loss_fn = model.loss
        if model_parameters is None and isinstance(model, torch.nn.Module):
            model_parameters = model.parameters()
    elif callable(model):
        loss_fn = model
    else:
        raise TypeError("model must be a loss function or an object with "
                        f".loss(); got {type(model)}")
    if model_parameters is None:
        raise ValueError("model_parameters (the fp32 master tensors) is "
                         "required with a bare loss function")
    params = list(model_parameters)
    if dp > 1:
        with torch.no_grad():  # DeepSpeed's _broadcast_model
            for p in params:
                if placement_of(p) is None:  # zero.Init broadcast the rest
                    comm.broadcast(p.data, 0, group=dp_group)
    engine = DeepSpeedEngine(
        loss_fn, params, cfg, module=model, device=dev,
        lr_schedule=lr_scheduler if callable(lr_scheduler) else None,
        dp_group=dp_group)
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data, batch_size=int(cfg.train_batch_size),
            dp_rank=comm.get_rank(dp_group) if dp_group is not None else 0,
            dp_world_size=dp, collate_fn=collate_fn, shuffle=True,
            seed=cfg.seed, pin_memory=dev.type == "cuda")
        curriculum = cfg.curriculum()
        if curriculum:
            from .data_pipeline import (CurriculumDataLoader,
                                        CurriculumScheduler)

            sched = CurriculumScheduler(curriculum)
            engine.curriculum_scheduler = sched
            dataloader = CurriculumDataLoader(dataloader, sched,
                                              lambda: engine.global_steps)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler
