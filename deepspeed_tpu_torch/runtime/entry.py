"""``initialize``: a model and a ds_config to a training engine.

Counterpart of ``deepspeed_tpu/runtime/entry.py`` for one device and ZeRO
stage 0.  The JAX entry builds the mesh, the telemetry, tuning and
resilience planes and the dataloader; none of those is ported yet, so their
config groups are accepted without effect (``runtime/config.py``) and
``training_data``, a client optimizer or more than one data-parallel rank
raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..parallel.mesh import AXIS_DATA
from ..utils.device import DeviceLike, resolve_device
from .config import DeepSpeedConfig
from .engine import DeepSpeedEngine
from .lr_schedules import LRScheduler
from .optimizers import Optimizer

ConfigLike = Union[str, os.PathLike, Dict[str, Any], DeepSpeedConfig]


def _refuse_data_parallel(mesh: Any, mpu: Any) -> None:
    """Raise when the call would train several data-parallel replicas: a
    joined ``torch.distributed`` world of more than one rank, or a mesh
    (its ``data`` axis) or an mpu (``get_data_parallel_world_size()``) of
    more than one data-parallel rank.  Each rank would otherwise step on
    its own batch and never average its gradients with the others."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    shape = getattr(mesh, "shape", None)
    dp = int(shape.get(AXIS_DATA, 1)) if isinstance(shape, Mapping) else 1
    if mpu is not None and hasattr(mpu, "get_data_parallel_world_size"):
        dp = max(dp, int(mpu.get_data_parallel_world_size()))
    for what, n in (("a torch.distributed world", world),
                    ("the mesh's data axis", dp)):
        if n > 1:
            raise NotImplementedError(
                f"data parallelism over {n} ranks is not ported yet ({what} "
                f"of {n}): initialize trains on one device; each rank would "
                "train its own replica without averaging gradients")


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, distributed_port: Any = None,
               mpu: Any = None, dist_init_required: Any = None,
               collate_fn: Any = None, config: Optional[ConfigLike] = None,
               config_params: Optional[ConfigLike] = None, mesh: Any = None,
               device: DeviceLike = "cuda"
               ) -> Tuple[DeepSpeedEngine, Optimizer, None, LRScheduler]:
    """``(engine, optimizer, None, lr_scheduler)``, as the reference
    returns them.

    ``model`` is an ``nn.Module`` with ``.loss(batch)`` (its trainable
    parameters are the fp32 masters, unless ``model_parameters`` names
    them) or a callable ``batch -> loss`` with ``model_parameters``.
    ``config`` (or ``config_params``) is a dict, a JSON path or a
    :class:`DeepSpeedConfig`.  ``lr_scheduler`` may be a callable ``step ->
    lr`` that overrides the config's scheduler.  ``device`` defaults to
    ``"cuda"`` and raises without a card.

    Training runs on one device: data parallelism is not ported yet, so a
    joined ``torch.distributed`` world of more than one rank, or a ``mesh``
    (``mpu``) whose data axis is larger than 1, raises
    ``NotImplementedError``.  Accepted without effect: ``args`` (the
    argparse namespace), ``distributed_port`` and ``dist_init_required``
    (this entry joins no process group), ``collate_fn`` (there is no
    dataloader: ``training_data`` raises), and a ``mesh`` or ``mpu`` of one
    data-parallel rank."""
    del args, distributed_port, dist_init_required, collate_fn
    _refuse_data_parallel(mesh, mpu)
    if training_data is not None:
        raise NotImplementedError("training_data: the dataloader is not "
                                  "ported yet; pass batches to train_step")
    if optimizer is not None:
        raise NotImplementedError("a client optimizer is not ported yet; "
                                  "name it in the config's optimizer block")
    dev = resolve_device(device)
    spec = config if config is not None else config_params
    if spec is None:
        raise ValueError("initialize needs config= (a dict or a JSON path)")
    cfg = DeepSpeedConfig.load(spec)
    cfg.resolve_batch_sizes(world_size=1)
    cfg.resolve_auto_precision()

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
    engine = DeepSpeedEngine(
        loss_fn, list(model_parameters), cfg, module=model, device=dev,
        lr_schedule=lr_scheduler if callable(lr_scheduler) else None)
    return engine, engine.optimizer, None, engine.lr_scheduler
