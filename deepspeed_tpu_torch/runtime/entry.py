"""``initialize``: a model and a ds_config to a training engine.

Counterpart of ``deepspeed_tpu/runtime/entry.py`` for one device and ZeRO
stage 0.  The JAX entry builds the mesh, the telemetry, tuning and
resilience planes and the dataloader; none of those is ported yet, so their
config groups are accepted without effect (``runtime/config.py``) and
``training_data`` or a client optimizer raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..utils.device import DeviceLike, resolve_device
from .config import DeepSpeedConfig
from .engine import DeepSpeedEngine
from .lr_schedules import LRScheduler
from .optimizers import Optimizer

ConfigLike = Union[str, os.PathLike, Dict[str, Any], DeepSpeedConfig]


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, config: Optional[ConfigLike] = None,
               config_params: Optional[ConfigLike] = None,
               device: DeviceLike = "cuda", **unused: Any
               ) -> Tuple[DeepSpeedEngine, Optimizer, None, LRScheduler]:
    """``(engine, optimizer, None, lr_scheduler)``, as the reference
    returns them.

    ``model`` is an ``nn.Module`` with ``.loss(batch)`` (its trainable
    parameters are the fp32 masters, unless ``model_parameters`` names
    them) or a callable ``batch -> loss`` with ``model_parameters``.
    ``config`` (or ``config_params``) is a dict, a JSON path or a
    :class:`DeepSpeedConfig`.  ``lr_scheduler`` may be a callable ``step ->
    lr`` that overrides the config's scheduler.  ``device`` defaults to
    ``"cuda"`` and raises without a card."""
    del args, unused  # argparse namespace and the mesh/launcher knobs
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
