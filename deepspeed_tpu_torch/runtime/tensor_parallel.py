"""AutoTP's training entry: ``tp_model_init``.

Counterpart of ``deepspeed_tpu/runtime/tensor_parallel.py``
(``tp_model_init`` :77, the reference's ``deepspeed.tp_model_init``).  The
JAX package binds a model to a mesh and lets GSPMD place the weights by
its ``param_specs``; the port runs one process a rank, so binding is the
model's own split: ``shard_`` keeps this rank's block of every weight the
tensor axis cuts (Llama, Mixtral, OPT).  JAX's ``infer_tp_specs`` (the
name policy for a client's modules) is not ported yet (ROADMAP Queue 1
item 5c): a model without ``shard_`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..parallel.mesh import AXIS_TENSOR, MeshLayout
from ..utils import groups
from ..utils.logging import log_dist


def tp_model_init(model: Any = None, tp_size: int = 1,
                  dtype: Optional[torch.dtype] = None, config: Any = None,
                  mesh: Any = None) -> Any:
    """Split ``model`` (built whole) over a ``tp_size``-way ``tensor``
    axis in place and return it.  The mesh is ``mesh``, else the active
    one when its tensor axis is ``tp_size``, else one built over the
    joined process group (``init_distributed`` first).  ``dtype`` replaces
    the model's compute dtype; ``config`` is accepted for the reference's
    call shape."""
    del config
    if mesh is None:
        mesh = groups.current_mesh()
        if mesh is None or int(mesh.shape.get(AXIS_TENSOR, 1)) != tp_size:
            mesh = groups.initialize_mesh(MeshLayout.infer(tp=tp_size))
    if int(mesh.shape[AXIS_TENSOR]) != tp_size:
        raise ValueError(f"tp_size={tp_size}, the mesh's tensor axis is "
                         f"{mesh.shape[AXIS_TENSOR]}")
    if not callable(getattr(model, "shard_", None)):
        raise NotImplementedError(
            f"{type(model).__name__} has no tensor-parallel split; the "
            "name policy for client modules is not ported yet (ROADMAP "
            "Queue 1 item 5c)")
    if tp_size > 1 and model.tp == 1:
        model.shard_(mesh)
    if dtype is not None and dtype != model.config.dtype:
        model.config = dataclasses.replace(model.config, dtype=dtype)
        for layer in getattr(model, "layers", ()):
            if hasattr(layer, "compute_dtype"):
                layer.compute_dtype = dtype
    log_dist(f"tp_model_init: tp={tp_size} mesh={dict(mesh.shape)}")
    return model
