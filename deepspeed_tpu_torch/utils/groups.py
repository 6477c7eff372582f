"""The registry of the active process mesh and its parallel groups.

Counterpart of ``deepspeed_tpu/utils/groups.py`` (the reference's
``deepspeed/utils/groups.py``).  In the JAX package a group is a (mesh,
axis names) pair over one controller's devices; here it is a
``torch.distributed`` group of processes.  :func:`initialize_mesh` builds,
for every axis and for the data-parallel pair (expert, data), one
``dist.new_group`` per rank list of
``ProcessTopology.get_axes_comm_lists``, in the same order on every rank
(``torch.distributed`` requires every rank to enter every ``new_group``),
and keeps the groups that hold this rank on a :class:`ProcessMesh`.
``torch.distributed.device_mesh`` is not used: it assumes one card per
rank, and the port also runs several ranks on one card over gloo.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch.distributed as dist

from ..parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR,
                             DP_AXES, MESH_AXIS_ORDER, MeshLayout,
                             ProcessMesh, ProcessTopology)

_mesh: Optional[ProcessMesh] = None


def _build_group(layout: MeshLayout, axes: Tuple[str, ...]) -> Any:
    """Every rank enters every ``new_group`` of ``axes``; returns the one
    that holds this rank."""
    mine = None
    for ranks in ProcessTopology.from_layout(layout).get_axes_comm_lists(
            axes):
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = group
    return mine


def initialize_mesh(layout: Optional[MeshLayout] = None) -> ProcessMesh:
    """Build the mesh of ``layout`` (default: every rank data-parallel)
    over the joined process group; every rank calls it with the same
    layout."""
    global _mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("initialize_mesh needs the process group: call "
                           "deepspeed_tpu_torch.init_distributed() first")
    layout = layout or MeshLayout.infer()
    if layout.world_size != dist.get_world_size():
        raise ValueError(f"layout {layout.axis_sizes} covers "
                         f"{layout.world_size} ranks, the world has "
                         f"{dist.get_world_size()}")
    groups = {(axis,): _build_group(layout, (axis,))
              for axis in MESH_AXIS_ORDER}
    groups[DP_AXES] = _build_group(layout, DP_AXES)
    _mesh = ProcessMesh(layout, dist.get_rank(), groups)
    return _mesh


def reset_mesh() -> None:
    """Forget the mesh (its groups stay with the process group)."""
    global _mesh
    _mesh = None


def current_mesh() -> Optional[ProcessMesh]:
    """The active mesh, or None when none was built (never builds one)."""
    return _mesh


def get_mesh() -> ProcessMesh:
    """The active mesh, built with the default layout on first use."""
    return _mesh if _mesh is not None else initialize_mesh()


def get_layout() -> MeshLayout:
    return get_mesh().layout


def axes_group(axes: Sequence[str], mesh: Optional[ProcessMesh] = None
               ) -> Any:
    """The group over ``axes`` of ``mesh`` (default: the active mesh) that
    holds this rank, built on first use (every rank must ask for the same
    axes in the same order)."""
    mesh = mesh if mesh is not None else get_mesh()
    axes = tuple(axes)
    if axes not in mesh.groups:
        mesh.groups[axes] = _build_group(mesh.layout, axes)
    return mesh.groups[axes]


def get_tensor_model_parallel_group() -> Any:
    return get_mesh().group(AXIS_TENSOR)


def get_tensor_model_parallel_world_size() -> int:
    return get_layout().tp


def get_tensor_model_parallel_rank() -> int:
    return get_mesh().axis_rank(AXIS_TENSOR)


def get_model_parallel_group() -> Any:
    """The tensor group, as in the JAX package."""
    return get_tensor_model_parallel_group()


def get_data_parallel_group() -> Any:
    return get_mesh().group(*DP_AXES)


def get_data_parallel_world_size() -> int:
    return get_layout().dp_world_size


def get_expert_parallel_group() -> Any:
    """The ranks that hold the other experts of this rank's data replica
    (the ``expert`` axis): the token exchange of the MoE layer runs over
    it."""
    return get_mesh().group(AXIS_EXPERT)


def get_expert_parallel_world_size() -> int:
    return get_layout().ep


def get_expert_parallel_rank() -> int:
    return get_mesh().axis_rank(AXIS_EXPERT)


def get_expert_data_parallel_group() -> Any:
    """The ranks that hold the same experts (the ``data`` axis): an expert
    leaf's gradient is reduced, and its ZeRO chunks cut, over it."""
    return get_mesh().group(AXIS_DATA)


def get_expert_data_parallel_world_size() -> int:
    return get_layout().dp


# The sequence-parallel getters: the names accelerate and HF import.
def get_sequence_parallel_group() -> Any:
    """The ranks that hold the other sequence chunks of this rank's rows
    (the ``seq`` axis)."""
    return get_mesh().group(AXIS_SEQ)


def get_sequence_parallel_world_size() -> int:
    return get_layout().sp


def get_sequence_parallel_rank() -> int:
    return get_mesh().axis_rank(AXIS_SEQ)


_get_sequence_parallel_group = get_sequence_parallel_group
_get_sequence_parallel_world_size = get_sequence_parallel_world_size
_get_sequence_parallel_rank = get_sequence_parallel_rank
