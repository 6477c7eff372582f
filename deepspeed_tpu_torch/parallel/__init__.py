"""Parallel layouts of the PyTorch port (counterpart of
``deepspeed_tpu/parallel``): the mesh axes and rank arithmetic."""

from .mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_PIPE, AXIS_SEQ, AXIS_TENSOR,
                   DP_AXES, MESH_AXIS_ORDER, MeshLayout, ProcessMesh,
                   ProcessTopology)

__all__ = ["AXIS_DATA", "AXIS_EXPERT", "AXIS_PIPE", "AXIS_SEQ",
           "AXIS_TENSOR", "DP_AXES", "MESH_AXIS_ORDER", "MeshLayout",
           "ProcessMesh", "ProcessTopology"]
