"""The parallel layout: named axes, their sizes, and rank arithmetic.

Counterpart of ``deepspeed_tpu/parallel/mesh.py`` (its pure-Python part,
copied here: the port imports nothing of the JAX package).  The JAX package
builds one ``jax.sharding.Mesh`` over the devices of a single controller;
the port runs one process per rank (the reference DeepSpeed's model), so
its mesh is :class:`ProcessMesh`: the layout, this process's rank and the
``torch.distributed`` group of each axis, built by
:func:`deepspeed_tpu_torch.utils.groups.initialize_mesh`.

Axis layout (outer → inner; ranks that differ only in ``tensor`` are
neighbours, so a tensor group is a block of consecutive ranks):

    pipe    pipeline-parallel stages
    expert  expert-parallel factor of DP
    data    pure data-parallel replicas
    seq     sequence (context) parallel
    tensor  tensor-model parallel
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"

#: outer → inner; tensor innermost (the most-communicating axis)
MESH_AXIS_ORDER: Tuple[str, ...] = (AXIS_PIPE, AXIS_EXPERT, AXIS_DATA,
                                    AXIS_SEQ, AXIS_TENSOR)

#: axes that together form the data-parallel world (ZeRO's shard axes)
DP_AXES: Tuple[str, ...] = (AXIS_EXPERT, AXIS_DATA)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Sizes of every parallel dimension; ``dp`` is the pure-data factor."""

    pp: int = 1
    ep: int = 1
    dp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def world_size(self) -> int:
        return self.pp * self.ep * self.dp * self.sp * self.tp

    @property
    def dp_world_size(self) -> int:
        """What ZeRO partitions over (= ep × dp)."""
        return self.ep * self.dp

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {AXIS_PIPE: self.pp, AXIS_EXPERT: self.ep, AXIS_DATA: self.dp,
                AXIS_SEQ: self.sp, AXIS_TENSOR: self.tp}

    @classmethod
    def infer(cls, world_size: Optional[int] = None, *, tp: int = 1,
              pp: int = 1, sp: int = 1, ep: int = 1,
              dp: Optional[int] = None) -> "MeshLayout":
        """Fill in ``dp`` so the product matches ``world_size``: by default
        the ``torch.distributed`` world (1 when no process group is up)."""
        if world_size is None:
            import torch.distributed as dist
            world_size = (dist.get_world_size() if dist.is_available()
                          and dist.is_initialized() else 1)
        denom = tp * pp * sp * ep
        if dp is None:
            if world_size % denom:
                raise ValueError(f"world_size={world_size} not divisible by "
                                 f"tp*pp*sp*ep={denom}")
            dp = world_size // denom
        layout = cls(pp=pp, ep=ep, dp=dp, sp=sp, tp=tp)
        if layout.world_size != world_size:
            raise ValueError(f"mesh {layout.axis_sizes} has size "
                             f"{layout.world_size}, need {world_size}")
        return layout


class ProcessTopology:
    """Coordinate ↔ rank bookkeeping over named axes (the reference's
    ``deepspeed/runtime/pipe/topology.py:ProcessTopology``): the last axis
    varies fastest."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        self.axes = list(axes)
        self.dims = list(dims)

    @classmethod
    def from_layout(cls, layout: MeshLayout) -> "ProcessTopology":
        return cls(list(MESH_AXIS_ORDER),
                   [layout.axis_sizes[a] for a in MESH_AXIS_ORDER])

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)]

    def get_rank(self, **coords: int) -> int:
        missing = set(self.axes) - set(coords)
        if missing:
            raise ValueError(f"missing coordinates for axes {sorted(missing)}")
        rank = 0
        for axis, dim in zip(self.axes, self.dims):
            c = coords[axis]
            if not 0 <= c < dim:
                raise ValueError(f"coord {axis}={c} out of range [0,{dim})")
            rank = rank * dim + c
        return rank

    def get_coord(self, rank: int) -> Dict[str, int]:
        coords: Dict[str, int] = {}
        for axis, dim in zip(reversed(self.axes), reversed(self.dims)):
            coords[axis] = rank % dim
            rank //= dim
        return {a: coords[a] for a in self.axes}

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """All rank groups that vary only along ``axis`` (e.g. every TP
        group)."""
        return self.get_axes_comm_lists((axis,))

    def get_axes_comm_lists(self, axes: Sequence[str]) -> List[List[int]]:
        """All rank groups that vary only along ``axes`` (the first named
        varies slowest within a group)."""
        other_axes = [a for a in self.axes if a not in axes]
        lists = []
        for other in itertools.product(*(range(self.get_dim(a))
                                         for a in other_axes)):
            fixed = dict(zip(other_axes, other))
            lists.append([self.get_rank(**fixed, **dict(zip(axes, inner)))
                          for inner in itertools.product(
                              *(range(self.get_dim(a)) for a in axes))])
        return lists


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a layout: the port's counterpart of a
    ``jax.sharding.Mesh``.  ``groups`` maps a tuple of axes to the
    ``torch.distributed`` group of the ranks that share this rank's
    coordinates on every other axis."""

    layout: MeshLayout
    rank: int
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return self.layout.axis_sizes

    @property
    def coords(self) -> Dict[str, int]:
        return ProcessTopology.from_layout(self.layout).get_coord(self.rank)

    def axis_rank(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return self.coords[axis]

    def group(self, *axes: str) -> Any:
        """The process group over ``axes`` that holds this rank."""
        try:
            return self.groups[tuple(axes)]
        except KeyError:
            raise KeyError(f"no process group over {axes}; built: "
                           f"{sorted(self.groups)}") from None
