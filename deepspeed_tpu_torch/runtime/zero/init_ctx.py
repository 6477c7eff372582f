"""``zero.Init`` and ``zero.GatheredParameters``: build a model already cut
under ZeRO-3, and see or edit its whole weights.

Counterpart of ``deepspeed_tpu/runtime/zero/init_ctx.py`` (the reference's
``zero/partition_parameters.py``).  The JAX ``Init`` compiles the init
function with its outputs born sharded; here a model built inside
:class:`Init` materialises its parameters one at a time: each is drawn
whole on this rank, rank 0's draw is broadcast over the data-parallel
group (so every rank holds the same model whatever its seed, as
``initialize`` makes sure of for a whole model), and only this rank's
chunk of each leaf the stage-3 rule cuts is kept.  Peak memory is one whole
leaf, never the whole model.  The models take part through
:func:`materialize`, which their initialisers call for every weight.

:class:`GatheredParameters` gathers the whole tensors of cut parameters
for the length of a ``with`` block (every rank enters it); with
``modifier_rank`` set, that rank's edits are broadcast and cut again on
exit, otherwise the chunks come back unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Iterable, List, Optional

import torch

from ...comm import comm
from ...parallel.mesh import DP_AXES
from ..config import DeepSpeedConfig, ZeroConfig
from .sharder import Placement, ZeroShardingPolicy, placement_of

_active: List["Init"] = []


def _zero_config(payload: Any) -> ZeroConfig:
    if payload is None:
        return ZeroConfig()
    if isinstance(payload, (str, os.PathLike)):
        with open(payload) as f:
            payload = json.load(f)
    return DeepSpeedConfig.load(payload).zero_optimization


class Init:
    """Models built inside the context are cut under ZeRO-3::

        with zero.Init(config_dict_or_path=ds_config):
            model = LlamaModel(cfg, device="cuda", seed=0)

    Each cut parameter keeps this rank's chunk and its :class:`Placement`
    (``param.ds_placement``); ``initialize`` at stage 3 takes it as it is.
    ``data_parallel_group`` defaults to the mesh's data-parallel group
    (``utils.groups``); the stage is 3 whatever the config says, its
    persistence threshold applies.  ``enabled=False`` builds whole
    models.  A mesh with an ``expert`` axis above 1 raises (its expert
    leaves would need the ``data`` group alone)."""

    def __init__(self, module: Any = None, data_parallel_group: Any = None,
                 mem_efficient_linear: bool = True, remote_device: Any = None,
                 pin_memory: bool = False, config_dict_or_path: Any = None,
                 config: Any = None, enabled: bool = True, dtype: Any = None,
                 mpu: Any = None, mesh: Any = None):
        del module, mem_efficient_linear, remote_device, pin_memory, dtype
        del mpu
        self.enabled = enabled
        zero = _zero_config(config_dict_or_path if config_dict_or_path
                            is not None else config)
        if comm.is_initialized():
            from ...utils import groups
            if mesh is None and data_parallel_group is None:
                mesh = groups.get_mesh()
            layout = getattr(mesh, "layout", None)
            if layout is not None and layout.ep > 1:
                # an expert leaf would be broadcast and cut over the whole
                # data-parallel group, whose ranks hold other experts
                raise NotImplementedError(
                    f"zero.Init on a mesh with an expert axis of {layout.ep} "
                    "is not ported yet (ROADMAP Queue 1 item 5a): build the "
                    "model whole and let initialize cut it at stage 3")
            if data_parallel_group is None:
                data_parallel_group = mesh.group(*DP_AXES)
        self.group = data_parallel_group
        dp = comm.get_world_size(self.group) if comm.is_initialized() else 1
        self.policy = ZeroShardingPolicy(
            stage=3, dp_size=dp,
            persistence_threshold=zero.persistence_threshold)

    def __enter__(self) -> "Init":
        if self.enabled:
            _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            _active.remove(self)

    def keep(self, param: torch.nn.Parameter, full: torch.Tensor) -> None:
        """Make ``param`` rank 0's ``full`` (broadcast over the group), cut
        to this rank's chunk when the rule cuts it."""
        if self.policy.dp_size > 1:
            comm.broadcast(full, 0, group=self.group)
        dim = self.policy.param_dim(tuple(full.shape))
        if dim is None:
            _set_data(param, full)
            return
        place = Placement.of(tuple(full.shape), dim, self.group)
        _set_data(param, place.cut(full))
        param.ds_placement = place


def _set_data(param: torch.nn.Parameter, value: torch.Tensor) -> None:
    """``param.data = value``, also for a parameter on the meta device (whose
    data cannot take another device's tensor: the two are swapped)."""
    if param.device.type != "meta":
        param.data = value
        return
    torch.utils.swap_tensors(param, torch.nn.Parameter(
        value, requires_grad=param.requires_grad))


@torch.no_grad()
def materialize(param: torch.nn.Parameter, device: torch.device,
                fill: Callable[[torch.Tensor], None]) -> None:
    """Write ``param``'s initial value, ``fill`` applied to a whole tensor
    of its shape: in place when it is materialised, else (a parameter on
    the meta device, built inside :class:`Init`) on a new tensor on
    ``device`` that the innermost active ``Init`` keeps (cut) or that
    becomes the parameter's data."""
    if param.device.type != "meta":
        fill(param.data)
        return
    full = torch.empty(param.shape, dtype=param.dtype, device=device)
    fill(full)
    if _active:
        _active[-1].keep(param, full)
    else:
        _set_data(param, full)


def active() -> Optional[Init]:
    """The innermost active :class:`Init` (None outside one)."""
    return _active[-1] if _active else None


class GatheredParameters:
    """``with GatheredParameters(params, modifier_rank=None):`` — inside,
    every parameter cut under ZeRO-3 holds its whole tensor (gathered over
    its group) and reads as an ordinary parameter; on exit each is cut
    again: to the chunk it had (``modifier_rank`` None, read only), or to
    this rank's chunk of ``modifier_rank``'s whole tensor, broadcast.  Every
    rank of the group enters with the same parameters.  Whole parameters
    pass through; ``enabled=False`` does nothing."""

    def __init__(self, params: Any, modifier_rank: Optional[int] = None,
                 fwd_module: Any = None, enabled: bool = True):
        del fwd_module
        if isinstance(params, torch.Tensor):
            params = [params]
        self.params = [p for p in _flatten(params)
                       if placement_of(p) is not None]
        self.modifier_rank = modifier_rank
        self.enabled = enabled
        self._saved: List[Any] = []

    def __enter__(self) -> List[torch.Tensor]:
        if not self.enabled:
            return self.params
        with torch.no_grad():
            for p in self.params:
                place = placement_of(p)
                self._saved.append((p.data, place))
                p.data = place.gather(p.data)
                p.ds_placement = None
        return self.params

    def __exit__(self, exc_type, *exc) -> None:
        if not self.enabled:
            return
        with torch.no_grad():
            for p, (chunk, place) in zip(self.params, self._saved):
                if self.modifier_rank is not None and exc_type is None:
                    full = comm.broadcast(p.data.contiguous(),
                                          self.modifier_rank,
                                          group=place.group)
                    chunk = place.cut(full)
                p.data = chunk
                p.ds_placement = place
        self._saved = []


def _flatten(params: Any) -> Iterable[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    out = []
    for p in params:
        if isinstance(p, torch.nn.Module):
            out.extend(p.parameters())
        else:
            out.append(p)
    return out
