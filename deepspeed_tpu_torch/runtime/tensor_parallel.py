"""AutoTP: ``tp_model_init`` and the name policy for client modules.

Counterpart of ``deepspeed_tpu/runtime/tensor_parallel.py``
(``infer_tp_specs`` :39, ``tp_model_init`` :77, the reference's
``deepspeed.tp_model_init`` and ``module_inject/auto_tp``).  The JAX
package binds a model to a mesh and lets GSPMD place the weights by its
``param_specs``, or, for a model without them, by the specs
``infer_tp_specs`` reads off the leaf names; GSPMD keeps the client's
computation whole whatever the placement.  The port runs one process a
rank, so binding is a split of the model itself:

* a model of the port keeps its own split, ``shard_`` (Llama, Mixtral,
  OPT, BERT; ResNet holds every leaf whole);
* any other module goes through :func:`auto_tp`: the same name policy
  (:func:`infer_tp_specs`, JAX's ``_COLUMN_PAT`` / ``_ROW_PAT``) picks its
  ``nn.Linear`` layers, a column name becomes a
  :class:`ColumnParallelLinear` (Megatron's *f* on the input, this rank's
  block of the output rows) and a row name a :class:`RowParallelLinear`
  (this rank's block of the input columns, *g* on the output, the bias
  added once after it), and every split leaf carries ``ds_tensor``, so the
  engine's norm, ZeRO and checkpoints treat it as a split leaf of the
  port's models.

Because a torch client reshapes by its own head counts, :func:`auto_tp`
divides them (``num_heads``, ``num_attention_heads``,
``num_key_value_heads``, ``all_head_size``) on each module whose q, k or v
projection it splits, as the reference's AutoTP does.  A column layer
whose parent holds no row layer (``lm_head``) all-gathers its output
(``comm.tp_gather``), and a row layer whose parent holds no column layer
takes its block of a whole input (``comm.tp_split``): the client then
reads whole tensors everywhere outside a split pair.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import comm
from ..parallel.mesh import AXIS_TENSOR, MeshLayout
from ..utils import groups
from ..utils.logging import log_dist
from .zero.sharder import TensorShard, compute_weight

# AutoTP name policy (copied from the JAX package, which took it from the
# reference's ``module_inject/auto_tp.py``): COLUMN-split linears (output
# dim sharded): attention q/k/v and the MLP up/gate family; ROW-split
# (input dim sharded): attention output and the MLP down family.
_COLUMN_PAT = re.compile(
    r"(^|[._])(wq|wk|wv|q_proj|k_proj|v_proj|query|key|value|qkv"
    r"|w_gate|w_up|gate_proj|up_proj|w_in|wi|fc1|intermediate"
    r"|dense_h_to_4h|lm_head)($|[._])")
_ROW_PAT = re.compile(
    r"(^|[._])(wo|o_proj|out_proj|w_down|down_proj|w_out|wo_proj|fc2"
    r"|dense_4h_to_h|attention_output)($|[._])")

#: the projections whose output holds the attention heads
_QKV = frozenset(("wq", "wk", "wv", "q_proj", "k_proj", "v_proj", "query",
                  "key", "value", "qkv"))
#: a client module's head counts that AutoTP divides by ``tp``
_HEAD_ATTRS = ("num_heads", "num_attention_heads", "num_key_value_heads",
              "all_head_size")


def infer_tp_specs(named_parameters: Iterable[Tuple[str, Any]]
                   ) -> Dict[str, Optional[int]]:
    """The name policy for a client's leaves: each leaf's split dim, or
    None for a leaf every tensor rank holds whole.

    JAX's ``infer_tp_specs`` on torch's layout: a JAX matmul leaf is
    ``[..., in, out]``, an ``nn.Linear`` weight ``[..., out, in]``, so a
    column name splits dim ``ndim - 2`` (the output rows) and a row name
    dim ``ndim - 1`` (the input columns).  JAX's head-dim leaves keep their
    rule for three or more dims, transposed the same way: ``wq`` / ``wk``
    / ``wv`` ``[..., heads, hd, H]`` split dim ``ndim - 3``, ``wo`` ``[...,
    H, heads, hd]`` dim ``ndim - 2``.  A leaf of fewer than two dims (a
    bias, a norm) is whole here, as in JAX; :func:`auto_tp` splits a
    column layer's bias with its rows."""
    out: Dict[str, Optional[int]] = {}
    for name, p in named_parameters:
        ndim = len(getattr(p, "shape", ()))
        low = name.lower()
        last = low.rsplit(".", 1)[-1]
        dim = None
        if ndim >= 2:
            if _COLUMN_PAT.search(low):
                dim = ndim - 3 if last in ("wq", "wk", "wv") and ndim >= 3 \
                    else ndim - 2
            elif _ROW_PAT.search(low):
                dim = ndim - 2 if last == "wo" and ndim >= 3 else ndim - 1
        out[name] = dim
    return out


def _split_(p: nn.Parameter, dim: int, tp: int, rank: int) -> None:
    """Keep block ``rank`` of ``tp`` of ``p`` along ``dim``, in place (the
    same Parameter object: optimizers and parameter lists built before stay
    valid), and mark it ``ds_tensor``."""
    n = p.shape[dim] // tp
    with torch.no_grad():
        p.data = p.data.narrow(dim, rank * n, n).clone()
    p.ds_tensor = TensorShard(dim, tp, rank)


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` split by its output rows: Megatron's *f* on the
    input, this rank's ``out/tp`` rows of the weight and the bias, and,
    with ``gather_output``, the ranks' outputs all-gathered."""

    def __init__(self, lin: nn.Linear, group: Any, tp: int, rank: int,
                 gather_output: bool):
        super().__init__()
        _split_(lin.weight, 0, tp, rank)
        if lin.bias is not None:
            _split_(lin.bias, 0, tp, rank)
        self.weight, self.bias = lin.weight, lin.bias
        self.in_features = lin.in_features
        self.out_features = lin.out_features // tp
        self.group, self.gather_output = group, gather_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = compute_weight(self.weight, self.weight.dtype)
        b = (None if self.bias is None
             else compute_weight(self.bias, self.bias.dtype))
        y = F.linear(comm.tp_copy(x, self.group), w, b)
        return comm.tp_gather(y, self.group) if self.gather_output else y


class RowParallelLinear(nn.Module):
    """An ``nn.Linear`` split by its input columns: this rank's ``in/tp``
    columns (of a whole input first, with ``split_input``), the ranks'
    partial outputs summed by Megatron's *g*, the bias (whole) added once
    after the sum."""

    def __init__(self, lin: nn.Linear, group: Any, tp: int, rank: int,
                 split_input: bool):
        super().__init__()
        _split_(lin.weight, 1, tp, rank)
        self.weight, self.bias = lin.weight, lin.bias
        self.in_features = lin.in_features // tp
        self.out_features = lin.out_features
        self.group, self.split_input = group, split_input

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split_input:
            x = comm.tp_split(x, self.group)
        w = compute_weight(self.weight, self.weight.dtype)
        y = comm.tp_reduce(F.linear(x, w), self.group)
        if self.bias is None:
            return y
        return y + compute_weight(self.bias, self.bias.dtype)


def _head_counts(module: nn.Module, name: str, tp: int) -> Dict[str, int]:
    """The head counts of ``module`` divided by ``tp``; raises, naming the
    module, when one does not divide."""
    out = {}
    for attr in _HEAD_ATTRS:
        v = getattr(module, attr, None)
        if isinstance(v, int) and not isinstance(v, bool):
            if v % tp:
                raise ValueError(
                    f"AutoTP: {name or type(module).__name__}.{attr} = {v} "
                    f"does not split over tp={tp}")
            out[attr] = v // tp
    return out


def auto_tp(module: nn.Module, mesh: Any) -> nn.Module:
    """Split a client module over ``mesh``'s ``tensor`` axis in place by
    the name policy (:func:`infer_tp_specs` on each ``nn.Linear``'s
    qualified weight name) and return it; sets ``tp``, ``tp_rank`` and
    ``mesh`` on it.  A linear whose weight another module shares (a tied
    head) stays whole.  Raises, naming the module, when a split or a head
    count does not divide (before anything is split)."""
    tp = int(mesh.shape.get(AXIS_TENSOR, 1))
    if tp == 1:
        return module
    if getattr(module, "tp", 1) != 1:
        raise ValueError(f"the module is already split over "
                         f"{module.tp} tensor ranks")
    rank = mesh.axis_rank(AXIS_TENSOR)
    group = mesh.group(AXIS_TENSOR)
    uses: Dict[int, int] = {}
    for _, p in module.named_parameters(remove_duplicate=False):
        uses[id(p)] = uses.get(id(p), 0) + 1
    kinds: Dict[str, str] = {}
    for qn, lin in module.named_modules():
        if type(lin) is not nn.Linear or uses[id(lin.weight)] > 1:
            continue
        dim = infer_tp_specs([(f"{qn}.weight", lin.weight)])[
            f"{qn}.weight"]
        if dim is not None:
            kinds[qn] = "column" if dim == 0 else "row"
            if lin.weight.shape[dim] % tp:
                raise ValueError(
                    f"AutoTP: {qn}.weight {tuple(lin.weight.shape)} does "
                    f"not split over tp={tp} along dim {dim}")

    def parent_of(qn: str) -> str:
        return qn.rpartition(".")[0]

    def has(parent: str, kind: str) -> bool:
        return any(parent_of(q) == parent and k == kind
                   for q, k in kinds.items())

    heads = {}  # the modules whose q, k or v output stays split
    for qn, kind in kinds.items():
        parent = parent_of(qn)
        if kind == "column" and qn.rpartition(".")[2] in _QKV and \
                has(parent, "row") and parent not in heads:
            heads[parent] = _head_counts(module.get_submodule(parent),
                                         parent, tp)
    for qn, kind in kinds.items():
        parent_name, _, attr = qn.rpartition(".")
        parent = module.get_submodule(parent_name)
        lin = getattr(parent, attr)
        if kind == "column":
            new = ColumnParallelLinear(
                lin, group, tp, rank,
                gather_output=not has(parent_name, "row"))
        else:
            new = RowParallelLinear(
                lin, group, tp, rank,
                split_input=not has(parent_name, "column"))
        setattr(parent, attr, new)
    for parent_name, counts in heads.items():
        for attr, v in counts.items():
            setattr(module.get_submodule(parent_name), attr, v)
    module.tp, module.tp_rank, module.mesh = tp, rank, mesh
    n_col = sum(k == "column" for k in kinds.values())
    log_dist(f"AutoTP: {n_col} column- and {len(kinds) - n_col} "
             f"row-parallel linears over tp={tp}")
    return module


def split_model_(model: Any, mesh: Any) -> Any:
    """A whole model split over ``mesh``'s tensor axis: its own ``shard_``
    when it has one, else :func:`auto_tp` (an ``nn.Module``; a bare loss
    function has no layers to split)."""
    if callable(getattr(model, "shard_", None)):
        return model.shard_(mesh)
    if not isinstance(model, nn.Module):
        raise ValueError(
            "tensor parallelism splits an nn.Module (its own shard_, or "
            "AutoTP over its nn.Linear layers); a bare loss function has "
            f"no layers to split (got {type(model).__name__})")
    return auto_tp(model, mesh)


def tp_model_init(model: Any = None, tp_size: int = 1,
                  dtype: Optional[torch.dtype] = None, config: Any = None,
                  mesh: Any = None) -> Any:
    """Split ``model`` (built whole) over a ``tp_size``-way ``tensor``
    axis in place and return it: its own ``shard_``, or :func:`auto_tp`
    for a client module.  The mesh is ``mesh``, else the active one when
    its tensor axis is ``tp_size``, else one built over the joined process
    group (``init_distributed`` first).  ``dtype`` replaces the compute
    dtype of a model of the port; ``config`` is accepted for the
    reference's call shape."""
    del config
    if mesh is None:
        mesh = groups.current_mesh()
        if mesh is None or int(mesh.shape.get(AXIS_TENSOR, 1)) != tp_size:
            mesh = groups.initialize_mesh(MeshLayout.infer(tp=tp_size))
    if int(mesh.shape[AXIS_TENSOR]) != tp_size:
        raise ValueError(f"tp_size={tp_size}, the mesh's tensor axis is "
                         f"{mesh.shape[AXIS_TENSOR]}")
    if tp_size > 1 and getattr(model, "tp", 1) == 1:
        split_model_(model, mesh)
    cfg = getattr(model, "config", None)
    if dtype is not None and dataclasses.is_dataclass(cfg) and \
            getattr(cfg, "dtype", dtype) != dtype:
        model.config = dataclasses.replace(cfg, dtype=dtype)
        for layer in getattr(model, "layers", ()):
            if hasattr(layer, "compute_dtype"):
                layer.compute_dtype = dtype
    log_dist(f"tp_model_init: tp={tp_size} mesh={dict(mesh.shape)}")
    return model
