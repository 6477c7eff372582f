"""Checkpoint save and load of the engine's sharded training state.

Counterpart of ``deepspeed_tpu/runtime/checkpointing.py``.  The JAX engine
writes one orbax tree whose arrays orbax reshards on load; the port runs
one process a data-parallel rank, so each rank writes its own file and a
load assembles each tensor it holds from the files' slices.

Layout of ``<save_dir>/<tag>/`` (default tag ``global_step{N}``):

    dp_rank_{r:05d}.pt   rank r's state: per leaf its placement as plain
                         values (``dim``, ``dp``, ``rank``, ``full_shape``;
                         None when whole; an expert stack's also
                         ``expert``: its block of the experts), and
                         tensors: of a cut leaf this rank's chunk of the
                         fp32 master and of each optimizer state (m and v
                         of Adam), of a whole leaf all of them, written by
                         rank 0 of the group that reduces it only; the
                         optimizer's type and step count, the loss
                         scaler's state and the skipped steps
    client_state.json    the JAX meta's keys: global_steps, micro_steps,
                         lr_scheduler, client_state, ds_config_stage, ...
    ds_manifest.json     each file's size and sha256

and ``<save_dir>/zero_to_fp32.py``, then ``<save_dir>/latest`` (the tag),
written last: after every rank's file and the manifest are on disk (behind
a barrier over the ranks, after the async engine's ``wait()``).

Under tensor parallelism each tensor rank writes its own files,
``dp_rank_{r:05d}_tp_rank_{t:02d}.pt`` (``t`` its tensor coordinate,
recorded in the file with the tensor size): a leaf the model splits over
``tensor`` carries its ``tensor`` block (``dim``, ``tp``, ``rank``) in its
placement, composed with the ZeRO chunk as an expert stack's block is, and
a leaf every tensor rank holds whole is written by tensor rank 0 alone.  A
load assembles any tensor size's slices into any other's: a tp-2 save
loads at tp 1 (whole leaves) and a tp-1 save at tp 2 (each rank's block).

Under sequence parallelism the ``seq`` ranks of one data-parallel
coordinate hold the same state: only ``seq`` rank 0 writes the rank file
(named by the rank in the data-parallel group), the others wait at the
commit's barriers (over the data axes and ``seq``), and every rank loads.

A load reads each file memory-mapped and copies into every tensor this
rank holds (the whole master at stages 0-2, the chunk at stage 3; the
optimizer states' chunks of cut leaves) the parts of the saved slices that
overlap it: any stage and any number of ranks load what any other saved.
Names and shapes are checked first; a mismatch raises naming the leaf and
nothing is written.  An expert stack's ``full_shape`` counts every expert:
its box is this expert coordinate's block of dim 0 composed with its ZeRO
chunk over the ``data`` group, so each rank writes its own experts and a
save at one expert-parallel size loads at another.

ZeRO-Offload (JAX save :112-135, load :244-298): the masters and moments
of a rank file are the host optimizer's, under the leaves' names, so a run
saved with offload loads into an engine without it and the reverse (the
Adam family's state is ``m`` and ``v`` either way); a load fills the host
state and the card's parameters from the same slices.  ZeRO-Infinity
writes the resident leaves in the rank file and the trunk one layer at a
time, ``infinity_layer_{i:05d}.pt`` beside it (a layer's fp32 masters, m
and v under the model's names; ``infinity_layer_{i:05d}_tp_rank_{t:02d}
.pt`` under tensor parallelism, a tensor rank's blocks with their
placement), so a save never holds more than one
layer's state beyond the tier's own; a load reads the layer files
memory-mapped with the rank files (any engine, and ``zero_to_fp32``, sees
every leaf) and installs each layer into the swapper.  A universal
directory loads into both (the host masters and moments; the trunk layer
by layer).
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import shutil
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm import comm
from ..utils.logging import log_dist, logger
from .zero.sharder import placement_of
from .checkpoint_engine import (SIDECAR_MANIFEST, CheckpointCorruptionError,
                                CheckpointEngine, join_inflight_save,
                                verify_sidecar_manifest,
                                write_sidecar_manifest)

LATEST_FILE = "latest"
META_FILE = "client_state.json"
RANK_FILE = "dp_rank_{:05d}.pt"
#: a rank file under tensor parallelism: (data-parallel rank, tensor rank)
TP_RANK_FILE = "dp_rank_{:05d}_tp_rank_{:02d}.pt"
LAYER_FILE = "infinity_layer_{:05d}.pt"
#: a streamed layer's file under tensor parallelism: (layer, tensor rank)
TP_LAYER_FILE = "infinity_layer_{:05d}_tp_rank_{:02d}.pt"
FORMAT_VERSION = 1

#: a tensor's region in its leaf's full index space: (start, stop) per dim
Box = Tuple[Tuple[int, int], ...]


# -- the layout -----------------------------------------------------------

def placement_values(pl: Any, expert: Any = None, tensor: Any = None
                     ) -> Optional[Dict[str, Any]]:
    """A ``Placement`` (and an expert stack's ``ExpertShard``, a tensor
    split leaf's ``TensorShard``) as plain values (never a process group);
    None for a whole leaf."""
    if pl is None and expert is None and tensor is None:
        return None
    out: Dict[str, Any] = {"dim": None, "dp": 1, "rank": 0}
    if pl is not None:
        out = {"dim": int(pl.dim), "dp": int(pl.dp), "rank": int(pl.rank),
               "full_shape": [int(d) for d in pl.full_shape]}
    if expert is not None:
        out["expert"] = {"ep": int(expert.ep), "rank": int(expert.rank)}
    if tensor is not None:
        out["tensor"] = {"dim": int(tensor.dim), "tp": int(tensor.tp),
                         "rank": int(tensor.rank)}
    return out


def box_of(full_shape: Sequence[int],
           placement: Optional[Dict[str, Any]]) -> Box:
    """The region a tensor holds: all of the leaf, or chunk ``rank`` of
    ``dp`` along ``dim``, within an expert stack's block ``rank`` of
    ``ep`` along dim 0 and a tensor split leaf's block ``rank`` of ``tp``
    along its ``dim``."""
    box = [(0, int(d)) for d in full_shape]
    if placement is None:
        return tuple(box)
    expert = placement.get("expert")
    if expert is not None:
        n = box[0][1] // expert["ep"]
        box[0] = (expert["rank"] * n, (expert["rank"] + 1) * n)
    tensor = placement.get("tensor")
    if tensor is not None:
        td = tensor["dim"]
        lo, hi = box[td]
        n = (hi - lo) // tensor["tp"]
        box[td] = (lo + tensor["rank"] * n, lo + (tensor["rank"] + 1) * n)
    d = placement["dim"]
    if d is not None:
        lo, hi = box[d]
        n = (hi - lo) // placement["dp"]
        box[d] = (lo + placement["rank"] * n, lo + (placement["rank"] + 1) * n)
    return tuple(box)


def leaf_shape(engine, i: int) -> Tuple[int, ...]:
    """Parameter ``i``'s whole shape (every expert of an expert stack,
    every tensor rank's block of a split leaf)."""
    pl, p, shard = engine.placements[i], engine.params[i], \
        engine._experts[i]
    local = tuple(pl.full_shape) if pl is not None else tuple(p.shape)
    tensor = engine._tensor[i]
    if tensor is not None:
        local = tensor.full_shape(local)
    return shard.full_shape(local) if shard is not None else local


@torch.no_grad()
def fill(dst: torch.Tensor, dst_box: Box,
         pieces: Sequence[Tuple[torch.Tensor, Box]], what: str) -> None:
    """Copy into ``dst`` (holding ``dst_box``) the overlap of every piece
    (a tensor holding its box); raises unless the pieces cover it."""
    covered = 0
    for src, src_box in pieces:
        inter = [(max(a, c), min(b, e))
                 for (a, b), (c, e) in zip(dst_box, src_box)]
        if any(lo >= hi for lo, hi in inter):
            continue
        s, d = src, dst
        for dim, (lo, hi) in enumerate(inter):
            s = s.narrow(dim, lo - src_box[dim][0], hi - lo)
            d = d.narrow(dim, lo - dst_box[dim][0], hi - lo)
        d.copy_(s)
        covered += math.prod(hi - lo for lo, hi in inter)
    if covered != dst.numel():
        raise CheckpointCorruptionError(
            f"checkpoint: the saved slices of {what} cover {covered} of the "
            f"{dst.numel()} elements this rank holds")


def _file_ranks(path: str) -> Tuple[int, int]:
    """(tensor rank, data-parallel rank) of a rank file's name."""
    m = re.search(r"dp_rank_(\d+)(?:_tp_rank_(\d+))?\.pt$", path)
    return int(m.group(2) or 0), int(m.group(1))


def rank_paths(tag_dir: str) -> List[str]:
    """The rank files of a tag directory, by tensor rank, then
    data-parallel rank."""
    paths = sorted(glob.glob(os.path.join(tag_dir, "dp_rank_*.pt")),
                   key=_file_ranks)
    ranks = [_file_ranks(p) for p in paths]
    tp = 1 + max((t for t, _ in ranks), default=-1)
    dp = len(ranks) // tp if tp else 0
    if not ranks or ranks != [(t, r) for t in range(tp) for r in range(dp)]:
        raise CheckpointCorruptionError(
            f"checkpoint {tag_dir!r}: rank files {ranks}, want (tensor, "
            "data) ranks 0..tp-1 x 0..dp-1")
    return paths


def load_rank_states(tag_dir: str, engine: Optional[CheckpointEngine] = None
                     ) -> List[Dict[str, Any]]:
    """Every rank's state of a tag directory, memory-mapped, checked
    against the manifest's sizes and for a complete set of ranks."""
    verify_sidecar_manifest(tag_dir)
    loader = engine if engine is not None else CheckpointEngine()
    states = [loader.load(p) for p in rank_paths(tag_dir)]
    for path in sorted(glob.glob(os.path.join(tag_dir,
                                              "infinity_layer_*.pt"))):
        # an Infinity trunk's layers (a tensor rank's blocks each under
        # tensor parallelism) ride rank 0's state (memory-mapped)
        states[0].setdefault("trunk", []).append(
            loader.load(path)["leaves"])
    tp = int(states[0].get("tp", 1))
    dp = len(states) // tp
    for i, st in enumerate(states):
        t, r = divmod(i, dp)
        if st.get("version") != FORMAT_VERSION or st.get("rank") != r \
                or st.get("dp") != dp or st.get("tp", 1) != tp \
                or st.get("tp_rank", 0) != t:
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir!r}: the file of data rank {r}, tensor "
                f"rank {t} says rank {st.get('rank')} of {st.get('dp')}, "
                f"tensor rank {st.get('tp_rank', 0)} of {st.get('tp', 1)} "
                f"(format {st.get('version')}); the directory holds "
                f"{len(states)} files")
    return states


def leaf_sources(states: Sequence[Dict[str, Any]]
                 ) -> Dict[str, Tuple[Tuple[int, ...],
                                      List[Tuple[Dict[str, Any], Box]]]]:
    """Per leaf name, its full shape and the (leaf entry, box) of every
    rank file that holds a slice of it."""
    out: Dict[str, Any] = {}
    for leaves in (lv for st in states
                   for lv in [st["leaves"], *st.get("trunk", ())]):
        for name, entry in leaves.items():
            shape = tuple(int(d) for d in entry["full_shape"])
            have = out.setdefault(name, (shape, []))
            if have[0] != shape:
                raise CheckpointCorruptionError(
                    f"checkpoint: leaf {name!r} is {list(have[0])} in one "
                    f"rank file and {list(shape)} in another")
            have[1].append((entry, box_of(shape, entry["placement"])))
    return out


def full_tensors(tag_dir: str, key: str = "master"
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, whole fp32 tensor) of every leaf's ``key`` (``master`` or an
    optimizer state), assembled from every rank file, leaf by leaf."""
    sources = leaf_sources(load_rank_states(tag_dir))
    for name, (shape, pieces) in sources.items():
        full = torch.empty(shape, dtype=torch.float32)
        fill(full, box_of(shape, None),
             [(e[key] if key == "master" else e["optim"][key], b)
              for e, b in pieces], name)
        yield name, full


def resolve_tag(load_dir: str, tag: Optional[str]) -> Optional[str]:
    """``tag``, else what ``latest`` names, else the newest
    ``global_step*`` directory, else None."""
    if tag is not None:
        return tag
    latest = os.path.join(load_dir, LATEST_FILE)
    if os.path.exists(latest):
        with open(latest) as fh:
            return fh.read().strip()
    steps = [d for d in os.listdir(load_dir)
             if re.fullmatch(r"global_step\d+", d)
             and os.path.isdir(os.path.join(load_dir, d))]
    if not steps:
        return None
    return max(steps, key=lambda d: int(d[len("global_step"):]))


# -- save -----------------------------------------------------------------

def opt_type(opt: Any) -> str:
    """The optimizer type a rank file records (the offload optimizer's
    state is its host optimizer's: ``Adam`` for the Adam family)."""
    return opt.state_dict()["type"]


def checkpoint_masters(engine) -> List[torch.Tensor]:
    """Per parameter, the fp32 master a rank file holds: the host
    optimizer's under offload, else the engine's."""
    if engine.offload_opt is not None:
        return engine.offload_opt.masters
    return engine._masters()


def _rank_state(engine) -> Dict[str, Any]:
    """This rank's file: its slices of the cut leaves and, on group rank
    0, the whole leaves; the tensors are the live ones (the checkpoint
    engine copies each into a host buffer of its own shape)."""
    rank = comm.get_rank(engine.dp_group) if engine.dp_world_size > 1 else 0
    opt_state = engine.optimizer.state_dict()
    names = engine.optimizer.state_names
    masters = checkpoint_masters(engine)
    leaves = {}
    for i, (name, pl) in enumerate(zip(engine.param_names,
                                       engine.placements)):
        if pl is None and engine.leaf_group_rank(i) != 0:
            continue
        if engine._tensor[i] is None and engine.tp_rank != 0:
            continue  # tensor rank 0 writes a leaf every tensor rank holds
        leaves[name] = {
            "placement": placement_values(pl, engine._experts[i],
                                          engine._tensor[i]),
            "full_shape": list(leaf_shape(engine, i)),
            "master": masters[i].detach(),
            "optim": {k: opt_state[k][i] for k in names}}
    scaler = engine.loss_scaler
    return {"version": FORMAT_VERSION, "rank": rank,
            "dp": engine.dp_world_size, "tp": engine.tp_world_size,
            "tp_rank": engine.tp_rank, "zero_stage": engine.zero_stage,
            "optimizer": {"type": opt_state["type"],
                          "count": int(opt_state["count"]),
                          "state_names": list(names)},
            "loss_scaler": scaler.state_dict() if scaler is not None
            else None,
            "skipped_steps": int(engine.skipped_steps),
            "infinity": ({"layers": engine.infinity.L,
                          "state_step": engine.infinity.swapper.state_step}
                         if engine.infinity is not None else None),
            "leaves": leaves}


@torch.no_grad()
def _save_infinity_layers(engine, tag_dir: str, write: bool) -> None:
    """The streamed trunk, one layer file at a time (each written and
    dropped before the next is read from its tier).  On more than one rank
    every rank gathers each layer's segments and only ``write`` (rank 0 of
    the data axes and ``seq``) writes it: the same one file a layer.
    Under tensor parallelism each tensor coordinate writes its own file a
    layer: its blocks of the split leaves (their ``tensor`` placement) and,
    on tensor rank 0, the whole leaves."""
    from .checkpoint_engine import _write

    inf = engine.infinity
    sw = inf.swapper
    sw.flush()
    t = engine.tp_rank
    for i in range(inf.L):
        masters = sw.layer_master_tree(i)
        moments = sw.layer_moments(i)
        leaves = {}
        for name, shape, off in sw.layout:
            tensor = inf.layer_tensor.get(name)
            if tensor is None and t != 0:
                continue  # tensor rank 0 writes a leaf every rank holds
            n = math.prod(shape)
            leaves[f"layers.{i}.{name}"] = {
                "placement": placement_values(None, tensor=tensor),
                "full_shape": list(tensor.full_shape(shape)
                                   if tensor is not None else shape),
                "master": masters[name],
                "optim": {k: moments[k][off:off + n].view(shape).clone()
                          for k in ("m", "v")}}
        if write:
            name = (TP_LAYER_FILE.format(i, t) if engine.tp_group is not None
                    else LAYER_FILE.format(i))
            _write({"version": FORMAT_VERSION, "layer": i,
                    "leaves": leaves}, os.path.join(tag_dir, name))
        del masters, moments, leaves


def _copy_zero_to_fp32(save_dir: str) -> None:
    """The reference ships its consolidation script into the save
    directory (a convenience: its failure fails no save)."""
    from ..utils import zero_to_fp32

    try:
        shutil.copy(zero_to_fp32.__file__,
                    os.path.join(save_dir, "zero_to_fp32.py"))
    except OSError as e:
        logger.warning(f"checkpoint: zero_to_fp32.py not copied ({e!r})")


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict[str, Any]] = None) -> str:
    """Write this rank's state under ``<save_dir>/<tag>/`` (``seq`` rank 0
    only: the other ``seq`` ranks hold the same state); every rank of the
    data-parallel and ``seq`` groups calls it.  Returns the tag
    directory."""
    ceng = engine.checkpoint_engine
    ceng.wait()  # at most one save in flight
    if engine._micro_in_step:
        raise RuntimeError(
            f"save_checkpoint after {engine._micro_in_step} microbatches of "
            "an accumulation: the partial gradients are not checkpoint "
            "state; save at an accumulation boundary (after step())")
    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    tag_dir = os.path.abspath(os.path.join(save_dir, tag))
    group = engine._commit_group
    rank = comm.get_rank(engine.dp_group) if engine.dp_world_size > 1 else 0
    writer = engine.sp_rank == 0
    lead = writer and rank == 0 and engine.tp_rank == 0
    os.makedirs(tag_dir, exist_ok=True)
    # the scheduler counts applied steps (fp16 overflow skips excluded)
    engine.lr_scheduler.last_step = engine.optimizer.count
    if lead:
        stale = os.path.join(tag_dir, SIDECAR_MANIFEST)
        if os.path.exists(stale):
            os.remove(stale)
        meta = {"global_steps": engine.global_steps,
                "micro_steps": engine.micro_steps,
                "offload_step": (engine.offload_opt.count
                                 if engine.offload_opt is not None else 0),
                "infinity_step": (engine.infinity.swapper.state_step
                                  if engine.infinity is not None else 0),
                "lr_scheduler": engine.lr_scheduler.state_dict(),
                "client_state": client_state or {},
                "ds_config_stage": engine.zero_stage}
        with open(os.path.join(tag_dir, META_FILE), "w") as fh:
            json.dump(meta, fh, default=str)
        _copy_zero_to_fp32(save_dir)
    if engine.infinity is not None:
        _save_infinity_layers(engine, tag_dir, writer and rank == 0)

    def commit() -> None:
        if group is not None:
            comm.barrier(group)  # every rank's file is on disk
        if lead:
            write_sidecar_manifest(tag_dir)
            tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
            with open(tmp, "w") as fh:
                fh.write(tag)
            os.replace(tmp, os.path.join(save_dir, LATEST_FILE))
        if group is not None:
            comm.barrier(group)  # every rank sees `latest`

    if writer:
        name = (TP_RANK_FILE.format(rank, engine.tp_rank)
                if engine.tp_group is not None else RANK_FILE.format(rank))
        ceng.save(_rank_state(engine), os.path.join(tag_dir, name),
                  commit_fn=commit)
    else:
        ceng.defer_commit(commit)
    log_dist(f"saved checkpoint {tag_dir}")
    return tag_dir


# -- load -----------------------------------------------------------------

def _held_boxes(engine) -> List[Tuple[Box, Box]]:
    """Per parameter, the region its master and its optimizer state hold
    on this rank."""
    out = []
    for i, pl in enumerate(engine.placements):
        full, shard = leaf_shape(engine, i), engine._experts[i]
        tensor = engine._tensor[i]
        state = box_of(full, placement_values(pl, shard, tensor))
        # stage 3: the parameter's own chunk (under hpZ coarser than the
        # state's piece)
        held = engine.params[i] if engine.infinity is None else None
        master = box_of(full, placement_values(
            placement_of(held) if engine.zero_stage == 3 and held is not None
            else None, shard, tensor))
        out.append((master, state))
    return out


def _check_leaves(engine, sources: Dict[str, Any], strict: bool,
                  where: str) -> List[int]:
    """The engine's parameters to load (all of them when ``strict``);
    raises naming the first leaf whose name or shape does not match."""
    names = engine.param_names
    if strict:
        missing = [n for n in names if n not in sources]
        extra = sorted(set(sources) - set(names))
        if missing or extra:
            raise ValueError(
                f"checkpoint {where}: leaves do not match the model: missing "
                f"{missing[:4]}{'...' if len(missing) > 4 else ''}, "
                f"unexpected {extra[:4]}{'...' if len(extra) > 4 else ''}")
    todo = []
    for i, name in enumerate(names):
        if name not in sources:
            continue
        full = leaf_shape(engine, i)
        if tuple(sources[name][0]) != full:
            raise ValueError(
                f"checkpoint {where}: leaf {name!r} is "
                f"{list(sources[name][0])}, the model's is {list(full)}")
        todo.append(i)
    return todo


@torch.no_grad()
def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_module_strict: bool = True,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True,
                    load_module_only: bool = False
                    ) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
    """Load ``<load_dir>/<tag>/`` into the engine at its own stage and
    ranks; returns ``(tag directory, client_state)`` or ``(None, None)``
    when there is no checkpoint.  ``load_module_only`` or
    ``load_optimizer_states=False`` load the masters alone (then the
    saving optimizer's type does not matter)."""
    ceng = engine.checkpoint_engine
    ceng.wait()
    join_inflight_save(load_dir)
    tag = resolve_tag(load_dir, tag)
    if tag is None:
        logger.warning(f"no checkpoint found under {load_dir}")
        return None, None
    tag_dir = os.path.abspath(os.path.join(load_dir, tag))
    states = load_rank_states(tag_dir, ceng)
    sources = leaf_sources(states)
    params_only = load_module_only or not load_optimizer_states
    trunk = {}
    if engine.infinity is not None:  # the streamed layers load apart
        trunk = {n: v for n, v in sources.items() if n.startswith("layers.")}
        sources = {n: v for n, v in sources.items() if n not in trunk}
    todo = _check_leaves(engine, sources, load_module_strict, tag_dir)
    opt = engine.optimizer
    saved_opt = states[0]["optimizer"]
    if not params_only:
        if saved_opt["type"] != opt_type(opt) or \
                list(saved_opt["state_names"]) != list(opt.state_names):
            raise ValueError(
                f"checkpoint {tag_dir}: optimizer state of "
                f"{saved_opt['type']} ({saved_opt['state_names']}), the "
                f"engine's optimizer is {opt_type(opt)} "
                f"({list(opt.state_names)}); pass load_optimizer_states="
                "False or load_module_only=True to load the weights alone")
    if engine.infinity is not None:
        _load_infinity_layers(engine, trunk, params_only, tag_dir)
    held = _held_boxes(engine)
    opt_state = opt.state_dict()
    host = engine.offload_opt.masters if engine.offload_opt is not None \
        else None
    for i in todo:
        name, (master_box, state_box) = engine.param_names[i], held[i]
        pieces = sources[name][1]
        fill(engine.params[i].data, master_box,
             [(e["master"], b) for e, b in pieces], name)
        if host is not None:  # the host masters: this rank's part
            fill(host[i], state_box, [(e["master"], b) for e, b in pieces],
                 name)
        if not params_only:
            for k in opt.state_names:
                fill(opt_state[k][i], state_box,
                     [(e["optim"][k], b) for e, b in pieces], f"{name} ({k})")
    if not params_only:
        opt.count = int(saved_opt["count"])
        if engine.infinity is not None:
            inf_state = states[0].get("infinity") or {}
            engine.infinity.swapper.state_step = int(inf_state.get(
                "state_step", saved_opt["count"]))
            engine.infinity.global_steps = opt.count
        if engine.loss_scaler is not None and states[0]["loss_scaler"]:
            engine.loss_scaler.load_state_dict(states[0]["loss_scaler"])
        engine._skipped_steps = int(states[0]["skipped_steps"])
    with open(os.path.join(tag_dir, META_FILE)) as fh:
        meta = json.load(fh)
    engine.global_steps = int(meta["global_steps"])
    engine.micro_steps = int(meta["micro_steps"])
    if load_lr_scheduler_states and meta.get("lr_scheduler"):
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    log_dist(f"loaded checkpoint {tag_dir}")
    return tag_dir, meta.get("client_state", {})


@torch.no_grad()
def _load_infinity_layers(engine, sources: Dict[str, Any], params_only: bool,
                          where: str) -> None:
    """Install every trunk layer's masters (and moments) from the
    checkpoint's leaves into the swapper, one layer at a time (whole: each
    rank keeps its segment, so any rank count loads any save; under tensor
    parallelism the rank's block of each split leaf)."""
    inf = engine.infinity
    sw = inf.swapper
    for i in range(inf.L):
        masters: Dict[str, torch.Tensor] = {}
        flat = {k: torch.empty(sw.n_elems, dtype=torch.float32)
                for k in ("m", "v")}
        for name, shape, off in sw.layout:
            full = f"layers.{i}.{name}"
            if full not in sources:
                raise ValueError(f"checkpoint {where}: the streamed trunk's "
                                 f"leaf {full!r} is missing")
            saved_shape, pieces = sources[full]
            tensor = inf.layer_tensor.get(name)
            whole = tensor.full_shape(shape) if tensor is not None else shape
            if tuple(saved_shape) != tuple(whole):
                raise ValueError(
                    f"checkpoint {where}: leaf {full!r} is "
                    f"{list(saved_shape)}, the model's is {list(whole)}")
            box = box_of(whole, placement_values(None, tensor=tensor))
            t = torch.empty(shape, dtype=torch.float32)
            fill(t, box, [(e["master"], b) for e, b in pieces], full)
            masters[name] = t
            if not params_only:
                n = math.prod(shape)
                for k in ("m", "v"):
                    fill(flat[k][off:off + n].view(shape), box,
                         [(e["optim"][k], b) for e, b in pieces],
                         f"{full} ({k})")
        sw.load_layer(i, masters, None if params_only else flat)


# -- the universal layout ---------------------------------------------------

UNIVERSAL_META = "universal_metadata.json"
#: the universal file of each Adam state (the reference's names)
UNIVERSAL_MOMENTS = {"m": "exp_avg", "v": "exp_avg_sq"}


@torch.no_grad()
def load_universal_checkpoint(engine, universal_dir: str) -> None:
    """Load a ``ds_to_universal`` directory (``universal_metadata.json``
    and ``zero/<name>/{fp32,exp_avg,exp_avg_sq}.npy``, the layout both
    packages read, keyed by the port's parameter names) at this engine's
    stage and ranks: the masters, Adam's moments where the directory has
    them, and the step count."""
    with open(os.path.join(universal_dir, UNIVERSAL_META)) as fh:
        meta = json.load(fh)
    zero_dir = os.path.join(universal_dir, "zero")
    entries = meta["params"]
    for name in engine.param_names:
        if name not in entries:
            raise KeyError(f"universal checkpoint has no parameter {name!r} "
                           f"(has: {sorted(entries)[:8]}...)")
    _check_leaves(engine, {n: (tuple(e["shape"]), None)
                           for n, e in entries.items()}, False, universal_dir)
    opt = engine.optimizer
    moments = [k for k in opt.state_names if k in UNIVERSAL_MOMENTS]
    opt_state = opt.state_dict()
    host = engine.offload_opt.masters if engine.offload_opt is not None \
        else None
    for i, (master_box, state_box) in enumerate(_held_boxes(engine)):
        name = engine.param_names[i]
        entry = entries[name]
        full = box_of(entry["shape"], None)

        def piece(fname: str) -> List[Tuple[torch.Tensor, Box]]:
            arr = np.load(os.path.join(zero_dir, name, fname + ".npy"))
            return [(torch.from_numpy(np.asarray(arr, np.float32)), full)]
        fill(engine.params[i].data, master_box, piece("fp32"), name)
        if host is not None:  # the host masters: this rank's part
            fill(host[i], state_box, piece("fp32"), name)
        if entry.get("has_moments"):
            for k in moments:
                fill(opt_state[k][i], state_box,
                     piece(UNIVERSAL_MOMENTS[k]), f"{name} ({k})")
    step = int(meta["step"])
    if engine.infinity is not None:  # the streamed trunk, layer by layer
        sw = engine.infinity.swapper
        for i in range(engine.infinity.L):
            masters, flat = {}, {}
            for lname, shape, off in sw.layout:
                path = os.path.join(zero_dir, f"layers.{i}.{lname}")
                if not os.path.isdir(path):
                    raise KeyError(f"universal checkpoint has no parameter "
                                   f"'layers.{i}.{lname}'")
                tensor = engine.infinity.layer_tensor.get(lname)

                def block(a: np.ndarray) -> torch.Tensor:
                    t = torch.from_numpy(a.astype(np.float32))
                    if tensor is None:
                        return t
                    n = t.shape[tensor.dim] // tensor.tp
                    return t.narrow(tensor.dim, tensor.rank * n,
                                    n).contiguous()
                masters[lname] = block(np.load(os.path.join(path,
                                                            "fp32.npy")))
                for k, fname in UNIVERSAL_MOMENTS.items():
                    f = os.path.join(path, fname + ".npy")
                    if os.path.exists(f):
                        flat.setdefault(k, []).append(
                            block(np.load(f)).reshape(-1))
            moments_i = ({k: torch.cat(v) for k, v in flat.items()}
                         if len(flat) == 2 else None)
            sw.load_layer(i, masters, moments_i)
        sw.state_step = step
        engine.infinity.global_steps = step
    opt.count = step
    engine.global_steps = step
    engine.lr_scheduler.last_step = step
    log_dist(f"loaded universal checkpoint {universal_dir} (step {step})")
