"""Checkpoint save and load of the engine's sharded training state.

Counterpart of ``deepspeed_tpu/runtime/checkpointing.py``.  The JAX engine
writes one orbax tree whose arrays orbax reshards on load; the port runs
one process a data-parallel rank, so each rank writes its own file and a
load assembles each tensor it holds from the files' slices.

Layout of ``<save_dir>/<tag>/`` (default tag ``global_step{N}``):

    dp_rank_{r:05d}.pt   rank r's state: per leaf its placement as plain
                         values (``dim``, ``dp``, ``rank``, ``full_shape``;
                         None when whole), and tensors: of a cut leaf
                         this rank's chunk of the fp32 master and of each
                         optimizer state (m and v of Adam), of a whole
                         leaf all of them, written by rank 0 only; the
                         optimizer's type and step count, the loss
                         scaler's state and the skipped steps
    client_state.json    the JAX meta's keys: global_steps, micro_steps,
                         lr_scheduler, client_state, ds_config_stage, ...
    ds_manifest.json     each file's size and sha256

and ``<save_dir>/zero_to_fp32.py``, then ``<save_dir>/latest`` (the tag),
written last: after every rank's file and the manifest are on disk (behind
a barrier over the ranks, after the async engine's ``wait()``).

A load reads each file memory-mapped and copies into every tensor this
rank holds (the whole master at stages 0-2, the chunk at stage 3; the
optimizer states' chunks of cut leaves) the parts of the saved slices that
overlap it: any stage and any number of ranks load what any other saved.
Names and shapes are checked first; a mismatch raises naming the leaf and
nothing is written.  ZeRO-Infinity and offload state are not ported.
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
from .checkpoint_engine import (SIDECAR_MANIFEST, CheckpointCorruptionError,
                                CheckpointEngine, join_inflight_save,
                                verify_sidecar_manifest,
                                write_sidecar_manifest)

LATEST_FILE = "latest"
META_FILE = "client_state.json"
RANK_FILE = "dp_rank_{:05d}.pt"
FORMAT_VERSION = 1

#: a tensor's region in its leaf's full index space: (start, stop) per dim
Box = Tuple[Tuple[int, int], ...]


# -- the layout -----------------------------------------------------------

def placement_values(pl: Any) -> Optional[Dict[str, Any]]:
    """A ``Placement`` as plain values (never its process group)."""
    if pl is None:
        return None
    return {"dim": int(pl.dim), "dp": int(pl.dp), "rank": int(pl.rank),
            "full_shape": [int(d) for d in pl.full_shape]}


def box_of(full_shape: Sequence[int],
           placement: Optional[Dict[str, Any]]) -> Box:
    """The region a tensor holds: all of the leaf, or chunk ``rank`` of
    ``dp`` along ``dim``."""
    box = [(0, int(d)) for d in full_shape]
    if placement is not None:
        d, n = placement["dim"], int(full_shape[placement["dim"]]) \
            // placement["dp"]
        box[d] = (placement["rank"] * n, (placement["rank"] + 1) * n)
    return tuple(box)


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


def rank_paths(tag_dir: str) -> List[str]:
    """The rank files of a tag directory, in rank order."""
    paths = sorted(glob.glob(os.path.join(tag_dir, "dp_rank_*.pt")))
    ranks = [int(re.search(r"dp_rank_(\d+)\.pt$", p).group(1))
             for p in paths]
    if ranks != list(range(len(ranks))) or not ranks:
        raise CheckpointCorruptionError(
            f"checkpoint {tag_dir!r}: rank files {ranks}, want 0..n-1")
    return paths


def load_rank_states(tag_dir: str, engine: Optional[CheckpointEngine] = None
                     ) -> List[Dict[str, Any]]:
    """Every rank's state of a tag directory, memory-mapped, checked
    against the manifest's sizes and for a complete set of ranks."""
    verify_sidecar_manifest(tag_dir)
    loader = engine if engine is not None else CheckpointEngine()
    states = [loader.load(p) for p in rank_paths(tag_dir)]
    for r, st in enumerate(states):
        if st.get("version") != FORMAT_VERSION or st.get("rank") != r \
                or st.get("dp") != len(states):
            raise CheckpointCorruptionError(
                f"checkpoint {tag_dir!r}: {RANK_FILE.format(r)} says rank "
                f"{st.get('rank')} of {st.get('dp')} (format "
                f"{st.get('version')}); the directory holds {len(states)}")
    return states


def leaf_sources(states: Sequence[Dict[str, Any]]
                 ) -> Dict[str, Tuple[Tuple[int, ...],
                                      List[Tuple[Dict[str, Any], Box]]]]:
    """Per leaf name, its full shape and the (leaf entry, box) of every
    rank file that holds a slice of it."""
    out: Dict[str, Any] = {}
    for st in states:
        for name, entry in st["leaves"].items():
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

def _rank_state(engine) -> Dict[str, Any]:
    """This rank's file: its slices of the cut leaves and, on group rank
    0, the whole leaves; the tensors are the live ones (the checkpoint
    engine copies each into a host buffer of its own shape)."""
    rank = comm.get_rank(engine.dp_group) if engine.dp_world_size > 1 else 0
    opt_state = engine.optimizer.state_dict()
    names = engine.optimizer.state_names
    masters = engine._masters()
    leaves = {}
    for i, (name, p, pl) in enumerate(zip(engine.param_names, engine.params,
                                          engine.placements)):
        if pl is None and rank != 0:
            continue
        leaves[name] = {
            "placement": placement_values(pl),
            "full_shape": list(pl.full_shape if pl is not None
                               else p.shape),
            "master": masters[i].detach(),
            "optim": {k: opt_state[k][i] for k in names}}
    scaler = engine.loss_scaler
    return {"version": FORMAT_VERSION, "rank": rank,
            "dp": engine.dp_world_size, "zero_stage": engine.zero_stage,
            "optimizer": {"type": opt_state["type"],
                          "count": int(opt_state["count"]),
                          "state_names": list(names)},
            "loss_scaler": scaler.state_dict() if scaler is not None
            else None,
            "skipped_steps": int(engine.skipped_steps),
            "leaves": leaves}


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
    """Write this rank's state under ``<save_dir>/<tag>/``; every rank of
    the data-parallel group calls it.  Returns the tag directory."""
    ceng = engine.checkpoint_engine
    ceng.wait()  # at most one save in flight
    if engine._micro_in_step:
        raise RuntimeError(
            f"save_checkpoint after {engine._micro_in_step} microbatches of "
            "an accumulation: the partial gradients are not checkpoint "
            "state; save at an accumulation boundary (after step())")
    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    tag_dir = os.path.abspath(os.path.join(save_dir, tag))
    group = engine.dp_group if engine.dp_world_size > 1 else None
    lead = group is None or comm.get_rank(group) == 0
    os.makedirs(tag_dir, exist_ok=True)
    # the scheduler counts applied steps (fp16 overflow skips excluded)
    engine.lr_scheduler.last_step = engine.optimizer.count
    if lead:
        stale = os.path.join(tag_dir, SIDECAR_MANIFEST)
        if os.path.exists(stale):
            os.remove(stale)
        meta = {"global_steps": engine.global_steps,
                "micro_steps": engine.micro_steps,
                "offload_step": 0, "infinity_step": 0,
                "lr_scheduler": engine.lr_scheduler.state_dict(),
                "client_state": client_state or {},
                "ds_config_stage": engine.zero_stage}
        with open(os.path.join(tag_dir, META_FILE), "w") as fh:
            json.dump(meta, fh, default=str)
        _copy_zero_to_fp32(save_dir)
    rank = comm.get_rank(group) if group is not None else 0

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

    ceng.save(_rank_state(engine), os.path.join(tag_dir,
                                                 RANK_FILE.format(rank)),
              commit_fn=commit)
    log_dist(f"saved checkpoint {tag_dir}")
    return tag_dir


# -- load -----------------------------------------------------------------

def _held_boxes(engine) -> List[Tuple[Box, Box]]:
    """Per parameter, the region its master and its optimizer state hold
    on this rank."""
    out = []
    for p, pl in zip(engine.params, engine.placements):
        full = pl.full_shape if pl is not None else tuple(p.shape)
        state = box_of(full, placement_values(pl))
        out.append((state if engine.zero_stage == 3 else box_of(full, None),
                    state))
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
    for i, (name, p, pl) in enumerate(zip(names, engine.params,
                                          engine.placements)):
        if name not in sources:
            continue
        full = tuple(pl.full_shape) if pl is not None else tuple(p.shape)
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
    todo = _check_leaves(engine, sources, load_module_strict, tag_dir)
    opt = engine.optimizer
    saved_opt = states[0]["optimizer"]
    if not params_only:
        if saved_opt["type"] != type(opt).__name__ or \
                list(saved_opt["state_names"]) != list(opt.state_names):
            raise ValueError(
                f"checkpoint {tag_dir}: optimizer state of "
                f"{saved_opt['type']} ({saved_opt['state_names']}), the "
                f"engine's optimizer is {type(opt).__name__} "
                f"({list(opt.state_names)}); pass load_optimizer_states="
                "False or load_module_only=True to load the weights alone")
    held = _held_boxes(engine)
    opt_state = opt.state_dict()
    for i in todo:
        name, (master_box, state_box) = engine.param_names[i], held[i]
        pieces = sources[name][1]
        fill(engine.params[i].data, master_box,
             [(e["master"], b) for e, b in pieces], name)
        if not params_only:
            for k in opt.state_names:
                fill(opt_state[k][i], state_box,
                     [(e["optim"][k], b) for e, b in pieces], f"{name} ({k})")
    if not params_only:
        opt.count = int(saved_opt["count"])
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
    for i, (master_box, state_box) in enumerate(_held_boxes(engine)):
        name = engine.param_names[i]
        entry = entries[name]
        full = box_of(entry["shape"], None)

        def piece(fname: str) -> List[Tuple[torch.Tensor, Box]]:
            arr = np.load(os.path.join(zero_dir, name, fname + ".npy"))
            return [(torch.from_numpy(np.asarray(arr, np.float32)), full)]
        fill(engine.params[i].data, master_box, piece("fp32"), name)
        if entry.get("has_moments"):
            for k in moments:
                fill(opt_state[k][i], state_box,
                     piece(UNIVERSAL_MOMENTS[k]), f"{name} ({k})")
    step = int(meta["step"])
    opt.count = step
    engine.global_steps = step
    engine.lr_scheduler.last_step = step
    log_dist(f"loaded universal checkpoint {universal_dir} (step {step})")
