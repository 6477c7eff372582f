"""``initialize``: a model and a ds_config to a training engine.

Counterpart of ``deepspeed_tpu/runtime/entry.py`` (``initialize``
101-167): join the process group, take the data-parallel group from a
``mesh=`` or ``mpu=`` or build the mesh from the world (its ``expert``
axis ``moe.expert_parallel_size``, its ``seq`` axis
``sequence_parallel.sp_size`` or an mpu's sequence-parallel size),
resolve the batch sizes over the data-parallel ranks, push the ``moe``
group onto a mixture-of-experts model (``_apply_moe_config``) and the
mesh onto a model that trains under a ``seq`` axis, make every rank hold
rank 0's parameters (an expert leaf its ``data`` group's rank 0's), and
build the engine (one data-parallel rank under
``zero_optimization.stage``, the gradients also summed over ``seq``) and,
from
``training_data``, this rank's dataloader (with the seqlen curriculum
when the config enables one).  The JAX entry also builds the telemetry,
tuning and resilience planes; none of those is ported yet, so their
config groups are accepted without effect (``runtime/config.py``) and a
client optimizer raises (with ``offload_optimizer`` the JAX engine's
refusal under ``zero_force_ds_cpu_optimizer``, else the host optimizer the
config names replaces it).

ZeRO-Offload and ZeRO-Infinity come from the config's
``zero_optimization.offload_optimizer`` / ``offload_param``; with
``offload_param`` the model's parameters may live on the CPU (a trunk
larger than the card is never placed on it whole).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..comm import comm
from ..parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_PIPE, AXIS_SEQ,
                             AXIS_TENSOR, DP_AXES)
from ..utils import groups
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import logger
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader
from .engine import DeepSpeedEngine
from .lr_schedules import LRScheduler
from .optimizers import Optimizer
from .zero.sharder import expert_of, placement_of

ConfigLike = Union[str, os.PathLike, Dict[str, Any], DeepSpeedConfig]


def _data_parallel(mesh: Any, mpu: Any, ep: int = 1, sp: int = 1,
                   tp: int = 1) -> Tuple[Any, int, Dict[str, int], Any]:
    """(the data-parallel group or None, its size, the other parallel
    sizes, the mesh or None) from ``mesh`` (its ``DP_AXES``), else
    ``mpu`` (one with data-parallel getters), else the world (a mesh built
    over it whose ``tensor`` axis is ``tp``, ``seq`` axis ``sp`` and
    ``expert`` axis ``ep``: each must divide what is left of the world,
    as JAX's ``initialize`` checks)."""
    from ..parallel.mesh import MeshLayout

    world = comm.get_world_size() if comm.is_initialized() else 1
    if mpu is not None and not hasattr(mpu, "get_data_parallel_world_size"):
        mpu = None  # the sequence getters alone: they gave sp
    if mpu is not None and (sp > 1 or tp > 1):
        raise NotImplementedError(
            "an mpu's data-parallel group with a seq or tensor axis is not "
            "ported: pass mesh= (utils.groups.initialize_mesh(MeshLayout."
            "infer(world, tp=..., sp=...)))")
    if mesh is None and mpu is None and (world > 1 or ep > 1 or sp > 1
                                         or tp > 1):
        if world % (sp * tp):
            raise ValueError(f"sequence_parallel.sp_size={sp} x "
                             f"tensor_parallel.autotp_size={tp} must divide "
                             f"the world {world}")
        if world // (sp * tp) % ep:
            raise ValueError(
                f"moe.expert_parallel_size={ep} must divide the DP world "
                f"{world // (sp * tp)} (= world/(tp·pp·sp))")
        mesh = groups.initialize_mesh(MeshLayout.infer(world, ep=ep, sp=sp,
                                                       tp=tp))
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        dp = 1
        for axis in DP_AXES:
            dp *= int(shape.get(axis, 1))
        others = {a: int(shape.get(a, 1))
                  for a in (AXIS_TENSOR, AXIS_PIPE, AXIS_SEQ)}
        what = f"the mesh's data axes ({dp})"
        group = (lambda: mesh.group(*DP_AXES)) if dp > 1 else None
    elif mpu is not None:
        dp = int(mpu.get_data_parallel_world_size())
        others = {}
        what = f"the mpu's data-parallel world ({dp})"
        group = mpu.get_data_parallel_group if dp > 1 else None
        mesh = None
    else:
        return None, 1, {}, None
    if dp > world:
        raise ValueError(f"{what} asks for more ranks than the process "
                         f"group holds ({world}): launch {dp} ranks and "
                         "join them (init_distributed) first")
    if group is None:
        return None, dp, others, mesh
    return group() or dist.group.WORLD, dp, others, mesh


def _apply_moe_config(cfg: DeepSpeedConfig, model: Any, mesh: Any) -> None:
    """Push the ``moe`` group onto the model's MoE layer and gate (JAX
    ``_apply_moe_config``): a model built before ``initialize`` saw the
    config takes the mesh (a whole Mixtral keeps its experts' slice of an
    ``expert`` axis above 1), the dispatch rung, the capacity padding,
    random token selection and the capacity factor."""
    layer = getattr(model, "_moe_layer", None) or getattr(
        model, "moe_layer", None)
    if layer is None:
        return
    moe = cfg.moe
    if mesh is not None and getattr(model, "mesh", mesh) is None and \
            int(mesh.shape.get(AXIS_EXPERT, 1)) > 1:
        model.shard_(mesh)
    if layer.mesh is None and mesh is not None:
        layer.mesh = mesh
    if layer.gate.mesh is None and mesh is not None:
        layer.gate.mesh = mesh
    if moe.dispatch_impl != "auto":
        layer.dispatch_impl = moe.dispatch_impl
    gate = layer.gate
    gate.pad_to_ep = bool(moe.pad_capacity_to_ep)
    if moe.use_rts:
        gate.use_rts = True
    if moe.capacity_factor and moe.capacity_factor > 0:
        gate.capacity_factor = float(moe.capacity_factor)
        gate.eval_capacity_factor = float(moe.capacity_factor)


def _refuse_unported_seq(model: Any, sp: int, tp: int,
                         infinity: bool) -> None:
    """Before any mesh is built: refuse, naming its ROADMAP Queue 1 item,
    a composition with ``seq`` that no test holds against JAX yet."""
    if sp == 1:
        return
    name = type(model).__name__
    if not getattr(model, "sequence_parallel", False):
        raise NotImplementedError(
            f"{name} under a seq axis is not ported yet (ROADMAP Queue 1 "
            "item 7d: it has no sequence to cut; JAX replicates it over "
            "seq)")
    moe = getattr(model, "_moe_layer", None) is not None
    if tp > 1 and not getattr(model, "sequence_tensor_parallel", False):
        raise NotImplementedError(
            f"{name} at tensor x seq is not ported yet (ROADMAP Queue 1 "
            f"item 7c{': with an expert axis too' if moe else ''})")
    if infinity and moe:
        raise NotImplementedError(
            f"{name} under offload_param with a seq axis is not ported yet "
            "(ROADMAP Queue 1 item 9c)")


def _refuse_unported_zeropp(model: Any, zero: Any, sp: int,
                            tp: int) -> None:
    """Before any mesh is built: refuse ZeRO++ (qwZ, qgZ, hpZ) where no
    test holds it against JAX yet, naming ROADMAP Queue 1 item 4c: under a
    tensor or ``seq`` axis, or on a model other than the Llama family."""
    keys = [k for k in ("zero_quantized_weights", "zero_quantized_gradients")
            if getattr(zero, k)]
    if int(zero.zero_hpz_partition_size or 1) > 1 and int(zero.stage) >= 3:
        keys.append("zero_hpz_partition_size")
    if not keys:
        return
    where = (f"{type(model).__name__}" if not getattr(model, "zero_pp", False)
             else "a tensor axis" if tp > 1 else "a seq axis" if sp > 1
             else None)
    if where is not None:
        raise NotImplementedError(
            f"{', '.join(keys)} on {where} is not ported yet (ROADMAP "
            "Queue 1 item 4c: ZeRO++ trains the Llama family on the data "
            "axes)")


def _apply_tensor_parallel(model: Any, mesh: Any, tp: int) -> None:
    """Split a whole model over the mesh's ``tensor`` axis (its own
    ``shard_``, else AutoTP's name policy: ``tensor_parallel.
    split_model_``, as ``tp_model_init`` does), or check that it was built
    on it."""
    from .tensor_parallel import split_model_

    if getattr(model, "tp", 1) == 1:
        split_model_(model, mesh)
    if model.tp != tp:
        raise ValueError(f"the model is split over {model.tp} tensor ranks, "
                         f"the mesh's tensor axis is {tp}")


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, distributed_port: Any = None,
               mpu: Any = None, dist_init_required: Optional[bool] = None,
               collate_fn: Any = None, config: Optional[ConfigLike] = None,
               config_params: Optional[ConfigLike] = None, mesh: Any = None,
               device: DeviceLike = "cuda"
               ) -> Tuple[DeepSpeedEngine, Optimizer, Any, LRScheduler]:
    """``(engine, optimizer, dataloader, lr_scheduler)``, as the reference
    returns them (the dataloader None without ``training_data``).

    ``model`` is an ``nn.Module`` with ``.loss(batch)`` (its trainable
    parameters are the fp32 masters, unless ``model_parameters`` names
    them) or a callable ``batch -> loss`` with ``model_parameters``.
    ``config`` (or ``config_params``) is a dict, a JSON path or a
    :class:`DeepSpeedConfig`.  ``lr_scheduler`` may be a callable ``step ->
    lr`` that overrides the config's scheduler.  ``device`` defaults to
    ``"cuda"`` and raises without a card.

    Data parallelism: unless ``dist_init_required`` is False, the process
    joins the world its launcher's environment describes (``WORLD_SIZE``
    above 1; always with ``dist_init_required=True``).  The data-parallel
    group is a ``mesh``'s (``utils.groups.initialize_mesh``) data axes, an
    ``mpu``'s ``get_data_parallel_group()``, or the whole world; each rank
    then feeds ``train_step`` its own ``micro x gas`` rows, and
    ``train_batch_size`` counts every rank's.  Rank 0's parameters are
    broadcast to the group first, so ranks that built the model from
    different seeds train one model.

    Sequence parallelism: ``sequence_parallel.sp_size`` (or an mpu's
    ``get_sequence_parallel_world_size``, or a ``mesh`` whose ``seq`` axis
    is) above 1 cuts every row's sequence over that many ranks: each rank
    of a ``seq`` group feeds ``train_step`` the same whole rows (its data
    coordinate's), and the model (Llama, Mixtral, BERT or OPT, which
    ``initialize`` hands the mesh when it was built without one) keeps
    its ``S/sp`` chunk, runs Ulysses (or Llama's ring) at each attention
    and returns its share of the token mean; a Mixtral routes the global
    tokens over the data axes and ``seq`` and counts its aux loss
    ``1/sp`` a rank.  The engine sums every gradient over ``seq``.  ZeRO
    still cuts over the data axes alone.  ZeRO-Infinity
    (``offload_param``) runs on the data axes and ``seq`` (and
    ``tensor``): each rank's host planes hold its share of every layer.
    Not ported under ``seq`` (ROADMAP Queue 1, refused before any mesh is
    built): Mixtral, BERT and OPT at tensor x ``seq`` (item 7c), a model
    with no sequence such as ResNet (7d), Mixtral under ``offload_param``
    (9c); not ported under ``offload_param``: a pipe axis (layer streaming
    is itself layer-sequential, as JAX refuses it).

    Tensor parallelism: ``tensor_parallel.autotp_size`` (or a ``mesh``
    whose ``tensor`` axis is) above 1 builds the mesh with that ``tensor``
    axis beside the data axes and ``seq`` (JAX ``initialize`` :122-150).
    The model is built on that mesh, or whole, which ``initialize`` then
    splits: a model of the port by its own ``shard_`` (Llama, Mixtral,
    OPT, BERT; ResNet keeps every leaf whole), any other ``nn.Module`` by
    AutoTP's name policy (``runtime/tensor_parallel.auto_tp``, where JAX's
    engine applies ``infer_tp_specs``).  A model already split (built on
    a mesh, or by ``tp_model_init``) brings its own mesh when neither
    ``mesh`` nor ``mpu`` is given, and a mesh whose ``tensor`` axis is not
    the model's split raises.  Every rank of a tensor group builds it from
    the same seed and feeds ``train_step`` the same rows (its data
    coordinate's).  The layers run Megatron's *f* and *g*, a split head's
    loss is vocabulary-parallel, and the engine adds the split leaves'
    Σg² over ``tensor``; ZeRO cuts over the data axes of the rank's
    tensor and ``seq`` coordinates.  With ``sequence_parallel.sp_size``
    too, a rank holds its ``h/tp`` heads of its ``S/sp`` chunk and Ulysses
    (or the ring) runs over its ``seq`` group; under ``offload_param``
    each tensor coordinate streams its own planes.  With an ``expert``
    axis too (a Mixtral, JAX's ``P(pipe, expert, None, tensor)``), a rank
    holds its expert coordinate's ``E/ep`` experts by their ``I/tp``
    columns, and the expert exchange runs over the ``expert`` group of its
    tensor coordinate.

    ZeRO++ (``zero_quantized_weights``, ``zero_quantized_gradients``,
    ``zero_hpz_partition_size``; ``runtime/engine.py``) trains a Llama-family
    model on the data axes: hpZ's ``hpz`` is the mesh's ``data`` axis, and
    the rest of the data-parallel world its ``expert`` axis
    (``moe.expert_parallel_size``, or a mesh built with ``ep``).  Under a
    tensor or ``seq`` axis, and on Mixtral, BERT, OPT, ResNet or a bare
    loss function, it is refused before any mesh is built (ROADMAP Queue 1
    item 4c).

    ``hybrid_engine.enabled`` returns a
    :class:`~.hybrid_engine.DeepSpeedHybridEngine` around the engine (its
    ``generate`` runs the model's KV-cache path on the live weights).

    Expert parallelism: a mixture-of-experts model (``MixtralModel``)
    routes the global micro-batch on any data axis; with
    ``moe.expert_parallel_size`` ``ep`` above 1 (or a ``mesh`` whose
    ``expert`` axis is) each rank holds ``E/ep`` experts: build the model
    on the mesh (``utils.groups.initialize_mesh(MeshLayout.infer(world,
    ep=ep))``) or whole, which ``initialize`` then cuts.  An expert leaf is
    broadcast, reduced and cut under ZeRO over the ``data`` axis alone.

    ``training_data`` (an indexable of samples) gives a
    :class:`~.dataloader.DeepSpeedDataLoader` of ``train_batch_size``
    samples a step, shuffled with the config's ``seed``, that yields this
    rank's rows (collated by ``collate_fn``; pinned CPU tensors on the
    card); with a curriculum (``curriculum_learning`` or
    ``data_efficiency.data_sampling.curriculum_learning``) it is wrapped by
    the seqlen truncation at the engine's step, and the scheduler is
    ``engine.curriculum_scheduler``.  Accepted without effect: ``args``
    (the argparse namespace) and ``distributed_port`` (the environment's
    ``MASTER_PORT`` is used)."""
    del args, distributed_port
    dev = resolve_device(device)
    spec = config if config is not None else config_params
    if spec is None:
        raise ValueError("initialize needs config= (a dict or a JSON path)")
    cfg = DeepSpeedConfig.load(spec)
    zero = cfg.zero_optimization
    if optimizer is not None:
        if zero.offload_optimizer_device() == "none":
            raise NotImplementedError("a client optimizer is not ported "
                                      "yet; name it in the config's "
                                      "optimizer block")
        if cfg.zero_force_ds_cpu_optimizer:  # JAX engine.py:100-113
            raise ValueError(
                "a client optimizer cannot be combined with "
                "offload_optimizer; remove it or set "
                "zero_force_ds_cpu_optimizer: false to acknowledge the "
                "config-derived CPU optimizer will be used instead")
        logger.warning("offload_optimizer active: ignoring the client "
                       "optimizer, using the config-derived CPU optimizer")
    if dist_init_required or (dist_init_required is None and int(
            os.environ.get("WORLD_SIZE", "1")) > 1):
        comm.init_distributed(device=dev)
    sp = int(cfg.sequence_parallel.sp_size or 1)
    if hasattr(mpu, "get_sequence_parallel_world_size"):
        sp = int(mpu.get_sequence_parallel_world_size())
    tp_cfg = int(cfg.tensor_parallel.autotp_size or 1)
    # a model already split (built on a mesh, or by tp_model_init) brings
    # its mesh: its layers run f and g over that mesh's tensor group
    model_tp = int(getattr(model, "tp", 1) or 1)
    if model_tp > 1 and mesh is None and mpu is None:
        mesh = model.mesh
    ep_cfg = int(cfg.moe.expert_parallel_size)
    axes = getattr(mesh, "shape", None) or {}
    infinity = zero.offload_param_device() != "none"
    _refuse_unported_seq(
        model, max(sp, int(axes.get(AXIS_SEQ, 1))),
        max(tp_cfg, model_tp, int(axes.get(AXIS_TENSOR, 1))), infinity)
    _refuse_unported_zeropp(
        model, zero, max(sp, int(axes.get(AXIS_SEQ, 1))),
        max(tp_cfg, model_tp, int(axes.get(AXIS_TENSOR, 1))))
    dp_group, dp, others, mesh = _data_parallel(mesh, mpu, ep_cfg, sp,
                                                max(tp_cfg, model_tp))
    tp, pp, sp = (others.get(a, 1) for a in (AXIS_TENSOR, AXIS_PIPE,
                                             AXIS_SEQ))
    if tp_cfg > 1 and tp != tp_cfg:
        raise ValueError(f"tensor_parallel.autotp_size={tp_cfg}, the mesh's "
                         f"tensor axis is {tp}")
    if model_tp > 1 and tp != model_tp:
        raise ValueError(f"the model is split over {model_tp} tensor ranks, "
                         f"the mesh's tensor axis is {tp}")
    if infinity and pp > 1:
        raise NotImplementedError(
            "layer streaming is itself layer-sequential; combine "
            "offload_param with the data axes and seq, not pipe")
    cfg.resolve_batch_sizes(world_size=dp * tp * pp * sp, tp=tp, pp=pp,
                            sp=sp)
    cfg.resolve_auto_precision()
    if tp > 1:
        _apply_tensor_parallel(model, mesh, tp)
    _apply_moe_config(cfg, model, mesh)
    data_group = mesh.group(AXIS_DATA) if mesh is not None and dp > 1 \
        else None
    tp_group = dp_tp_group = None
    if tp > 1:
        tp_group = mesh.group(AXIS_TENSOR)
        dp_tp_group = (groups.axes_group(DP_AXES + (AXIS_TENSOR,), mesh)
                       if dp > 1 else tp_group)
    seq_group = dp_seq_group = None
    if sp > 1:
        if getattr(model, "mesh", mesh) is None:
            model.mesh = mesh  # a model built without one cuts over seq
        seq_group = mesh.group(AXIS_SEQ)
        dp_seq_group = groups.axes_group(DP_AXES + (AXIS_SEQ,), mesh)
    # a checkpoint's commit waits for every rank of the data axes, seq and
    # tensor (the group narrows itself where an axis is 1)
    commit_group = (groups.axes_group(DP_AXES + (AXIS_SEQ, AXIS_TENSOR), mesh)
                    if mesh is not None and dp * sp * tp > 1 else dp_group)

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
    params = list(model_parameters)
    # under offload_param the engine broadcasts the resident leaves and the
    # swapper each trunk layer as it fills its planes
    if dp * sp > 1 and not infinity:
        with torch.no_grad():  # DeepSpeed's _broadcast_model
            for p in params:
                if placement_of(p) is not None:
                    # zero.Init broadcast it over the data axes
                    group = seq_group
                elif expert_of(p) is not None and data_group is not None:
                    # other expert coordinates hold other experts
                    group = data_group
                else:
                    group = dp_seq_group or dp_group
                if group is not None and comm.get_world_size(group) > 1:
                    comm.broadcast(p.data, 0, group=group)
    engine = DeepSpeedEngine(
        loss_fn, params, cfg, module=model, device=dev,
        lr_schedule=lr_scheduler if callable(lr_scheduler) else None,
        dp_group=dp_group, expert_data_group=data_group,
        seq_group=seq_group, dp_seq_group=dp_seq_group,
        tp_group=tp_group, dp_tp_group=dp_tp_group,
        commit_group=commit_group,
        expert_group=mesh.group(AXIS_EXPERT) if mesh is not None and dp > 1
        else None)
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data, batch_size=int(cfg.train_batch_size),
            dp_rank=comm.get_rank(dp_group) if dp_group is not None else 0,
            dp_world_size=dp, collate_fn=collate_fn, shuffle=True,
            seed=cfg.seed, pin_memory=dev.type == "cuda")
        curriculum = cfg.curriculum()
        if curriculum:
            from .data_pipeline import (CurriculumDataLoader,
                                        CurriculumScheduler)

            sched = CurriculumScheduler(curriculum)
            engine.curriculum_scheduler = sched
            dataloader = CurriculumDataLoader(dataloader, sched,
                                              lambda: engine.global_steps)
    if cfg.hybrid_engine.enabled:
        from .hybrid_engine import DeepSpeedHybridEngine

        engine = DeepSpeedHybridEngine(
            engine, max_out_tokens=cfg.hybrid_engine.max_out_tokens)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler
