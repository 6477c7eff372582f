"""The training engine: one device per rank, data parallel over ranks with
ZeRO stages 0-3.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``):
``train_step`` follows ``_build_train_step`` and ``_grad_core``:

1. split this rank's rows into ``gas`` microbatches; each loss is scaled
   by ``scale / (gas x dp)`` under fp16, else by ``1 / (gas x dp)``, and
   its gradient is accumulated into the fp32 master parameters' ``.grad``
   (``dp`` the data-parallel ranks: summed over them, the gradients are
   those of the global batch's mean loss, which the JAX engine takes);
2. at the boundary, the gradients are summed over the data-parallel group
   (below); under fp16: unscale, check for overflow (max-reduced over the
   group); on overflow zero the gradients and skip the update
   (parameters, optimizer state and the step count stay as they were),
   then update the loss scaler;
3. clip by global norm (or only measure it), over chunks;
4. take the optimizer step at ``lr = schedule(step)``, the step counted
   after;
5. return ``{loss, grad_norm, lr, loss_scale, overflow}``; the loss is the
   mean over the group's ranks, the JAX engine's global loss.

Data parallelism (``dp_group``, the mesh's ``DP_AXES`` group) and ZeRO
(``runtime/zero/sharder.py`` decides which leaves are cut, along which
dim; a leaf it does not cut is replicated and its gradient all-reduced in
flat buckets of ``reduce_bucket_size`` elements at the boundary):

* stage 0: every gradient all-reduced;
* stage 1: m and v exist for this rank's chunk of each cut leaf; each cut
  leaf's gradient is reduce-scattered at the boundary, the chunk of its
  fp32 master updated, and the masters all-gathered after the step;
* stage 2: as 1, but each cut leaf's gradient is reduce-scattered into a
  chunk accumulator as soon as a microbatch's backward has formed it
  (``register_post_accumulate_grad_hook``) and the whole gradient freed;
* stage 3: as 2, and the fp32 master of a cut leaf exists only as this
  rank's chunk (the parameter itself): the model gathers it where it
  reads it and the backward reduce-scatters its gradient
  (``sharder.compute_weight``).

The norm is global: each rank sums the squares of its chunks, group rank 0
adds the replicated leaves, and the partial sums are all-reduced.

Sequence parallelism (``seq_group``, the mesh's ``seq`` axis, and
``dp_seq_group``, its data axes and ``seq`` together): every weight is
whole on each ``seq`` rank, and each rank's loss is its share of the token
mean (``LlamaModel.loss``), so every gradient is summed over ``seq``: a
whole leaf's in one all-reduce over ``dp_seq_group``, a cut leaf's chunk
(ZeRO still cuts over the data axes alone) after its data-parallel
reduce-scatter.  The gradients, hence the norm, the overflow flag and the
step, are then the same on every ``seq`` rank; the reported loss and
``eval_loss`` are summed over ``seq`` before the data-parallel mean.

Expert parallelism (``expert_data_group``, the mesh's ``data`` axis): an
expert stack (``sharder.expert_of``) holds this expert coordinate's
experts, so its gradient is reduced over the ``data`` group alone, and
ZeRO cuts it over that group; every other leaf goes over the whole
data-parallel group.  Every microbatch's loss is still divided by the
whole group's size: an expert's gradient sums the tokens of every rank
that routed to it (the MoE layer's exchange), so the division leaves the
global batch's mean.  In the norm each expert coordinate's Σg² counts once:
a whole expert leaf is added by its ``data`` rank 0, a whole other leaf by
the group's rank 0, and the partial sums are all-reduced over the group;
the overflow flag is max-reduced over it.  Under ``seq`` too an expert
leaf's gradient, reduced over ``data``, is then summed over ``seq`` (each
``seq`` rank's experts saw its chunk's tokens).  With a ``tensor`` axis
(below) the ``data`` group is that of the rank's expert and tensor
coordinates: an expert stack, split over ``tensor`` by its FFN columns,
adds its Σg² on every tensor rank of its ``data`` rank 0, so each (expert,
tensor) block counts once.

Tensor parallelism (``tp_group``, the mesh's ``tensor`` axis, and
``dp_tp_group``, its data axes and ``tensor`` together): a leaf the model
splits over ``tensor`` (``sharder.tensor_of``) holds this rank's block,
every other leaf is whole on each tensor rank; the tensor ranks compute
one loss, and Megatron's *f* has already summed over ``tensor`` the
gradients of the whole leaves, which are therefore equal on the tensor
ranks and are not reduced over ``tensor``.  The data-parallel group, the
ZeRO placements and the gradient reductions are those of the rank's
tensor coordinate.  In the norm a split leaf's Σg² is added on every
tensor rank, a whole leaf's once (tensor rank 0), and the partial sums,
like the overflow flag, are reduced over ``dp_tp_group``.  With a
``seq`` axis too, every group above is that of the rank's ``seq`` (and
tensor) coordinate: the gradients, summed over ``seq`` before the norm,
are equal on the ``seq`` ranks, so each ``seq`` coordinate reduces the
same norm over its own data x tensor ranks and no leaf counts ``sp`` or
``tp`` times.

Under ``kernels.fused_adam`` (an Adam-family optimizer from the config;
anything else logs and keeps the plain step, as the JAX engine's
``fused_ok`` gate does) steps 2-4 are the two CUDA kernels of
``ops/kernels/fused_adam.py``, counterparts of ``_grad_core(fused_prep=
True)`` and ``_build_fused_train_step``, on this rank's chunk lists: one
``tree_sqsum`` over the still-scaled gradients (the chunks, and the
replicated leaves on group rank 0) gives the partial Σg², all-reduced
over the group; an fp16 overflow is a raw norm that is not finite, the
clip factor comes from the finite part, and unscale × clip × overflow
zero fold into one multiplier on the device that the one ``fused_adam``
launch applies; an fp16 overflow skips the launch and the count.  No
gradient is rescaled in place, and a bf16 or fp32 step never reads the
norm on the host.

The DeepSpeed-style ``forward`` / ``backward`` / ``step`` are the same
three stages driven by the caller: ``forward`` returns the microbatch's
loss with its graph, ``backward`` scales it and accumulates its gradient
(reducing nothing, except stage 2's reduce-scatters and stage 3's, which
run in the backward itself), ``step`` does 2-5 at the accumulation
boundary (``train_step`` is built from them).  The JAX engine compiled the
whole step into one program and kept its state functional; here PyTorch
runs eagerly and updates the parameters in place.  ``loss`` and
``grad_norm`` in the metrics are 0-dim fp32 tensors on the device (read
them when needed: reading syncs); ``lr``, ``loss_scale`` and ``overflow``
are host numbers.  Every rank of the group must call ``train_step``,
``step`` and ``eval_loss`` alike: they issue collectives.

Checkpoints (``runtime/checkpointing.py``): ``save_checkpoint`` writes this
rank's slices of the state (fp32 masters, optimizer state, step count,
loss scaler) through the configured checkpoint engine (sync or async),
``load_checkpoint`` loads any stage's and any rank count's checkpoint into
this engine's placement, ``load_universal_checkpoint`` the universal
layout.  The telemetry plane is not ported yet.

ZeRO-Offload (``zero_optimization.offload_optimizer``, JAX
``_build_grad_step`` / ``_offload_train_step``): the fp32 masters and the
optimizer state of this rank's part of each leaf live in host memory
(``runtime/zero/offload.py``); under ``bf16`` with the Adam family the
card's parameters are bf16 (the wire: no fp32 master or moment stays on
the card), each microbatch's gradient is summed in fp32 by a
post-accumulate hook, and at the boundary the reduced, unscaled and
clipped gradients go to the host, the C++ optimizer steps, and the
updated values come back (all-gathered at stages 1-2, as the masters
are).  fp16 skips the step on an overflow, as the JAX engine does.

ZeRO++ (JAX ``engine.py:264-289``, ``:1135-1316``; a Llama-family model,
on the data axes alone: ``initialize`` refuses the rest):

* qwZ (``zero_quantized_weights``, any stage): each parameter the JAX
  engine quantizes (``qwz_compress_tree``'s threshold, counted on JAX's
  stacked leaf) carries its ``QwzAxis`` and the model reads it through the
  int8 round trip (``sharder.compute_weight``; gathered as int8 at
  stage 3), straight-through;
* qgZ (``zero_quantized_gradients``): at stages 0-2 every gradient, summed
  over the microbatches, takes the int8 two-hop all-reduce at the boundary
  (``qgz.quantized_allreduce``; stage 2 too, as JAX cuts the gradient only
  after its second hop: no reduce-scatter in the backward); at stage 3 a
  cut leaf's whole gradient goes one int8 hop
  (``qgz.quantized_reduce_scatter``) from the backward at gas 1, or summed
  over the microbatches in fp32 and sent at the boundary (JAX quantizes
  the step's sum), and a whole leaf's takes the two hops.  Under fp16 a
  gradient that is not finite on some rank before the int8 wire skips the
  step (the wire would zero or hide it: ROADMAP Queue 3);
* hpZ (``zero_hpz_partition_size`` at stage 3, equal to the ``data``
  axis): a cut leaf's master is this rank's ``1/hpz`` chunk over the
  ``data`` group (what the model gathers), its gradient is reduce-scattered
  and its m and v held over the whole data-parallel group (``1/dp``: a
  piece inside the chunk), and after the update the pieces are
  all-gathered over ``expert`` into each chunk.

``last_wire`` holds the bytes of the last step's collectives by verb and
dtype (``comm.wire_counts``), from its first microbatch's forward to the
end of its ``step``.

ZeRO-Infinity (``zero_optimization.offload_param``): the model must
provide the layer-streaming protocol (``embed_fwd``, ``decoder_layer``,
``head_loss``, ``batch_labels``; JAX ``engine.py:116-140``), and its
parameters may live on the CPU: the trunk never goes to the card whole
(``runtime/swap_tensor/``), only the resident subtree does.  ``train_step``
and ``eval_loss`` run the streamed step; ``forward`` / ``backward`` /
``step`` buffer the microbatches and stream them at the boundary (a
partial boundary with its own accumulation count, JAX :2304).  On the
data axes and ``seq`` each rank's host planes hold its ``1/world`` of every
layer (the swapper gathers the wire and reduce-scatters the gradients);
the resident leaves are rank 0's on every rank, as the trunk's layers are.
Under tensor parallelism each tensor coordinate streams its own planes
(its blocks of the split leaves, the whole norms), cut over its data x
``seq`` group, and the norm adds the split leaves' Σg² over ``tensor``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..comm import comm
from ..ops.kernels.fused_adam import (MultiTensorPlan, fused_adam,
                                      tree_sqsum)
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import log_dist
from . import checkpointing
from .checkpoint_engine import make_checkpoint_engine
from .config import DeepSpeedConfig
from .lr_schedules import (LRScheduler, Schedule, constant_lr,
                           get_lr_schedule)
from .optimizers import Adam, base_lr, build_optimizer
from .precision import (DynamicLossScaler, clip_grads_by_global_norm,
                        global_grad_norm, has_overflow)
from .zero.qgz import quantized_allreduce, quantized_reduce_scatter
from .zero.qwz import qwz_axis
from .zero.sharder import (Placement, ZeroShardingPolicy, all_gather_flat,
                           all_reduce_flat, expert_of, placement_of,
                           tensor_of)

LossFn = Callable[[Any], torch.Tensor]


class DeepSpeedEngine:
    """``(loss_fn, fp32 master parameters, config)`` on one device; with a
    ``dp_group`` of more than one rank, one data-parallel rank of the
    model under ``zero_optimization.stage``."""

    def __init__(self, loss_fn: LossFn, params: List[torch.Tensor],
                 config: DeepSpeedConfig, module: Any = None,
                 device: DeviceLike = "cuda",
                 lr_schedule: Optional[Schedule] = None,
                 dp_group: Any = None, expert_data_group: Any = None,
                 seq_group: Any = None, dp_seq_group: Any = None,
                 tp_group: Any = None, dp_tp_group: Any = None,
                 commit_group: Any = None, expert_group: Any = None):
        self.device = resolve_device(device)
        self.config = config
        self.loss_fn = loss_fn
        self.module = module
        zero = config.zero_optimization
        self.infinity = None
        self.offload_opt = None
        self.offload_enabled = zero.offload_optimizer_device() != "none"
        self.compute_dtype = config.dtype()
        model_dtype = getattr(getattr(module, "config", None), "dtype", None)
        if model_dtype is not None and model_dtype != self.compute_dtype:
            raise ValueError(f"the model computes in {model_dtype}, the "
                             f"config asks for {self.compute_dtype} "
                             "(bf16.enabled / fp16.enabled)")
        self.fp16_enabled = config.fp16.enabled is True
        self.bf16_enabled = config.bf16.enabled is True
        self.gradient_accumulation_steps = int(
            config.gradient_accumulation_steps)
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        clip = config.gradient_clipping
        self.gradient_clipping = 0.0 if isinstance(clip, str) else float(clip)
        self.steps_per_print = config.steps_per_print
        self.zero_stage = int(zero.stage)
        if lr_schedule is not None:
            self._schedule = lr_schedule
        elif config.scheduler is not None:
            self._schedule = get_lr_schedule(config.scheduler.type,
                                             config.scheduler.params)
        else:
            self._schedule = constant_lr(base_lr(config))
        self.lr_scheduler = LRScheduler(self._schedule)
        self.tp_world_size = (comm.get_world_size(tp_group)
                              if tp_group is not None else 1)
        self.tp_group = tp_group if self.tp_world_size > 1 else None
        self.tp_rank = (comm.get_rank(self.tp_group)
                        if self.tp_group is not None else 0)
        self._dp_tp_group = dp_tp_group if self.tp_group is not None \
            else None
        #: the data axes, ``seq`` and ``tensor`` together: the group a
        #: checkpoint's commit waits for
        self._commit_group = commit_group
        self._refuse_zeropp(zero)
        if zero.offload_param_device() != "none":
            self._init_infinity(dp_group, seq_group, dp_seq_group)
            return
        self.params = [p for p in params if p.requires_grad]
        named = ({id(p): n for n, p in module.named_parameters()}
                 if isinstance(module, torch.nn.Module) else {})
        #: each parameter's name in checkpoints (the module's, else its
        #: index among the trainable parameters)
        self.param_names = [named.get(id(p), f"param_{i}")
                            for i, p in enumerate(self.params)]
        for p in self.params:
            if p.device.type != self.device.type:
                raise ValueError(f"a parameter is on {p.device}, the engine "
                                 f"was asked to run on {self.device}")
            if p.dtype != torch.float32:
                raise TypeError(
                    f"parameters must be fp32 masters, got {p.dtype}: build "
                    "the model with LlamaConfig(param_dtype=torch.float32)")

        self.dp_group = dp_group
        self.dp_world_size = (comm.get_world_size(dp_group)
                              if dp_group is not None else 1)
        self._init_seq(seq_group, dp_seq_group)
        #: the group an expert leaf's gradient is reduced over (the
        #: ``data`` axis; None: the data-parallel group)
        self.expert_data_group = (expert_data_group if self.dp_world_size
                                  > 1 else None)
        self._data_rank = (comm.get_rank(self.expert_data_group)
                           if self.expert_data_group is not None else 0)
        self.zero_policy = ZeroShardingPolicy.from_config(
            zero, self.dp_world_size, comm.get_world_size(
                self.expert_data_group) if self.expert_data_group
            is not None else None)
        #: hpZ: the group the updated pieces are gathered over into each
        #: rank's master chunk (the ``expert`` axis)
        self._hpz_group = (expert_group if self.zero_stage == 3
                           and self.zero_policy.secondary else None)
        if self.zero_stage == 3 and self.zero_policy.secondary and \
                expert_group is None:
            raise ValueError("zero_hpz_partition_size: the engine needs the "
                             "mesh's expert group (initialize passes it)")
        self.qwz_enabled = bool(zero.zero_quantized_weights)
        self.qgz_enabled = bool(zero.zero_quantized_gradients) and \
            self.dp_world_size > 1
        self._expert_policy = ZeroShardingPolicy.from_config(
            zero, comm.get_world_size(self.expert_data_group)
            if self.expert_data_group is not None else self.dp_world_size)
        self._bucket = zero.reduce_bucket_elements
        self._experts = [expert_of(p) for p in self.params]
        self._tensor = [tensor_of(p) if self.tp_group is not None else None
                        for p in self.params]
        for shard in self._experts:
            if shard is not None and shard.ep > 1 and \
                    self.expert_data_group is None:
                raise ValueError(
                    "the model's experts are split over an expert axis of "
                    f"{shard.ep}; initialize needs the mesh (mesh=...) "
                    "whose data axis reduces them")
        #: per parameter: its placement (this rank's chunk of a cut leaf)
        #: or None (replicated)
        self.placements: List[Optional[Placement]] = self._place()
        self._cut = [i for i, pl in enumerate(self.placements)
                     if pl is not None]
        #: the whole leaves by the group that reduces their gradients
        self._whole = [i for i, pl in enumerate(self.placements)
                       if pl is None and not self._is_expert(i)]
        self._whole_expert = [i for i, pl in enumerate(self.placements)
                              if pl is None and self._is_expert(i)]
        #: stage 2: each cut leaf's reduce-scattered gradient chunk
        self._grad_chunks: List[Optional[torch.Tensor]] = \
            [None] * len(self.params)
        #: per parameter, its fp32 gradient summed over the microbatches
        #: when the card's parameters are 16-bit (the offload wire) or a
        #: stage-3 qgZ leaf waits for the boundary
        self._grad_acc: List[Optional[torch.Tensor]] = \
            [None] * len(self.params)
        #: fp16 under qgZ: a local gradient not finite before the int8 wire
        self._qgz_bad: List[Optional[torch.Tensor]] = [None]
        if self.zero_stage == 2 and not self.qgz_enabled:
            for i in self._cut:
                self.params[i].register_post_accumulate_grad_hook(
                    self._reduce_scatter_hook(i))
        self._init_zeropp(module)

        self.optimizer = build_optimizer(config, self._masters())
        self.fused_adam_enabled = False
        self._fused_plan: Optional[MultiTensorPlan] = None
        self._norm_plan: Optional[MultiTensorPlan] = None
        if config.kernels.fused_adam:
            # the config's adam | fusedadam | adamw | deepspeedcpuadam
            if isinstance(self.optimizer, Adam):
                self.fused_adam_enabled = True
                log_dist("kernels.fused_adam: two-kernel Adam step active "
                         f"({self.optimizer.fused_config()})")
            else:
                log_dist("kernels.fused_adam requested but the optimizer is "
                         f"{type(self.optimizer).__name__}, not Adam or "
                         "AdamW: keeping the plain step")
        self.loss_scaler = (DynamicLossScaler.from_config(config.fp16)
                            if self.fp16_enabled else None)
        self._fp32_grad_hooks = False
        if self.offload_enabled:
            self._init_offload()
        self._init_counters()

    def _init_seq(self, seq_group: Any, dp_seq_group: Any) -> None:
        """The ``seq`` group (None at sp 1) and the group the whole leaves'
        gradients and the loss are summed over: the data axes and ``seq``
        (None in a world of one)."""
        self.sp_world_size = (comm.get_world_size(seq_group)
                              if seq_group is not None else 1)
        self.seq_group = seq_group if self.sp_world_size > 1 else None
        self.sp_rank = (comm.get_rank(self.seq_group)
                        if self.seq_group is not None else 0)
        self._sum_group = (dp_seq_group if self.seq_group is not None
                           else self.dp_group if self.dp_world_size > 1
                           else None)

    def _refuse_zeropp(self, zero: Any) -> None:
        """JAX's refusals of ZeRO++ with offload or Infinity
        (``engine.py:267-289``), in its words; hpZ with them names its
        ROADMAP item."""
        offload = (zero.offload_optimizer_device() != "none"
                   or zero.offload_param_device() != "none")
        if not offload:
            return
        if zero.zero_quantized_weights:
            raise NotImplementedError(
                "zero_quantized_weights + offload/infinity not supported "
                "(those paths own their own param movement)")
        if zero.zero_quantized_gradients:
            raise NotImplementedError(
                "zero_quantized_gradients + offload not supported yet")
        if int(zero.zero_hpz_partition_size or 1) > 1 and zero.stage >= 3:
            raise NotImplementedError(
                "zero_hpz_partition_size with offload_optimizer or "
                "offload_param is not ported yet (ROADMAP Queue 1 item 4c)")

    def _init_zeropp(self, module: Any) -> None:
        """qwZ: each parameter's ``QwzAxis`` (None: read as it is) from the
        model's JAX view (``qwz_view``); qgZ and hpZ at stage 3: each cut
        leaf's gradient sink."""
        view = getattr(module, "qwz_view", None)
        if self.qwz_enabled and view is None:
            raise NotImplementedError(
                f"zero_quantized_weights: {type(module).__name__} has no "
                "qwz_view (its leaves' JAX layout); ROADMAP Queue 1 item 4c")
        threshold = self.zero_policy.persistence_threshold
        self._qgz_at_boundary = self.qgz_enabled and (
            self.gradient_accumulation_steps > 1 or bool(getattr(getattr(
                module, "config", None), "tie_embeddings", False)))
        sinks = self.zero_stage == 3 and (self.qgz_enabled or
                                          self._hpz_group is not None)
        for i, (name, p) in enumerate(zip(self.param_names, self.params)):
            p.ds_qwz = (qwz_axis(*view(name), threshold)
                        if self.qwz_enabled else None)
            p.ds_grad_sink = (self._grad_sink(i) if sinks and
                              self.placements[i] is not None else None)

    def _grad_sink(self, i: int) -> Callable[[torch.Tensor], None]:
        """Stage 3 under qgZ or hpZ: what the backward does with cut leaf
        ``i``'s whole fp32 gradient: the int8 reduce-scatter (qgZ at gas
        1), the sum over the microbatches (qgZ at a later boundary), or
        the reduce-scatter into this rank's ``1/dp`` piece (hpZ)."""
        place, chunks, acc = self.placements[i], self._grad_chunks, \
            self._grad_acc
        qgz, boundary = self.qgz_enabled, self._qgz_at_boundary
        bad = self._qgz_bad if self.fp16_enabled and qgz else None

        def sink(g: torch.Tensor) -> None:  # holds no engine: no cycle
            if boundary:
                acc[i] = g.clone() if acc[i] is None else acc[i].add_(g)
                return
            if bad is not None:
                _mark_bad(bad, g)
            chunk = (quantized_reduce_scatter(g, place.group, place.dim,
                                              average=False,
                                              order=place.order)
                     if qgz else place.reduce_scatter(g))
            chunks[i] = chunk if chunks[i] is None else chunks[i].add_(chunk)
        return sink

    def _init_counters(self) -> None:
        self.global_steps = 0     # train steps taken, skipped ones included
        self.micro_steps = 0
        self._skipped_steps = 0
        self._micro_in_step = 0   # microbatches accumulated since the step
        self._loss_sum: Optional[torch.Tensor] = None
        self._accumulation_boundary_forced: Optional[bool] = None
        self.last_metrics: Dict[str, Any] = {}
        #: bytes of the last step's collectives by ``"verb/dtype"``
        self.last_wire: Dict[str, int] = {}
        self._wire_mark = comm.wire_counts()
        self.checkpoint_engine = make_checkpoint_engine(self.config)
        #: the seqlen curriculum's scheduler when ``initialize`` built one
        self.curriculum_scheduler = None
        self._pending_batch: Any = None
        self._buffered: List[Any] = []

    # -- offload and Infinity -----------------------------------------------

    def _init_offload(self) -> None:
        """Masters and optimizer state to the host; under bf16 with the
        Adam family the card's parameters become bf16 (JAX ``engine.py``
        :751-780) and gradients are summed in fp32 by hooks."""
        from .zero.offload import HOST_ADAM, CPUOffloadOptimizer

        cfg = self.config
        opt_cfg = cfg.optimizer
        name = opt_cfg.type if opt_cfg is not None else "AdamW"
        wire_bf16 = self.bf16_enabled and name.lower().replace(
            "_", "") in HOST_ADAM
        wire = torch.bfloat16 if wire_bf16 else torch.float32
        if self.config.kernels.fused_adam:
            log_dist("kernels.fused_adam requested but offload_optimizer "
                     "runs the host optimizer: keeping it")
        self.offload_opt = CPUOffloadOptimizer(
            [m.detach() for m in self._masters()], name,
            dict(opt_cfg.params) if opt_cfg is not None else {},
            self.device, wire_dtype=wire)
        self.optimizer = self.offload_opt
        self.fused_adam_enabled = False
        if wire_bf16:
            with torch.no_grad():
                for p in self.params:
                    p.data = p.data.to(torch.bfloat16)
            self._fp32_grad_hooks = True
            for i, p in enumerate(self.params):
                if not (self.zero_stage == 2 and self.placements[i]
                        is not None):
                    p.register_post_accumulate_grad_hook(
                        self._fp32_grad_hook(i))

    def _fp32_grad_hook(self, i: int) -> Callable[[torch.Tensor], None]:
        acc = self._grad_acc

        def hook(p: torch.Tensor) -> None:  # holds no engine: no cycle
            g = p.grad.float()
            acc[i] = g if acc[i] is None else acc[i].add_(g)
            p.grad = None
        return hook

    def _init_infinity(self, dp_group: Any, seq_group: Any,
                       dp_seq_group: Any) -> None:
        """ZeRO-Infinity (JAX ``engine.py:116-140`` and ``_init_state``
        :662): the streaming executor owns the trunk; ``self.params`` are
        the resident leaves on the card, broadcast from rank 0 of the data
        axes and ``seq`` (the swapper broadcasts each trunk layer as it
        fills the planes, so no rank holds a second copy of the trunk)."""
        from .swap_tensor import PROTOCOL, LayerStreamingEngine

        config, module = self.config, self.module
        if not all(callable(getattr(module, m, None)) for m in PROTOCOL):
            raise ValueError(
                "offload_param requires a layer-streamable module "
                "(embed_fwd/decoder_layer/head_loss protocol — see "
                "runtime/swap_tensor/infinity_engine.py); "
                f"{type(module).__name__} does not implement it")
        self.dp_group = dp_group
        self.dp_world_size = (comm.get_world_size(dp_group)
                              if dp_group is not None else 1)
        self._init_seq(seq_group, dp_seq_group)
        self.expert_data_group, self._data_rank = None, 0
        self.qwz_enabled = self.qgz_enabled = False  # refused with offload
        self.infinity = LayerStreamingEngine(
            module, config, self._schedule, self.device,
            group=self._sum_group, seq_group=self.seq_group,
            tp_group=self.tp_group)
        inf = self.infinity
        if self._sum_group is not None:
            with torch.no_grad():
                for p in inf.resident.values():
                    comm.broadcast(p.data, 0, group=self._sum_group)
        self.params = list(inf.resident.values())
        self.param_names = list(inf.resident)
        self.placements = [None] * len(self.params)
        self._experts = [None] * len(self.params)
        self._tensor = [tensor_of(p) if self.tp_group is not None else None
                        for p in self.params]
        self._cut, self._whole, self._whole_expert = [], [], []
        self._grad_chunks = [None] * len(self.params)
        self._grad_acc = [None] * len(self.params)
        self._fp32_grad_hooks = False
        self.optimizer = inf.res_opt
        self.fused_adam_enabled = False
        self.loss_scaler = inf.scaler
        self._init_counters()

    # -- ZeRO placement ---------------------------------------------------

    def _is_expert(self, i: int) -> bool:
        """Whether leaf ``i`` is reduced over the ``data`` group."""
        return self._experts[i] is not None and \
            self.expert_data_group is not None

    def leaf_group_rank(self, i: int) -> int:
        """This rank's place in the group leaf ``i`` is reduced over (a
        whole leaf's state is written and counted by its rank 0)."""
        if self._is_expert(i):
            return self._data_rank
        return comm.get_rank(self.dp_group) if self.dp_world_size > 1 else 0

    def _place(self) -> List[Optional[Placement]]:
        """Each parameter's placement under the stage; at stage 3 a cut
        parameter becomes this rank's chunk (one built inside ``zero.Init``
        already is).  An expert leaf is cut over the ``data`` group, the
        threshold counting its every expert."""
        places: List[Optional[Placement]] = []
        hpz = self.zero_policy.hpz if self._hpz_group is not None else 1
        for i, p in enumerate(self.params):
            have = placement_of(p)
            if have is not None and hpz > 1:
                raise ValueError(
                    "zero_hpz_partition_size: build the model whole (outside "
                    "zero.Init); the engine cuts its masters over the data "
                    "axis")
            if have is not None:
                if self.zero_stage != 3 or have.dp != self.dp_world_size:
                    raise ValueError(
                        f"a parameter was cut over {have.dp} ranks by "
                        "zero.Init; train it at zero_optimization.stage 3 "
                        f"over as many (stage {self.zero_stage}, "
                        f"{self.dp_world_size} ranks)")
                places.append(have)
                continue
            tshard = self._tensor[i]
            taken, tp = (tshard.dim, tshard.tp) if tshard is not None \
                else (None, 1)
            if self._is_expert(i):
                shard = self._experts[i]
                dim = self._expert_policy.opt_state_dim(
                    tuple(p.shape), p.numel() * shard.ep * tp, taken)
                group = self.expert_data_group
            else:
                dim = self.zero_policy.opt_state_dim(
                    tuple(p.shape), p.numel() * tp, taken)
                group = self.dp_group
            if dim is None:
                places.append(None)
                continue
            if hpz > 1:  # each rank's 1/dp piece inside its 1/hpz chunk
                place, master = self._hpz_placements(tuple(p.shape), dim,
                                                     hpz)
            else:
                place = master = Placement.of(tuple(p.shape), dim, group)
            if self.zero_stage == 3:
                with torch.no_grad():
                    p.data = master.cut(p.data)
                p.ds_placement = master
            places.append(place)
        return places

    def _hpz_placements(self, shape: Tuple[int, ...], dim: int, hpz: int
                        ) -> Tuple[Placement, Placement]:
        """hpZ: (the gradient and optimizer-state piece, the master chunk)
        of a leaf cut along ``dim``.  Data-parallel rank ``g = e x hpz + d``
        (the mesh's expert-major order) holds master chunk ``d`` of ``hpz``
        over the ``data`` group and piece ``d x ep + e`` of ``dp`` over the
        whole group: piece ``e`` of its chunk."""
        dp = self.dp_world_size
        ep = dp // hpz
        order = [(g % hpz) * ep + g // hpz for g in range(dp)]
        place = Placement.of(shape, dim, self.dp_group, order)
        master = Placement.of(shape, dim, self.expert_data_group)
        if master.rank != comm.get_rank(self.dp_group) % hpz:
            raise ValueError("hpZ needs the mesh's (expert, data) layout: "
                             "build it with utils.groups.initialize_mesh")
        return place, master

    def _masters(self) -> List[torch.Tensor]:
        """What the optimizer updates, per parameter: the whole fp32 master
        of a replicated leaf, this rank's chunk of a cut one (the
        parameter itself at stage 3, a view of the whole master at stages
        1-2)."""
        out = []
        for p, pl in zip(self.params, self.placements):
            if pl is None or (self.zero_stage == 3 and pl.order is None):
                out.append(p)
            elif self.zero_stage == 3:  # hpZ: the piece inside the chunk
                n = pl.chunk_shape[pl.dim]
                out.append(p.detach().narrow(
                    pl.dim, pl.offset_in(placement_of(p)), n))
            else:
                out.append(pl.view(p.detach()))
        return out

    def _work_masters(self) -> List[torch.Tensor]:
        """:meth:`_masters` as the kernels take them: a chunk view that is
        strided or off a 16-byte boundary becomes a copy of its own, which
        the all-gather after the step writes back."""
        out = []
        for t in self._masters():
            if not t.is_contiguous() or (t.is_cuda and t.data_ptr() % 16):
                t = t.contiguous() if not t.is_contiguous() else t.clone()
            out.append(t)
        return out

    def _reduce_scatter_hook(self, i: int) -> Callable[[torch.Tensor], None]:
        """Stage 2: once a microbatch's backward has accumulated parameter
        ``i``'s whole gradient, reduce-scatter it into the chunk
        accumulator and free it."""
        place, chunks = self.placements[i], self._grad_chunks

        def hook(p: torch.Tensor) -> None:  # holds no engine: no cycle
            chunk = place.reduce_scatter(p.grad.float())
            acc = chunks[i]
            chunks[i] = chunk if acc is None else acc.add_(chunk)
            p.grad = None
        return hook

    def _reduced_grads(self) -> List[torch.Tensor]:
        """Per parameter, its gradient summed over the group (and over
        ``seq``): this rank's chunk of a cut leaf, the whole of a
        replicated one (all-reduced in flat buckets)."""
        if self.qgz_enabled:
            return self._qgz_reduced_grads()
        grads: List[torch.Tensor] = []
        for i, (p, pl) in enumerate(zip(self.params, self.placements)):
            if pl is not None and (self.zero_stage == 2 or (
                    self.zero_stage == 3 and self._hpz_group is not None)):
                g = self._grad_chunks[i]
                grads.append(g if g is not None else p.new_zeros(
                    pl.chunk_shape))
                continue
            g = self._grad_acc[i] if self._fp32_grad_hooks else p.grad
            if g is None:
                g = torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
            if pl is not None and self.zero_stage == 1:
                g = pl.reduce_scatter(g)
                p.grad = None
            grads.append(g)
        for whole, group in ((self._whole, self._sum_group),
                             (self._whole_expert, self.expert_data_group)):
            if whole and group is not None and \
                    comm.get_world_size(group) > 1:
                all_reduce_flat([grads[i] for i in whole], group,
                                self._bucket)
        rest = self._cut + self._whole_expert
        if self.seq_group is not None and rest:
            all_reduce_flat([grads[i] for i in rest], self.seq_group,
                            self._bucket)
        return grads

    def _qgz_reduced_grads(self) -> List[torch.Tensor]:
        """qgZ at the boundary (the data axes alone): each whole gradient
        through the int8 two hops, then cut at stages 1-2; at stage 3 a cut
        leaf's chunk from the backward's one hop, or its microbatches' sum
        sent now."""
        group, bad = self.dp_group, (self._qgz_bad if self.fp16_enabled
                                     else None)
        grads: List[torch.Tensor] = []
        for i, (p, pl) in enumerate(zip(self.params, self.placements)):
            if pl is not None and self.zero_stage == 3:
                g, full = self._grad_chunks[i], self._grad_acc[i]
                if full is not None:
                    if bad is not None:
                        _mark_bad(bad, full)
                    g = quantized_reduce_scatter(full, group, pl.dim,
                                                 average=False,
                                                 order=pl.order)
                grads.append(g if g is not None else p.new_zeros(
                    pl.chunk_shape))
                continue
            g = p.grad if p.grad is not None else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)
            if bad is not None:
                _mark_bad(bad, g)
            g = quantized_allreduce(g.float(), group, average=False)
            if pl is not None:
                g = pl.cut(g)
            p.grad = None
            grads.append(g)
        return grads

    def _qgz_overflow(self) -> bool:
        """fp16 under qgZ: whether a gradient was not finite on some rank
        before the int8 wire (max-reduced over the group)."""
        if not (self.fp16_enabled and self.qgz_enabled):
            return False
        flag = self._qgz_bad[0]
        self._qgz_bad[0] = None
        flag = (flag.float() if flag is not None else torch.zeros(
            (), device=self.device))
        comm.all_reduce(flag, comm.ReduceOp.MAX, group=self.dp_group)
        return bool(flag > 0)

    def _dp_split(self) -> bool:
        """Whether the gradients differ across the data-parallel group
        after their reduction: some leaf is cut, or some expert leaf
        differs across the expert axis (the whole gradients of the other
        leaves are equal on every rank after their all-reduce)."""
        split = self._cut or (self._whole_expert and comm.get_world_size(
            self.expert_data_group) < self.dp_world_size)
        return bool(split) and self.dp_world_size > 1

    def _norm_group(self) -> Any:
        """The group the norm's partial sums and the overflow flag are
        reduced over: the data-parallel group when :meth:`_dp_split`, and
        ``tensor`` with it under tensor parallelism."""
        if self.tp_group is not None:
            return self._dp_tp_group if self._dp_split() else self.tp_group
        return self.dp_group if self._dp_split() else None

    def _norm_terms(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """What this rank adds to the global Σg² (:meth:`_norm_group`
        sums it): its chunks of the cut leaves, each whole leaf on the
        rank 0 of the group that reduced it, and a leaf the tensor axis
        does not split on tensor rank 0 alone."""
        if self._norm_group() is None:
            return grads
        order = (self._cut + self._whole + self._whole_expert
                 if self._dp_split() else range(len(grads)))
        return [grads[i] for i in order
                if (self.tp_rank == 0 or self._tensor[i] is not None)
                and (i in self._cut or not self._dp_split()
                     or self.leaf_group_rank(i) == 0)]

    def _gather_masters(self, work: List[torch.Tensor]) -> None:
        """Stages 1-2: every rank's updated chunks into the whole masters;
        hpZ: every ``expert`` rank's pieces into this rank's master
        chunk."""
        if self.zero_stage in (1, 2) and self._cut:
            all_gather_flat([work[i] for i in self._cut],
                            [self.placements[i] for i in self._cut],
                            [self.params[i].data for i in self._cut],
                            self._bucket)
        elif self._hpz_group is not None and self._cut:
            pieces = [Placement.of(tuple(self.params[i].shape),
                                   self.placements[i].dim, self._hpz_group)
                      for i in self._cut]
            all_gather_flat([work[i] for i in self._cut], pieces,
                            [self.params[i].data for i in self._cut],
                            self._bucket)

    # -- the three stages -------------------------------------------------

    def _to_device(self, batch: Any) -> Any:
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return batch

    @property
    def loss_scale(self) -> float:
        return self.loss_scaler.scale if self.loss_scaler is not None else 1.0

    def forward(self, batch: Any) -> torch.Tensor:
        """The microbatch's loss, with its graph (unscaled, this rank's
        rows)."""
        if self.infinity is not None:
            self._pending_batch = batch
            return self.infinity.eval_loss(batch)
        if self._micro_in_step == 0:  # a step's collectives count from here
            self._wire_mark = comm.wire_counts()
        return self.loss_fn(self._to_device(batch))

    __call__ = forward

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """Accumulate ``d(loss * scale / (gas x dp))`` into the masters'
        ``.grad`` (``scale`` is 1 without fp16).  Under Infinity: queue
        the microbatch of the last ``forward`` for the streamed step."""
        if self.infinity is not None:
            if self._pending_batch is None:
                raise RuntimeError("backward() called without a prior "
                                   "forward()")
            self._buffered.append(self._pending_batch)
            self._pending_batch = None
            self._micro_in_step += 1
            self.micro_steps += 1
            return loss
        div = self.gradient_accumulation_steps * self.dp_world_size
        scaled = ((loss * self.loss_scale / div).float()
                  if self.fp16_enabled else loss / div)
        scaled.backward()
        part = scaled.detach().float()
        self._loss_sum = part if self._loss_sum is None else \
            self._loss_sum + part
        self._micro_in_step += 1
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        if self._accumulation_boundary_forced is not None:
            return self._accumulation_boundary_forced
        return self._micro_in_step >= self.gradient_accumulation_steps

    def set_gradient_accumulation_boundary(self, is_boundary: bool) -> None:
        self._accumulation_boundary_forced = is_boundary

    def step(self) -> Optional[Dict[str, Any]]:
        """At the accumulation boundary: reduce over the group, unscale,
        overflow check, clip, the optimizer step; returns the step's
        metrics (None before the boundary).  A boundary forced after ``n <
        gas`` microbatches averages over those ``n``, as the JAX engine's
        partial step does."""
        if not self.is_gradient_accumulation_boundary() or \
                self._micro_in_step == 0:
            return None
        n, gas = self._micro_in_step, self.gradient_accumulation_steps
        if self.infinity is not None:
            buffered, self._buffered = self._buffered, []
            self._micro_in_step = 0
            batch = _cat_rows(buffered)
            # a partial boundary streams its own count (JAX :2304)
            saved, self.infinity.gas = self.infinity.gas, n
            try:
                return self._infinity_step(batch)
            finally:
                self.infinity.gas = saved
        grads = self._reduced_grads()
        forced = self._qgz_overflow()
        mean_loss = self._loss_sum
        if self._sum_group is not None:
            comm.all_reduce(mean_loss, group=self._sum_group)
        scale = self.loss_scale
        # 1/scale (fp16) and gas/n (a forced partial boundary) in one factor
        unscale = (1.0 / scale if self.fp16_enabled else 1.0) * gas / n
        if unscale != 1.0:
            mean_loss = mean_loss * unscale
        lr = self._schedule(self.optimizer.count)
        if self.offload_opt is not None:
            overflow, grad_norm = self._offload_step(grads, unscale, lr)
        elif self.fused_adam_enabled:
            overflow, grad_norm = self._fused_step(grads, unscale, lr,
                                                   forced)
        else:
            overflow, grad_norm = self._plain_step(grads, unscale, lr,
                                                   forced)
        if overflow:
            self._skipped_steps += 1
        if self.loss_scaler is not None:
            self.loss_scaler.update(overflow)
        self.zero_grad()
        self._micro_in_step, self._loss_sum = 0, None
        self.global_steps += 1
        self.lr_scheduler.last_step = self.optimizer.count
        wire = comm.wire_counts()
        self.last_wire = {k: v - self._wire_mark.get(k, 0)
                          for k, v in wire.items()
                          if v != self._wire_mark.get(k, 0)}
        self._wire_mark = wire
        self.last_metrics = {"loss": mean_loss, "grad_norm": grad_norm,
                             "lr": lr, "loss_scale": scale,
                             "overflow": overflow}
        if self.steps_per_print and \
                self.global_steps % int(self.steps_per_print) == 0:
            log_dist(f"step={self.global_steps} loss={float(mean_loss):.4f} "
                     f"lr={lr:.3e} grad_norm={float(grad_norm):.3f} "
                     f"loss_scale={scale:.0f}")
        return self.last_metrics

    def _plain_step(self, grads: List[torch.Tensor], unscale: float,
                    lr: float, forced: bool = False
                    ) -> Tuple[bool, torch.Tensor]:
        """Unscale, overflow test (``forced``: qgZ saw one before its
        wire), clip, then the optimizer's own step on this rank's chunk
        lists."""
        if unscale != 1.0:
            torch._foreach_mul_(grads, unscale)
        group = self._norm_group()
        overflow = forced or (bool(has_overflow(grads, group))
                              if self.fp16_enabled else False)
        if overflow:
            torch._foreach_zero_(grads)
        grad_norm = global_grad_norm(self._norm_terms(grads), group)
        if self.gradient_clipping > 0:
            clip_grads_by_global_norm(grads, self.gradient_clipping,
                                      grad_norm)
        if not overflow:
            work = self._work_masters()
            self.optimizer.step(lr, work, grads)
            self._gather_masters(work)
        return overflow, grad_norm

    def _offload_step(self, grads: List[torch.Tensor], unscale: float,
                      lr: float) -> Tuple[bool, torch.Tensor]:
        """Unscale, overflow test, norm and clip as the plain step; then
        the host optimizer over this rank's parts, the updated values back
        into the card's parameters (all-gathered at stages 1-2)."""
        if unscale != 1.0:
            torch._foreach_mul_(grads, unscale)
        group = self._norm_group()
        overflow = (bool(has_overflow(grads, group)) if self.fp16_enabled
                    else False)
        if overflow:
            torch._foreach_zero_(grads)
        grad_norm = global_grad_norm(self._norm_terms(grads), group)
        if self.gradient_clipping > 0:
            clip_grads_by_global_norm(grads, self.gradient_clipping,
                                      grad_norm)
        if not overflow:
            work = self._work_masters()
            self.offload_opt.step(grads, lr, work)
            self._gather_masters(work)
        return overflow, grad_norm

    def _fused_step(self, grads: List[torch.Tensor], unscale: float,
                    lr: float, forced: bool = False
                    ) -> Tuple[bool, torch.Tensor]:
        """The norm of the still-scaled gradients (this rank's partial,
        all-reduced), then one fused Adam launch on this rank's chunk lists
        with ``mult = clip factor x unscale``, updating the optimizer's
        ``m``, ``v`` and ``count``."""
        group = self._norm_group()
        norm_terms = self._norm_terms(grads)
        work = self._work_masters()
        if self._fused_plan is None and self.device.type == "cuda":
            self._fused_plan = MultiTensorPlan(work)
            self._norm_plan = (self._fused_plan if norm_terms is grads
                               else MultiTensorPlan(norm_terms))
        raw_sq = tree_sqsum(norm_terms, self._norm_plan)
        if group is not None:
            comm.all_reduce(raw_sq, group=group)
        raw_norm = raw_sq.sqrt()
        finite = torch.isfinite(raw_norm)
        # fp16 only: the host reads the overflow flag to skip the step
        overflow = forced or ((not bool(finite)) if self.fp16_enabled
                              else False)
        grad_norm = torch.where(finite, raw_norm,
                                torch.zeros_like(raw_norm)) * unscale
        mult: Any = unscale
        if self.gradient_clipping > 0:
            mult = torch.clamp(self.gradient_clipping / (grad_norm + 1e-6),
                               max=1.0) * unscale
        if not overflow:
            opt = self.optimizer
            fused_adam(work, grads, opt.m, opt.v, opt.count + 1, lr,
                       mult, opt.fused_config(), self._fused_plan)
            opt.count += 1
            self._gather_masters(work)
        return overflow, grad_norm

    def train_step(self, batch: Any) -> Dict[str, Any]:
        """One optimizer step over this rank's rows of the global batch
        (its leading dim split into ``gas`` microbatches of consecutive
        rows; ``micro x gas`` rows on each of the ``dp`` ranks)."""
        if self._micro_in_step:
            raise RuntimeError("train_step() called with microbatches from "
                               "backward() still pending a step()")
        if self.infinity is not None:
            return self._infinity_step(batch)
        gas = self.gradient_accumulation_steps
        batch = self._to_device(batch)
        rows = _rows(batch)
        if rows % gas:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"gradient_accumulation_steps={gas}")
        forced, self._accumulation_boundary_forced = \
            self._accumulation_boundary_forced, None
        try:
            for i in range(gas):
                self.backward(self.forward(_slice_rows(
                    batch, i * rows // gas, (i + 1) * rows // gas)))
            return self.step()
        finally:
            self._accumulation_boundary_forced = forced

    def _infinity_step(self, batch: Any) -> Dict[str, Any]:
        """The streamed step (JAX dispatch :1606) and the engine's
        counters."""
        metrics = self.infinity.train_step(batch)
        if bool(metrics["overflow"]):
            self._skipped_steps += 1
        self.global_steps += 1
        self.lr_scheduler.last_step = self.optimizer.count
        self.last_metrics = metrics
        if self.steps_per_print and \
                self.global_steps % int(self.steps_per_print) == 0:
            log_dist(f"step={self.global_steps} "
                     f"loss={float(metrics['loss']):.4f} "
                     f"lr={metrics['lr']:.3e} "
                     f"grad_norm={float(metrics['grad_norm']):.3f} "
                     f"loss_scale={metrics['loss_scale']:.0f}")
        return metrics

    # -- evaluation and introspection --------------------------------------

    @torch.no_grad()
    def eval_loss(self, batch: Any) -> torch.Tensor:
        """The loss of this rank's rows (summed over ``seq``), averaged
        over the data-parallel group (every rank calls it; the streamed
        engine averages its own)."""
        if self.infinity is not None:
            return self.infinity.eval_loss(batch)
        loss = self.loss_fn(self._to_device(batch))
        if self._sum_group is not None:
            loss = comm.all_reduce(loss.float().clone(),
                                   group=self._sum_group).div_(
                                       self.dp_world_size)
        return loss

    def get_lr(self) -> List[float]:
        """The rate the next step applies (skipped steps do not count)."""
        self.lr_scheduler.last_step = self.optimizer.count
        return [float(self._schedule(self.optimizer.count))]

    def get_global_grad_norm(self) -> Optional[float]:
        if "grad_norm" not in self.last_metrics:
            return None
        return float(self.last_metrics["grad_norm"])

    def get_loss_scale(self) -> float:
        return self.loss_scale

    @property
    def overflow(self) -> bool:
        """fp16 skip signal of the last step."""
        return bool(self.last_metrics.get("overflow", False))

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps

    # -- checkpoints -------------------------------------------------------

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict[str, Any]] = None,
                        exclude_frozen_parameters: bool = False) -> str:
        """Write ``<save_dir>/<tag>/`` (default tag ``global_step{N}``);
        every rank of the group calls it.  Returns the tag directory."""
        return checkpointing.save_checkpoint(self, save_dir, tag,
                                             client_state)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_module_strict: bool = True,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False
                        ) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
        """``(tag directory, client_state)``, or ``(None, None)`` when
        ``load_dir`` holds no checkpoint."""
        return checkpointing.load_checkpoint(
            self, load_dir, tag, load_module_strict, load_optimizer_states,
            load_lr_scheduler_states, load_module_only)

    def load_universal_checkpoint(self, universal_dir: str) -> None:
        """Resume from a ``ds_to_universal`` directory at this engine's
        stage and ranks."""
        checkpointing.load_universal_checkpoint(self, universal_dir)

    @torch.no_grad()
    def _zero3_consolidated_16bit_state_dict(
            self, exclude_frozen_parameters: bool = False
            ) -> Dict[str, torch.Tensor]:
        """Every parameter whole, in bf16, on the host (a ZeRO-3 chunk is
        gathered: every rank calls it)."""
        out = {}
        for name, p in zip(self.param_names, self.params):
            pl = placement_of(p)
            whole = pl.gather(p.data) if pl is not None else p.data
            out[name] = whole.to(torch.bfloat16).cpu()
        return out

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        self._grad_chunks[:] = [None] * len(self.params)
        self._grad_acc[:] = [None] * len(self.params)

    def train(self, mode: bool = True) -> "DeepSpeedEngine":
        return self

    def eval(self) -> "DeepSpeedEngine":
        return self


def _mark_bad(cell: List[Optional[torch.Tensor]], g: torch.Tensor) -> None:
    """Record in ``cell[0]`` (a 0-dim bool, no host sync) whether ``g`` has
    an entry that is not finite."""
    bad = ~torch.isfinite(g).all()
    cell[0] = bad if cell[0] is None else cell[0] | bad


def _rows(batch: Any) -> int:
    if isinstance(batch, dict):
        return next(iter(batch.values())).shape[0]
    return batch.shape[0]


def _cat_rows(batches: List[Any]) -> Any:
    if len(batches) == 1:
        return batches[0]
    if isinstance(batches[0], dict):
        return {k: torch.cat([torch.as_tensor(b[k]) for b in batches])
                for k in batches[0]}
    return torch.cat([torch.as_tensor(b) for b in batches])


def _slice_rows(batch: Any, lo: int, hi: int) -> Any:
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]
