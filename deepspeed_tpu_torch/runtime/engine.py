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
layout.  Offload and the telemetry plane are not ported yet.
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
                        global_grad_norm, has_overflow, partial_norm_terms)
from .zero.sharder import (Placement, ZeroShardingPolicy, all_gather_flat,
                           all_reduce_flat, placement_of)

LossFn = Callable[[Any], torch.Tensor]


class DeepSpeedEngine:
    """``(loss_fn, fp32 master parameters, config)`` on one device; with a
    ``dp_group`` of more than one rank, one data-parallel rank of the
    model under ``zero_optimization.stage``."""

    def __init__(self, loss_fn: LossFn, params: List[torch.Tensor],
                 config: DeepSpeedConfig, module: Any = None,
                 device: DeviceLike = "cuda",
                 lr_schedule: Optional[Schedule] = None,
                 dp_group: Any = None):
        self.device = resolve_device(device)
        self.config = config
        self.loss_fn = loss_fn
        self.module = module
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

        self.dp_group = dp_group
        self.dp_world_size = (comm.get_world_size(dp_group)
                              if dp_group is not None else 1)
        zero = config.zero_optimization
        self.zero_stage = int(zero.stage)
        self.zero_policy = ZeroShardingPolicy.from_config(
            zero, self.dp_world_size)
        self._bucket = zero.reduce_bucket_elements
        #: per parameter: its placement (this rank's chunk of a cut leaf)
        #: or None (replicated)
        self.placements: List[Optional[Placement]] = self._place()
        self._cut = [i for i, pl in enumerate(self.placements)
                     if pl is not None]
        self._whole = [i for i, pl in enumerate(self.placements)
                       if pl is None]
        #: stage 2: each cut leaf's reduce-scattered gradient chunk
        self._grad_chunks: List[Optional[torch.Tensor]] = \
            [None] * len(self.params)
        if self.zero_stage == 2:
            for i in self._cut:
                self.params[i].register_post_accumulate_grad_hook(
                    self._reduce_scatter_hook(i))

        if lr_schedule is not None:
            self._schedule = lr_schedule
        elif config.scheduler is not None:
            self._schedule = get_lr_schedule(config.scheduler.type,
                                             config.scheduler.params)
        else:
            self._schedule = constant_lr(base_lr(config))
        self.lr_scheduler = LRScheduler(self._schedule)
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

        self.global_steps = 0     # train steps taken, skipped ones included
        self.micro_steps = 0
        self._skipped_steps = 0
        self._micro_in_step = 0   # microbatches accumulated since the step
        self._loss_sum: Optional[torch.Tensor] = None
        self._accumulation_boundary_forced: Optional[bool] = None
        self.last_metrics: Dict[str, Any] = {}
        self.checkpoint_engine = make_checkpoint_engine(config)
        #: the seqlen curriculum's scheduler when ``initialize`` built one
        self.curriculum_scheduler = None

    # -- ZeRO placement ---------------------------------------------------

    def _place(self) -> List[Optional[Placement]]:
        """Each parameter's placement under the stage; at stage 3 a cut
        parameter becomes this rank's chunk (one built inside ``zero.Init``
        already is)."""
        places: List[Optional[Placement]] = []
        for p in self.params:
            have = placement_of(p)
            if have is not None:
                if self.zero_stage != 3 or have.dp != self.dp_world_size:
                    raise ValueError(
                        f"a parameter was cut over {have.dp} ranks by "
                        "zero.Init; train it at zero_optimization.stage 3 "
                        f"over as many (stage {self.zero_stage}, "
                        f"{self.dp_world_size} ranks)")
                places.append(have)
                continue
            dim = self.zero_policy.opt_state_dim(tuple(p.shape))
            if dim is None:
                places.append(None)
                continue
            place = Placement.of(tuple(p.shape), dim, self.dp_group)
            if self.zero_stage == 3:
                with torch.no_grad():
                    p.data = place.cut(p.data)
                p.ds_placement = place
            places.append(place)
        return places

    def _masters(self) -> List[torch.Tensor]:
        """What the optimizer updates, per parameter: the whole fp32 master
        of a replicated leaf, this rank's chunk of a cut one (the
        parameter itself at stage 3, a view of the whole master at stages
        1-2)."""
        return [p if pl is None or self.zero_stage == 3
                else pl.view(p.detach())
                for p, pl in zip(self.params, self.placements)]

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
            chunk = place.reduce_scatter(p.grad)
            acc = chunks[i]
            chunks[i] = chunk if acc is None else acc.add_(chunk)
            p.grad = None
        return hook

    def _reduced_grads(self) -> List[torch.Tensor]:
        """Per parameter, its gradient summed over the group: this rank's
        chunk of a cut leaf, the whole of a replicated one (all-reduced in
        flat buckets)."""
        grads: List[torch.Tensor] = []
        for i, (p, pl) in enumerate(zip(self.params, self.placements)):
            if pl is not None and self.zero_stage == 2:
                g = self._grad_chunks[i]
                grads.append(g if g is not None else p.new_zeros(
                    pl.chunk_shape))
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if pl is not None and self.zero_stage == 1:
                g = pl.reduce_scatter(g)
                p.grad = None
            grads.append(g)
        if self.dp_world_size > 1 and self._whole:
            all_reduce_flat([grads[i] for i in self._whole], self.dp_group,
                            self._bucket)
        return grads

    def _norm_group(self) -> Any:
        """The group the norm's partial sums and the overflow flag are
        reduced over: the data-parallel group when some leaf is cut (the
        whole gradients are equal on every rank after their all-reduce)."""
        return self.dp_group if self._cut and self.dp_world_size > 1 \
            else None

    def _gather_masters(self, work: List[torch.Tensor]) -> None:
        """Stages 1-2: every rank's updated chunks into the whole masters."""
        if self.zero_stage in (1, 2) and self._cut:
            all_gather_flat([work[i] for i in self._cut],
                            [self.placements[i] for i in self._cut],
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
        return self.loss_fn(self._to_device(batch))

    __call__ = forward

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """Accumulate ``d(loss * scale / (gas x dp))`` into the masters'
        ``.grad`` (``scale`` is 1 without fp16)."""
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
        grads = self._reduced_grads()
        mean_loss = self._loss_sum
        if self.dp_world_size > 1:
            comm.all_reduce(mean_loss, group=self.dp_group)
        scale = self.loss_scale
        # 1/scale (fp16) and gas/n (a forced partial boundary) in one factor
        unscale = (1.0 / scale if self.fp16_enabled else 1.0) * gas / n
        if unscale != 1.0:
            mean_loss = mean_loss * unscale
        lr = self._schedule(self.optimizer.count)
        if self.fused_adam_enabled:
            overflow, grad_norm = self._fused_step(grads, unscale, lr)
        else:
            overflow, grad_norm = self._plain_step(grads, unscale, lr)
        if overflow:
            self._skipped_steps += 1
        if self.loss_scaler is not None:
            self.loss_scaler.update(overflow)
        self.zero_grad()
        self._micro_in_step, self._loss_sum = 0, None
        self.global_steps += 1
        self.lr_scheduler.last_step = self.optimizer.count
        self.last_metrics = {"loss": mean_loss, "grad_norm": grad_norm,
                             "lr": lr, "loss_scale": scale,
                             "overflow": overflow}
        if self.steps_per_print and \
                self.global_steps % int(self.steps_per_print) == 0:
            log_dist(f"step={self.global_steps} loss={float(mean_loss):.4f} "
                     f"lr={lr:.3e} grad_norm={float(grad_norm):.3f} "
                     f"loss_scale={scale:.0f}")
        return self.last_metrics

    def _split(self, grads: List[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        return ([grads[i] for i in self._cut],
                [grads[i] for i in self._whole])

    def _plain_step(self, grads: List[torch.Tensor], unscale: float,
                    lr: float) -> Tuple[bool, torch.Tensor]:
        """Unscale, overflow test, clip, then the optimizer's own step on
        this rank's chunk lists."""
        if unscale != 1.0:
            torch._foreach_mul_(grads, unscale)
        group = self._norm_group()
        overflow = (bool(has_overflow(grads, group)) if self.fp16_enabled
                    else False)
        if overflow:
            torch._foreach_zero_(grads)
        cut, whole = self._split(grads)
        grad_norm = (global_grad_norm(cut, whole, group) if group is not None
                     else global_grad_norm(grads))
        if self.gradient_clipping > 0:
            clip_grads_by_global_norm(grads, self.gradient_clipping,
                                      grad_norm)
        if not overflow:
            work = self._work_masters()
            self.optimizer.step(lr, work, grads)
            self._gather_masters(work)
        return overflow, grad_norm

    def _fused_step(self, grads: List[torch.Tensor], unscale: float,
                    lr: float) -> Tuple[bool, torch.Tensor]:
        """The norm of the still-scaled gradients (this rank's partial,
        all-reduced), then one fused Adam launch on this rank's chunk lists
        with ``mult = clip factor x unscale``, updating the optimizer's
        ``m``, ``v`` and ``count``."""
        group = self._norm_group()
        norm_terms = grads if group is None else \
            partial_norm_terms(*self._split(grads), group)
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
        overflow = (not bool(finite)) if self.fp16_enabled else False
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

    # -- evaluation and introspection --------------------------------------

    @torch.no_grad()
    def eval_loss(self, batch: Any) -> torch.Tensor:
        """The loss of this rank's rows, averaged over the data-parallel
        group (every rank calls it)."""
        loss = self.loss_fn(self._to_device(batch))
        if self.dp_world_size > 1:
            loss = comm.all_reduce(loss.float().clone(), comm.ReduceOp.AVG,
                                   group=self.dp_group)
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
        for name, p, pl in zip(self.param_names, self.params,
                               self.placements):
            whole = pl.gather(p.data) if pl is not None and \
                self.zero_stage == 3 else p.data
            out[name] = whole.to(torch.bfloat16).cpu()
        return out

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        self._grad_chunks[:] = [None] * len(self.params)

    def train(self, mode: bool = True) -> "DeepSpeedEngine":
        return self

    def eval(self) -> "DeepSpeedEngine":
        return self


def _rows(batch: Any) -> int:
    if isinstance(batch, dict):
        return next(iter(batch.values())).shape[0]
    return batch.shape[0]


def _slice_rows(batch: Any, lo: int, hi: int) -> Any:
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]
