"""ZeRO-Infinity's layer-streaming executor: training a model whose
parameters and optimizer state do not fit on the card.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/infinity_engine.py``
(:class:`LayerStreamingEngine`).  The step is a Python
pipeline over the layers, their weights streamed from the host planes of
:class:`~.partitioned_param_swapper.PartitionedParamSwapper` into two
device buffers:

    forward:   copy layer i+1 in  ||  layer i's forward (no graph; only
               each layer's input is kept)
    backward:  copy layer i-1 in  ||  layer i's forward again and its
               backward (``torch.autograd.grad``: dx and the layer's
               weight gradients); the gradients copied off the card, the
               host Adam over them, the planes written behind

so the card holds two layers' wire weights, the layers' inputs and the
resident subtree (embedding, final norm, LM head), which stays on the card
in fp32 with the port's Adam (optax ``adamw``'s operation order,
``runtime/optimizers.py``).  The model provides ``embed_fwd``,
``decoder_layer`` and ``head_loss`` (``models/llama.py``; Mixtral's layer
returns its router's aux loss, whose gradient flows through the
backward's second cotangent, ``aux_loss_coef`` times the loss scale).

Two update paths, as in JAX:

* **fused** (``gas == 1``, no clipping, no fp16): each layer is updated as
  soon as its gradients exist, on the pipeline's worker thread, behind the
  remaining layers' backward;
* **stash** (otherwise): the gradients land in fp32 host planes (summed
  over the microbatches), the global norm is taken, and a second pass
  applies every layer's update times the unscale and clip factor.  Under
  fp16 the loss scaler lives on the host: a gradient that is not finite
  skips every update and rolls the Adam count back (``cancel_step``).

Flash launches a step under ``attn_impl="flash"``: each layer's forward
runs twice (streamed, then recomputed in the backward) and its backward
once, per microbatch: ``flash_fwd = 2 x L x gas``, ``flash_bwd_dq =
flash_bwd_dkv = L x gas``; ``eval_loss`` adds ``L`` forwards.  A layer is
never run under ``LlamaConfig.remat``: the recompute is the remat.

On more than one rank (``group``: the data-parallel and ``seq`` ranks;
JAX's multi-process engine, ``proc_world > 1``) each rank feeds its own
rows (every ``seq`` rank of a data coordinate the same whole rows) and the
swapper holds this rank's segment of every layer (its gathered wire, its
reduce-scattered gradients: ``partitioned_param_swapper``).  Under a
``seq`` axis each micro-batch is cut to this rank's ``S/sp`` chunk, the
labels made from the whole row first (``LlamaModel._seq_chunk``); the
layers run Ulysses inside ``decoder_layer`` (12 all-to-alls a layer a
micro-batch: 4 in the streamed forward, 4 in the backward's recompute, 4
in its backward) and ``head_loss`` returns the chunk's share of the token
mean.  The resident gradients are summed over the group and divided by
``dp`` (the data ranks averaged, ``seq`` summed) before the port's Adam,
so the resident leaves stay equal on every rank; the trunk's squared norm
is the sum of the ranks' segment norms in one all-reduce (JAX
``_host_sum``), and a gradient that is not finite on any rank makes every
rank skip.  The reported loss and ``eval_loss`` are summed over ``seq``
and averaged over the data ranks.

Under tensor parallelism (``tp_group``; JAX keeps each layer's tensor
split in the streamed layer's specs, ``infinity_engine.py:144-153``) each
tensor coordinate streams its own planes: ``group`` is its data x ``seq``
ranks, ``decoder_layer`` runs the split layer's *f* and *g*, and
``head_loss`` is the vocabulary-parallel loss on the head's ``V/tp``
rows (JAX ``head_loss_manual_tp``).  A plane mixes split leaves and whole
norms, so its Σg² is two sums (``swapper.sq_parts`` /
``stashed_sq_norm``): the split part is summed over the group and
``tensor``, the whole part over the group alone; the resident head's
rows count as split, the embedding and the final norm as whole.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ...comm import comm
from ...utils.logging import log_dist
from ..engine import _rows, _slice_rows
from ..optimizers import Adam
from ..zero.sharder import all_reduce_flat, tensor_of
from .partitioned_param_swapper import PartitionedParamSwapper

PROTOCOL = ("embed_fwd", "decoder_layer", "head_loss", "batch_labels")


def _zeros_if_none(grads, like) -> List[torch.Tensor]:
    return [g if g is not None else torch.zeros_like(t)
            for g, t in zip(grads, like)]


class LayerStreamingEngine:
    """The streamed train step over ``model`` on ``device``, its trunk
    (``model.layers``) in the swapper's tier; ``group`` (the data-parallel
    and ``seq`` ranks, None in one process) of which ``seq_group`` is the
    ``seq`` part."""

    def __init__(self, model: Any, config: Any,
                 schedule: Callable[[int], float], device: torch.device,
                 group: Any = None, seq_group: Any = None,
                 tp_group: Any = None):
        c = model.config
        self.model = model
        self.schedule = schedule
        self.device = device
        self.L = int(c.num_layers)
        self.compute_dtype = config.dtype()
        self.fp16 = config.fp16.enabled is True
        self.scaler = None
        if self.fp16:
            from ..precision import DynamicLossScaler

            self.scaler = DynamicLossScaler.from_config(config.fp16)

        opt_cfg = config.optimizer
        hp: Dict[str, Any] = {}
        if opt_cfg is not None:
            name = opt_cfg.type.lower().replace("_", "")
            if name not in ("adam", "adamw", "cpuadam", "deepspeedcpuadam",
                            "fusedadam"):
                raise NotImplementedError(
                    f"layer streaming drives the fused C++ Adam(W); optimizer "
                    f"{opt_cfg.type!r} is not supported here (Adam, AdamW)")
            for k in ("lr", "betas", "eps", "weight_decay"):
                v = opt_cfg.params.get(k)
                if v is not None and not isinstance(v, str):
                    hp[k] = v
            hp["adamw_mode"] = name not in ("adam", "fusedadam")
        self.aux_coef = float(getattr(c, "aux_loss_coef", 0.0))
        self.group = group if group is not None and \
            comm.get_world_size(group) > 1 else None
        self.world = (comm.get_world_size(self.group)
                      if self.group is not None else 1)
        self.sp = (comm.get_world_size(seq_group)
                   if seq_group is not None else 1)
        #: the data-parallel ranks: the divisor of the summed gradients
        self.dp = self.world // self.sp
        #: the tensor group (None at tp 1): the split leaves' Σg² is
        #: summed over it
        self.tp_group = tp_group if tp_group is not None and \
            comm.get_world_size(tp_group) > 1 else None

        zcfg = config.zero_optimization
        self._bucket = zcfg.reduce_bucket_elements
        pcfg = zcfg.offload_param
        nvme_path = pcfg.nvme_path if pcfg.device == "nvme" else None
        ocfg = zcfg.offload_optimizer
        pipeline = True if ocfg is None else ocfg.pipelined
        wire = self.compute_dtype
        resident = {n: p for n, p in model.named_parameters()
                    if not n.startswith("layers.")}
        # the trunk's planes one layer at a time; on the cpu tier in one
        # process each layer's parameters then become views of its fp32
        # masters (no second host copy of the trunk), on nvme or on more
        # ranks (a segment) one broadcast zero each
        layers = [list(layer.named_parameters()) for layer in model.layers]
        #: a layer's leaves split over ``tensor``, by local name, and the
        #: resident ones (the head's vocabulary rows)
        self.layer_tensor = {n: tensor_of(p) for n, p in layers[0]
                             if tensor_of(p) is not None}
        self.resident_split = frozenset(n for n, p in resident.items()
                                        if tensor_of(p) is not None)

        def on_filled(i: int, views: Optional[Dict[str, torch.Tensor]]
                      ) -> None:
            for name, p in model.layers[i].named_parameters():
                p.requires_grad_(False)
                p.data = (views[name] if views is not None else
                          torch.zeros((), dtype=p.dtype).expand(p.shape))

        self.swapper = PartitionedParamSwapper(
            layers, device=device, wire_dtype=wire, nvme_path=nvme_path,
            buffer_count=int(pcfg.buffer_count or 4),
            aio_config=config.aio, adam_hparams=hp, pipeline=pipeline,
            on_filled=on_filled, group=self.group, grad_scale=1.0 / self.dp,
            split_leaves=tuple(self.layer_tensor))
        del layers
        with torch.no_grad():
            for p in resident.values():
                p.data = p.data.to(device=device, dtype=torch.float32)
        self.resident = resident
        b = hp.get("betas", (0.9, 0.999))
        self.res_opt = Adam(list(resident.values()), betas=b,
                            eps=float(hp.get("eps", 1e-8)),
                            weight_decay=float(hp.get("weight_decay", 0.0)),
                            decoupled=True)
        gas = config.gradient_accumulation_steps
        self.gas = int(gas) if isinstance(gas, int) else 1
        clip = config.gradient_clipping
        self.clip = 0.0 if isinstance(clip, str) else float(clip or 0.0)
        self.global_steps = 0
        self.last_metrics: Dict[str, Any] = {}
        self.last_timings: Dict[str, float] = {}
        log_dist(f"ZeRO-Infinity streaming engine: {self.L} layers, "
                 f"{self.swapper.n_elems * self.L:,} trunk params off the "
                 f"device ({'nvme' if nvme_path else 'cpu'} tier, "
                 f"{self.world} ranks, sp {self.sp}), "
                 f"{self.resident_param_count():,} resident on {device}")

    # -- the pieces -------------------------------------------------------

    def _layer_fwd(self, lp: Dict[str, torch.Tensor], x: torch.Tensor):
        with torch.no_grad():
            return self.model.decoder_layer(lp, x)

    def _layer_bwd(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
                   dx: torch.Tensor, ls: float):
        """The layer's forward again from its input, then ``(dx_prev,
        {name: weight gradient})``: cotangents ``dx`` and, for a router's
        aux loss, ``aux_loss_coef x ls``."""
        leaves = {k: v.detach().requires_grad_() for k, v in lp.items()}
        x_in = x.detach().requires_grad_()
        with torch.enable_grad():
            out, aux = self.model.decoder_layer(leaves, x_in)
        outs, cots = [out], [dx]
        if isinstance(aux, torch.Tensor) and aux.requires_grad:
            outs.append(aux)
            cots.append(torch.full_like(aux, self.aux_coef * ls))
        inputs = [x_in] + list(leaves.values())
        grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
        grads = _zeros_if_none(grads, inputs)
        return grads[0], dict(zip(leaves, grads[1:]))

    def _head_grad(self, x: torch.Tensor, batch: Any, ls: float):
        """(loss, resident gradients of ``head_loss x ls``, dx)."""
        res = {k: p.detach().requires_grad_() for k, p in
               self.resident.items()}
        x_in = x.detach().requires_grad_()
        with torch.enable_grad():
            loss = self.model.head_loss(res, x_in, batch)
            inputs = list(res.values()) + [x_in]
            grads = torch.autograd.grad(loss * ls, inputs, allow_unused=True)
        grads = _zeros_if_none(grads, inputs)
        return (loss.detach(), {k: g.float() for k, g in zip(res, grads)},
                grads[-1])

    def _embed_grad(self, ids: torch.Tensor, dx: torch.Tensor
                    ) -> torch.Tensor:
        """The embedding's gradient from the first layer's input gradient,
        summed in fp32 (JAX ``embed_grad``: a scatter-add; here the sorted,
        deterministic ``index_put_`` accumulation)."""
        emb = self.resident["embed.weight"]
        g = torch.zeros(emb.shape, dtype=torch.float32, device=emb.device)
        g.index_put_((ids.reshape(-1).long(),),
                     dx.reshape(-1, dx.shape[-1]).float(), accumulate=True)
        return g

    def _to_device(self, batch: Any) -> Any:
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return torch.as_tensor(batch, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _micro(self, batch: Any) -> Any:
        """The batch a rank streams: under ``seq`` its chunk of the ids and
        of the labels made from the whole rows."""
        if self.sp == 1:
            return batch
        ids, labels = self.model.batch_labels(batch)
        ids, labels, _ = self.model._seq_chunk(ids, labels, self.sp)
        return {"input_ids": ids, "labels": labels}

    def _group_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group (itself in one process)."""
        if self.group is None:
            return x
        return comm.all_reduce(x.clone(), group=self.group)

    def _norm_sq(self, trunk_split: torch.Tensor, trunk_whole: torch.Tensor,
                 g_res: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global Σg²: the trunk's segment sums over the group, the
        resident gradients' (already summed over it) once, and the split
        leaves' part of both over ``tensor`` (the whole leaves' is the same
        on every tensor rank)."""
        trunk = self._group_sum(torch.stack([trunk_split, trunk_whole]))
        split = trunk[0] + sum((g.square().sum() for n, g in g_res.items()
                                if n in self.resident_split),
                               torch.zeros_like(trunk[0]))
        whole = trunk[1] + sum((g.square().sum().to(trunk.dtype)
                                for n, g in g_res.items()
                                if n not in self.resident_split),
                               torch.zeros_like(trunk[1]))
        if self.tp_group is not None:
            split = comm.all_reduce(split.clone(), group=self.tp_group)
        return split + whole

    def _group_mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """A rank's loss summed over ``seq``, averaged over the data
        ranks."""
        if self.group is None:
            return loss
        return self._group_sum(loss.float()).div_(self.dp)

    # -- the streamed step -------------------------------------------------

    def train_step(self, batch: Any) -> Dict[str, Any]:
        model, sw, L, gas = self.model, self.swapper, self.L, self.gas
        t0 = time.perf_counter()
        fused = gas == 1 and self.clip <= 0.0 and not self.fp16
        ls = float(self.scaler.scale) if self.fp16 else 1.0
        lr = float(self.schedule(self.global_steps))
        sw.begin_step()
        batch = self._to_device(batch)
        rows = _rows(batch)
        if rows % gas:
            raise ValueError(f"batch rows {rows} not divisible by "
                             f"gradient_accumulation_steps {gas}")
        micros = [self._micro(_slice_rows(batch, k * rows // gas,
                                          (k + 1) * rows // gas))
                  for k in range(gas)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        # the fused path's Σg² of the split leaves, of the whole ones
        norm_sq = [torch.zeros((), dtype=torch.float32, device=self.device)
                   for _ in range(2)]
        g_res: Optional[Dict[str, torch.Tensor]] = None
        for k, mb in enumerate(micros):
            ids, _ = model.batch_labels(mb)
            with torch.no_grad():
                x = model.embed_fwd(self.resident, ids)
            acts: List[Optional[torch.Tensor]] = []
            aux_sum = 0.0
            sw.prefetch(0)
            for i in range(L):
                lp = sw.get_device(i)
                sw.prefetch(i + 1)
                acts.append(x)
                x, aux = self._layer_fwd(lp, x)
                aux_sum = aux_sum + aux
                sw.release(i)
            loss, g_head, dx = self._head_grad(x, mb, ls)
            loss_sum = loss_sum + loss + self.aux_coef * aux_sum
            sw.prefetch(L - 1, full=fused)
            for i in reversed(range(L)):
                lp = sw.get_device(i)
                sw.prefetch(i - 1, full=fused)
                dx, dlp = self._layer_bwd(lp, acts[i], dx, ls)
                acts[i] = None  # the activation is consumed
                # one process: the leaves; more: this rank's reduced segment
                g_layer = sw.reduce_layer_grads(dlp)
                del dlp
                if fused:
                    norm_sq = [a + b for a, b in zip(norm_sq,
                                                     sw.sq_parts(g_layer))]
                    sw.step_layer_async(i, g_layer, lr=lr)
                else:
                    sw.stash_grads(i, g_layer, accumulate=k > 0)
                del g_layer
                sw.release(i)
            g_head["embed.weight"] = g_head["embed.weight"] + \
                self._embed_grad(ids, dx)
            g_res = g_head if g_res is None else {
                n: g_res[n] + g_head[n] for n in g_res}
        t_backward = time.perf_counter()

        if self.group is not None:
            # summed over the ranks, the data ranks averaged
            flat = list(g_res.values())
            all_reduce_flat(flat, self.group, self._bucket)
            if self.dp > 1:
                torch._foreach_div_(flat, float(self.dp))
            loss_sum = self._group_mean_loss(loss_sum)
        overflow = False
        if fused:
            grad_norm = float(torch.sqrt(self._norm_sq(*norm_sq, g_res)))
            scale = 1.0
        else:
            split, whole = (torch.tensor(x, dtype=torch.float64,
                                         device=self.device)
                            for x in sw.stashed_sq_norm())
            grad_norm = math.sqrt(float(self._norm_sq(split, whole, g_res))
                                  ) / (gas * ls)
            overflow = self.fp16 and not math.isfinite(grad_norm)
            scale = 1.0 / (gas * ls)
            if not overflow:
                if self.clip > 0.0 and grad_norm > self.clip:
                    scale *= self.clip / grad_norm
                sw.prefetch_host(0, full=True)
                for i in range(L):
                    # queued (its slot pinned) before the next layer's
                    # read-ahead, which may then not evict it
                    sw.apply_stashed_async(i, lr=lr, scale=scale)
                    sw.prefetch_host(i + 1, full=True)
            else:
                sw.discard_stashed()
                sw.cancel_step()
        if not overflow:
            grads = [g_res[n].mul_(scale) if scale != 1.0 else g_res[n]
                     for n in self.resident]
            self.res_opt.step(float(self.schedule(self.res_opt.count)),
                              list(self.resident.values()), grads)
            self.global_steps += 1
        if self.scaler is not None:
            self.scaler.update(overflow)
        sw.flush()
        self._sync()
        t_end = time.perf_counter()
        self.last_timings = {"step_s": t_end - t0,
                             "to_optimizer_s": t_backward - t0,
                             "after_backward_s": t_end - t_backward}
        metrics = {"loss": loss_sum / gas, "lr": lr,
                   "grad_norm": torch.tensor(grad_norm, dtype=torch.float32),
                   "loss_scale": ls, "overflow": overflow}
        self.last_metrics = metrics
        return metrics

    @torch.no_grad()
    def eval_loss(self, batch: Any) -> torch.Tensor:
        """The streamed forward's loss (no gradient, no update)."""
        model, sw = self.model, self.swapper
        sw.drain_updates()
        batch = self._micro(self._to_device(batch))
        ids, _ = model.batch_labels(batch)
        x = model.embed_fwd(self.resident, ids)
        aux_sum = 0.0
        sw.prefetch(0)
        for i in range(self.L):
            lp = sw.get_device(i)
            sw.prefetch(i + 1)
            x, aux = model.decoder_layer(lp, x)
            aux_sum = aux_sum + aux
            sw.release(i)
        return self._group_mean_loss(model.head_loss(self.resident, x, batch)
                                     + self.aux_coef * aux_sum)

    # -- introspection -------------------------------------------------------

    def peak_device_param_bytes(self) -> int:
        """Trunk bytes on the device at the deepest point: the two layer
        buffers (``n_pad`` wire elements each)."""
        sw = self.swapper
        return 2 * sw.n_pad * sw._wire_size()

    def resident_param_count(self) -> int:
        return sum(p.numel() for p in self.resident.values())

    def total_param_count(self) -> int:
        return self.swapper.n_elems * self.L + self.resident_param_count()
