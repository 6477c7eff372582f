"""ZeRO-Offload: the fp32 masters and optimizer state in host memory, the
step on the host's C++ optimizer.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py``
(:class:`CPUOffloadOptimizer`).  The card computes the gradients (and,
under ``bf16``, keeps its parameters in bf16: the wire); at the step
boundary the engine hands this optimizer each parameter's reduced
gradient, this rank's part of it, and the optimizer brings the updated
values back into the card's tensors.  The host state is this rank's part
of each leaf as the engine's ``Placement`` cuts it: the whole leaf at
stage 0 and for a replicated leaf, this rank's chunk at stages 1-3 (JAX's
``offload_shardings`` rule), so host memory a rank is the stage's share.

The step is JAX's bucket pipeline.  The slots (one a parameter) are
grouped into buckets of about ``bucket_bytes``:

1. every gradient is copied to pinned host staging on a copy stream
   (``non_blocking``; in the wire dtype), one CUDA event a bucket;
2. a worker thread waits on each bucket's event, runs the C++ Adam (or
   Adagrad, Lion) over its slots, the bf16 wire written by the same pass
   (``ds_adam_step_bf16``), and copies the bucket's updated values to the
   card on a second copy stream, while the main thread waits on the next
   bucket;
3. the compute stream waits for the last copy to the card.

``last_timings`` splits the step: the waits for the gradients' copies
(``d2h_wait_s``), the host optimizer (``host_opt_s``), the tail of the
copies back (``h2d_s``) and the whole (``step_s``).  On the CPU (the
tests) the copies are plain copies.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import torch

from ...utils.logging import log_dist

#: the config's optimizer names each host optimizer takes
HOST_ADAM = ("adam", "adamw", "cpuadam", "deepspeedcpuadam", "fusedadam")
HOST_ADAGRAD = ("adagrad", "deepspeedcpuadagrad")
HOST_LION = ("lion", "deepspeedcpulion")


def _param(op: Dict[str, Any], key: str, default: Any) -> Any:
    v = op.get(key, default)
    return default if isinstance(v, str) else v


class CPUOffloadOptimizer:
    """The host optimizer over ``masters`` (this rank's part of each leaf,
    any device; copied to fp32 host tensors)."""

    def __init__(self, masters: Sequence[torch.Tensor], optimizer_name: str,
                 optimizer_params: Dict[str, Any], device: torch.device,
                 wire_dtype: torch.dtype = torch.float32,
                 bucket_bytes: int = 32 << 20):
        from ...ops.adam import (DeepSpeedCPUAdagrad, DeepSpeedCPUAdam,
                                 DeepSpeedCPULion)

        self.device = device
        self.cuda = device.type == "cuda"
        self.wire_dtype = wire_dtype
        self.wire_bf16 = wire_dtype == torch.bfloat16
        name = optimizer_name.lower().replace("_", "")
        op = dict(optimizer_params or {})
        lr = float(_param(op, "lr", 1e-3))
        wd = float(_param(op, "weight_decay", 0.0))
        # the fp32 wire copies the masters themselves to the card: pinned
        pin = self.cuda and not self.wire_bf16
        if name in HOST_ADAM:
            self.opt = DeepSpeedCPUAdam(
                masters, lr=lr, betas=tuple(_param(op, "betas",
                                                   (0.9, 0.999))),
                eps=float(_param(op, "eps", 1e-8)), weight_decay=wd,
                adamw_mode=name not in ("adam", "fusedadam"),
                pin_memory=pin)
            self.kind, self.state_names = "Adam", ("m", "v")
        elif name in HOST_ADAGRAD:
            self.opt = DeepSpeedCPUAdagrad(
                masters, lr=lr, eps=float(_param(op, "eps", 1e-10)),
                weight_decay=wd, pin_memory=pin)
            self.kind, self.state_names = "CPUAdagrad", ("exp_avg_sq",)
        elif name in HOST_LION:
            self.opt = DeepSpeedCPULion(
                masters, lr=lr, betas=tuple(_param(op, "betas",
                                                   (0.9, 0.99))),
                weight_decay=wd, pin_memory=pin)
            self.kind, self.state_names = "CPULion", ("exp_avg",)
        else:
            raise ValueError(f"offload_optimizer does not support optimizer "
                             f"{optimizer_name!r} (Adam, AdamW, Adagrad, "
                             "Lion)")
        if self.wire_bf16 and self.kind != "Adam":
            raise ValueError("the bf16 wire needs the Adam family (the C++ "
                             "bf16 emit is Adam's)")
        self.num_slots = len(self.opt.params)
        self.shapes = [tuple(p.shape) for p in self.opt.params]
        # ~bucket_bytes groups of consecutive slots: the pipeline's unit
        self.buckets: List[List[int]] = []
        cur: List[int] = []
        size = 0
        for slot, p in enumerate(self.opt.params):
            cur.append(slot)
            size += p.numel() * 4
            if size >= bucket_bytes:
                self.buckets.append(cur)
                cur, size = [], 0
        if cur:
            self.buckets.append(cur)
        el = torch.empty((), dtype=wire_dtype).element_size()
        # pinned staging: gradients in, and (bf16 wire) parameters out
        self._grad_stage = [torch.empty(s, dtype=wire_dtype,
                                        pin_memory=self.cuda)
                            for s in self.shapes]
        self._wire_stage = ([torch.empty(s, dtype=torch.bfloat16,
                                         pin_memory=self.cuda)
                             for s in self.shapes]
                            if self.wire_bf16 else None)
        if self.cuda:
            self._d2h = torch.cuda.Stream(device)
            self._h2d = torch.cuda.Stream(device)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ds-offload")
        self.last_timings: Dict[str, float] = {}
        total = sum(p.numel() for p in self.opt.params)
        self.state_bytes = total * 4 * (1 + len(self.state_names))
        self.staging_bytes = total * el + (total * 2 if self.wire_bf16
                                           else 0)
        log_dist(f"ZeRO-Offload: {self.kind} state on the host "
                 f"({self.state_bytes / 2**20:.1f} MiB masters and moments, "
                 f"{self.num_slots} slots in {len(self.buckets)} buckets, "
                 f"wire {wire_dtype})")

    # -- what the engine and the checkpoints read -------------------------

    @property
    def count(self) -> int:
        """Applied steps."""
        return self.opt.state_step

    @count.setter
    def count(self, value: int) -> None:
        self.opt.state_step = int(value)

    @property
    def masters(self) -> List[torch.Tensor]:
        return self.opt.params

    def _state_lists(self) -> Dict[str, List[torch.Tensor]]:
        if self.kind == "Adam":
            return {"m": self.opt.exp_avg, "v": self.opt.exp_avg_sq}
        attr = self.state_names[0]
        return {attr: getattr(self.opt, attr)}

    def state_dict(self) -> Dict[str, Any]:
        """As ``runtime/optimizers.Optimizer.state_dict``: the Adam family
        names its type ``Adam`` with ``m`` and ``v``, so a checkpoint moves
        between engines with and without offload."""
        return {"type": self.kind, "count": self.count,
                **{k: list(v) for k, v in self._state_lists().items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("type") != self.kind:
            raise ValueError(f"optimizer state of {state.get('type')}, the "
                             f"offload optimizer is {self.kind}")
        for k, dst in self._state_lists().items():
            for d, s in zip(dst, state[k]):
                d.copy_(s)
        self.count = int(state["count"])

    def state_dict_arrays(self) -> Dict[str, Any]:
        """JAX ``state_dict_arrays``: this rank's parts, slot by slot: the
        moments under the reference's names, the fp32 masters and the step
        count (live tensors)."""
        out: Dict[str, Any] = {
            name: list(getattr(self.opt, name))
            for name in ("exp_avg", "exp_avg_sq") if hasattr(self.opt, name)}
        out["master"] = list(self.opt.params)
        out["step"] = self.count
        return out

    @torch.no_grad()
    def load_state_arrays(self, state: Dict[str, Any]) -> bool:
        """Restore :meth:`state_dict_arrays`' keys that ``state`` has;
        True when it held the masters (else the caller reseeds them)."""
        for name in ("exp_avg", "exp_avg_sq", "master"):
            if name in state and (name == "master" or hasattr(self.opt,
                                                              name)):
                dst = (self.opt.params if name == "master"
                       else getattr(self.opt, name))
                for d, src in zip(dst, state[name]):
                    d.copy_(torch.as_tensor(src).reshape(d.shape))
        if "step" in state:
            self.count = int(state["step"])
        return "master" in state

    @torch.no_grad()
    def reseed_masters(self, params: Sequence[torch.Tensor]) -> None:
        """The host masters from the card's values (this rank's parts)."""
        for d, p in zip(self.opt.params, params):
            d.copy_(p.detach().reshape(d.shape))

    # -- the step ----------------------------------------------------------

    @torch.no_grad()  # grad mode is thread-local: the worker's own
    def _update_bucket(self, bucket: List[int], events: List[Any],
                       outs: Sequence[torch.Tensor], k: int) -> Any:
        """Worker: wait for the bucket's gradients, step its slots, start
        their copies back to the card; the event of the last copy."""
        t0 = time.perf_counter()
        if events[k] is not None:
            events[k].synchronize()
        t1 = time.perf_counter()
        self.last_timings["d2h_wait_s"] += t1 - t0
        for slot in bucket:
            g = self._grad_stage[slot]
            if g.dtype != torch.float32:
                g = g.float()
            if self.wire_bf16:
                self.opt.step_slot(slot, g, bf16_out=self._wire_stage[slot])
            else:
                self.opt.step_slot(slot, g)
        t2 = time.perf_counter()
        self.last_timings["host_opt_s"] += t2 - t1
        srcs = (self._wire_stage if self.wire_bf16 else self.opt.params)
        if self.cuda:
            with torch.cuda.stream(self._h2d):
                for slot in bucket:
                    outs[slot].copy_(srcs[slot], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._h2d)
            return ev
        for slot in bucket:
            outs[slot].copy_(srcs[slot])
        return None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float,
             outs: Sequence[torch.Tensor]) -> None:
        """``grads[i]``: slot ``i``'s reduced gradient on the card (fp32,
        unscaled and clipped); ``outs[i]``: the card tensor that receives
        its updated value (the wire dtype)."""
        t_start = time.perf_counter()
        self.last_timings = {"d2h_wait_s": 0.0, "host_opt_s": 0.0}
        events: List[Any] = []
        if self.cuda:
            self._d2h.wait_stream(torch.cuda.current_stream(self.device))
        for bucket in self.buckets:
            if self.cuda:
                with torch.cuda.stream(self._d2h):
                    for slot in bucket:
                        g = grads[slot]
                        src = g.to(self.wire_dtype)
                        self._grad_stage[slot].copy_(src.reshape(
                            self.shapes[slot]), non_blocking=True)
                        g.record_stream(self._d2h)
                        src.record_stream(self._d2h)
                    ev = torch.cuda.Event()
                    ev.record(self._d2h)
                events.append(ev)
            else:
                for slot in bucket:
                    self._grad_stage[slot].copy_(grads[slot].reshape(
                        self.shapes[slot]))
                events.append(None)
        self.opt.begin_step(lr)
        pending = None
        last = None
        for k, bucket in enumerate(self.buckets):
            if pending is not None:
                last = pending.result()  # one bucket in flight at a time
            pending = self._pool.submit(self._update_bucket, bucket, events,
                                        outs, k)
        if pending is not None:
            last = pending.result()
        t_opt = time.perf_counter()
        if last is not None:
            torch.cuda.current_stream(self.device).wait_event(last)
            last.synchronize()
        t_end = time.perf_counter()
        self.last_timings["h2d_s"] = t_end - t_opt
        self.last_timings["step_s"] = t_end - t_start
