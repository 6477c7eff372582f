"""Layer-granular parameter and optimizer-state tiering: the ZeRO-Infinity
swap core.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper
.py`` (:class:`PartitionedParamSwapper`, ``_OptPipeline``; the reference's
``partitioned_param_swapper``, ``partitioned_optimizer_swapper`` and
``pipelined_optimizer_swapper``).  Each layer owns flat host planes of its
``n_elems`` parameters, the leaves laid end to end in the order of the
layer's ``named_parameters()``:

    wire     the compute-dtype copy the card reads (pinned on the card's
             host: the source of the copy to the device)
    master   fp32 parameters, updated by the host Adam
    m, v     fp32 Adam moments

and, only while a step stashes it (gradient accumulation, clipping,
fp16), an fp32 gradient plane.

The ``cpu`` tier keeps every layer's planes in host memory; the ``nvme``
tier keeps them in files (``layer_{i:05d}.{wire,master,m,v}`` under
``nvme_path``) and a ring of ``buffer_count`` host slots holds the layers
in flight, read ahead and written behind through the port's
:class:`~deepspeed_tpu_torch.ops.aio.AIOHandle`, the least recently used
slot evicted first.  Host memory is then ``buffer_count`` layers, not all.

The device side is two flat buffers of ``n_pad`` in the wire dtype,
allocated once: layer ``i`` goes into buffer ``i % 2`` and its leaves are
views into it, so the caching allocator sees no per-layer allocation and
the parameter bytes on the device peak at exactly ``2 x n_pad x`` the
wire's element size (``n_pad`` is ``n_elems`` in one process).  On the
card the copies run on side streams, ordered by CUDA events where the JAX
package relied on ``device_put``:

* a host-to-device copy into a buffer waits for the compute stream's
  :meth:`release` of the layer that held it, and :meth:`get_device` makes
  the compute stream wait for the copy;
* a layer's gradient leaves go to pinned staging on a copy stream; the
  host reads a staging buffer only after its copy's event, and the main
  thread reuses one only after the optimizer has consumed it;
* a host plane (the wire the C++ Adam rewrites, a slot an AIO read
  refills) is written only after the last copy from it has completed.

The update is the fused C++ ``ds_adam_step_bf16`` (``ops/adam``): one pass
updates master, m and v and writes the new bf16 wire (an fp16 or fp32 wire
is cast from the master).  ``pipeline=True`` runs it on a worker thread
(:class:`_OptPipeline`) while the main thread keeps the card busy; the
result is the same, bit for bit, as the serial run.

Under tensor parallelism each tensor coordinate has a swapper of its
own: its layers' leaves are its blocks of the split ones (and the whole
norms), ``group`` is its data-parallel and ``seq`` ranks (so a broadcast
from the group's rank 0 never copies one tensor block over another), and
``split_leaves`` names the split leaves, whose Σg² :meth:`sq_parts` and
:meth:`stashed_sq_norm` keep apart from the whole ones.

On more than one rank (``group``: the data-parallel and ``seq`` ranks;
JAX's per-process planes, ``shard``) each layer's flat plane is padded to
``n_pad``, a multiple of the group's size, and each rank's planes hold one
contiguous segment of it, ``[rank x n_plane, (rank + 1) x n_plane)``:
host memory, nvme files (``layer_{i:05d}.r{rank}.{kind}``) and the host
Adam's work are ``1/world`` of one process's.  :meth:`get_device` copies
the rank's wire segment into its place in the device buffer and
all-gathers the buffer over the group; :meth:`reduce_layer_grads` lays a
layer's gradients end to end in one fp32 ``[n_pad]`` device buffer,
reduce-scatters it (a sum) over the group and multiplies the rank's
segment by ``grad_scale`` (``1/dp``: the data ranks are averaged, ``seq``
is summed), and only that segment crosses to the host.  Every collective
runs on the caller's thread, in the order of the calls, which every rank
makes alike; the worker thread issues none.  The checkpoint surface
(:meth:`layer_master_tree`, :meth:`layer_moments`, :meth:`load_layer`)
speaks whole layers: it gathers the segments, or takes its own.
"""

from __future__ import annotations

import os
import queue
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ...comm import comm
from ...ops.adam.cpu_adam import adam_step
from ...utils.logging import log_dist

#: a layer's leaves: (name, shape, offset in the flat plane)
Layout = List[Tuple[str, Tuple[int, ...], int]]


def leaf_layout(named: Sequence[Tuple[str, torch.Tensor]]) -> Layout:
    out, off = [], 0
    for name, t in named:
        out.append((name, tuple(t.shape), off))
        off += t.numel()
    return out


def _host(n: int, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, pin_memory=pin)


class _Planes:
    """One layer's host planes (wire and master are written whole before
    they are read: filled from the leaves, or read from the files)."""

    __slots__ = ("wire", "master", "m", "v")

    def __init__(self, n: int, wire_dtype: torch.dtype, pin: bool):
        self.wire = torch.empty((n,), dtype=wire_dtype, pin_memory=pin)
        self.master = torch.empty((n,), dtype=torch.float32)
        self.m = _host(n, torch.float32, False)
        self.v = _host(n, torch.float32, False)

    def files(self) -> Tuple[Tuple[str, torch.Tensor], ...]:
        return (("wire", self.wire), ("master", self.master), ("m", self.m),
                ("v", self.v))


class _OptPipeline:
    """One worker thread running submitted updates in order (JAX
    ``_OptPipeline``): a queue of ``depth - 1`` items plus the one the
    worker holds; the first error is raised by :meth:`drain`.  The thread
    holds its owner's method weakly, so a dropped swapper (and its host
    planes) is freed, and its ``close`` ends the thread."""

    def __init__(self, run, depth: int = 2):
        self._run = weakref.WeakMethod(run)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth - 1))
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="ds-opt-pipeline")
        self._t.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                run = self._run() if self._err is None else None
                if run is not None:  # after an error: drain, don't run
                    run(*item)
                del run
            except BaseException as e:  # surfaced by drain()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, *item: Any) -> None:
        if self._err is not None:
            self.drain()
        self._q.put(item)

    def drain(self) -> None:
        """Wait for every submitted update; re-raise the first failure
        (a step never loses an update silently)."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self._q.put(None)
        if threading.current_thread() is not self._t:
            self._t.join(timeout=30)


class PartitionedParamSwapper:
    """The trunk's layers off the device: host (or file) planes, two
    device buffers, the host Adam.

    ``layers``: one ``[(name, CPU tensor)]`` list a layer, all of one
    layout (a layer's ``named_parameters()``); the planes are filled from
    them one layer at a time and ``on_filled(i, masters)`` (when given) is
    called after layer ``i``'s, with its master leaves by name on the cpu
    tier (None on nvme), so the caller can drop its own copy (the engine
    makes the model's parameters those views).  On more than one rank
    (``group``) each layer's leaves are first made group rank 0's
    (broadcast), the planes keep this rank's segment, and ``on_filled``
    gets None: a segment cannot back whole leaves.
    """

    def __init__(self, layers: Sequence[Sequence[Tuple[str, torch.Tensor]]],
                 *, device: torch.device, wire_dtype: torch.dtype,
                 nvme_path: Optional[str] = None, buffer_count: int = 4,
                 aio_config: Any = None,
                 adam_hparams: Optional[Dict[str, Any]] = None,
                 pipeline: bool = False, on_filled=None, group: Any = None,
                 grad_scale: float = 1.0, split_leaves: Sequence[str] = ()):
        if not layers:
            raise ValueError("need at least one layer")
        self.device = device
        self.cuda = device.type == "cuda"
        self.L = len(layers)
        self.layout = leaf_layout(layers[0])
        self.n_elems = sum(int(torch.Size(s).numel())
                           for _, s, _ in self.layout)
        self.wire_dtype = wire_dtype
        self.nvme_dir = nvme_path
        # this rank's share: one contiguous segment of the padded plane
        # (JAX ``shard``; no permuted device order under torch.distributed)
        self.group = group if group is not None and \
            comm.get_world_size(group) > 1 else None
        self.shard_world = (comm.get_world_size(self.group)
                            if self.group is not None else 1)
        self.shard_rank = (comm.get_rank(self.group)
                           if self.group is not None else 0)
        self.n_pad = -(-self.n_elems // self.shard_world) * self.shard_world
        self.n_plane = self.n_pad // self.shard_world
        lo = self.shard_rank * self.n_plane
        self.segments = [(lo, lo + self.n_plane)]
        #: the ranges of this rank's segment that hold leaves split over
        #: ``tensor`` (``split_leaves``), and those of the whole leaves:
        #: the first's Σg² is summed over ``tensor``, the second's is the
        #: same on every tensor rank (each summed apart, so that it is);
        #: without split leaves the whole segment is one range
        self.split_leaves = frozenset(split_leaves)
        self._ranges: Dict[bool, List[Tuple[int, int]]] = {
            True: [], False: [] if self.split_leaves else [(0, self.n_plane)]}
        for name, s, off in self.layout if self.split_leaves else ():
            a = max(off, lo)
            b = min(off + int(torch.Size(s).numel()), lo + self.n_plane)
            if a < b:
                self._ranges[name in self.split_leaves].append(
                    (a - lo, b - lo))
        self.grad_scale = float(grad_scale)
        if pipeline and int(buffer_count) < 2:
            # the worker pins the layer it updates; with one slot the
            # read-ahead could find every slot pinned and deadlock
            raise ValueError(
                f"buffer_count={buffer_count} is too small for the "
                "pipelined optimizer (pipeline=True needs >= 2: one slot for "
                "the update in flight, one for the read-ahead)")
        self.buffer_count = max(2, int(buffer_count))
        hp = dict(adam_hparams or {})
        self.lr = float(hp.get("lr", 1e-3))
        self.betas = tuple(float(b) for b in hp.get("betas", (0.9, 0.999)))
        self.eps = float(hp.get("eps", 1e-8))
        self.weight_decay = float(hp.get("weight_decay", 0.0))
        self.adamw_mode = bool(hp.get("adamw_mode", True))
        self.bias_correction = bool(hp.get("bias_correction", True))
        self.state_step = 0
        #: bytes moved, by lane: h2d, d2h, disk_read, disk_write, and on
        #: more than one rank the layers gathered (``n_pad`` wire elements
        #: each) and the gradients reduce-scattered (``n_pad`` fp32 each)
        self.io_bytes = {"h2d": 0, "d2h": 0, "disk_read": 0,
                         "disk_write": 0, "gather": 0, "reduce_scatter": 0}
        self._lock = threading.RLock()
        #: layers whose update is queued or running: their slots stay
        self._pinned: set = set()
        self._unpinned = threading.Condition(self._lock)
        #: per layer, the event of the last copy out of its wire plane
        self._wire_read: Dict[int, Any] = {}

        if self.nvme_dir is None:
            self._resident: Optional[List[_Planes]] = []
            for i, named in enumerate(layers):
                planes = _Planes(self.n_plane, wire_dtype, self.cuda)
                self._fill(planes, self._from_rank0(named))
                self._resident.append(planes)
                if on_filled is not None:
                    on_filled(i, self.views(planes.master)
                              if self.shard_world == 1 else None)
            self._aio = None
        else:
            from ...ops.aio import AIOHandle

            os.makedirs(self.nvme_dir, exist_ok=True)
            ac = aio_config
            self._aio = AIOHandle(
                block_size=getattr(ac, "block_size", 1 << 20),
                queue_depth=getattr(ac, "queue_depth", 8),
                single_submit=getattr(ac, "single_submit", False),
                overlap_events=getattr(ac, "overlap_events", True),
                thread_count=getattr(ac, "thread_count", 2))
            scratch = _Planes(self.n_plane, wire_dtype, False)
            for i, named in enumerate(layers):
                self._fill(scratch, self._from_rank0(named))
                self._write_layer_sync(i, scratch)
                if on_filled is not None:
                    on_filled(i, None)
            del scratch
            self._resident = None
            self._slots = [_Planes(self.n_plane, wire_dtype, self.cuda)
                           for _ in range(self.buffer_count)]
            self._slot_of: Dict[int, int] = {}     # layer -> slot
            self._slot_full: Dict[int, bool] = {}  # layer -> master/m/v read
            self._free = list(range(self.buffer_count))
            self._lru: List[int] = []              # oldest first
            self._dirty_writes = 0

        # the two device buffers and their bookkeeping
        self._dev = [torch.empty((self.n_pad,), dtype=wire_dtype,
                                 device=device) for _ in range(2)]
        self._dev_layer: List[Optional[int]] = [None, None]
        self._dev_busy: List[bool] = [False, False]
        self._dev_ready: List[Any] = [None, None]  # copy-done events
        self._dev_free: List[Any] = [None, None]   # release events
        if self.cuda:
            self._h2d_stream = torch.cuda.Stream(device)
            self._d2h_stream = torch.cuda.Stream(device)
        # pinned gradient staging: the fused path's double buffer (the
        # wire dtype in one process, the reduced fp32 segment on more)
        self._stage = [_host(self.n_plane, wire_dtype if self.shard_world
                             == 1 else torch.float32, self.cuda)
                       for _ in range(2)]
        #: the flat fp32 gradient reduce-scattered on more than one rank
        self._gflat: Optional[torch.Tensor] = None
        self._stage_free: "queue.Queue" = queue.Queue()
        for k in range(2):
            self._stage_free.put(k)
        self._gplanes: Dict[int, torch.Tensor] = {}
        self._scratch_g: Optional[torch.Tensor] = None
        self._pipe = _OptPipeline(self._pipe_step) if pipeline else None
        tier = "nvme" if self.nvme_dir else "cpu"
        log_dist(f"ZeRO-Infinity swapper: {self.L} layers x "
                 f"{self.n_elems:,} params, tier={tier}, host planes "
                 f"{self.host_plane_bytes() / 2**30:.2f} GiB (rank "
                 f"{self.shard_rank} of {self.shard_world}), "
                 f"pipeline={pipeline}")

    # -- planes ---------------------------------------------------------

    def _wire_size(self) -> int:
        return torch.empty((), dtype=self.wire_dtype).element_size()

    def host_plane_bytes(self) -> int:
        """Host bytes of the planes this tier holds on this rank (wire,
        master, m, v; stashed gradients and staging not counted)."""
        held = self.buffer_count if self.nvme_dir else self.L
        return held * self.n_plane * (12 + self._wire_size())

    @torch.no_grad()
    def _from_rank0(self, named: Sequence[Tuple[str, torch.Tensor]]
                    ) -> Sequence[Tuple[str, torch.Tensor]]:
        """On more than one rank, a layer's leaves made group rank 0's, in
        place (through the card when the group carries no host tensors)."""
        if self.shard_world == 1:
            return named
        on_host = dist.get_backend(self.group) == "gloo"
        for _, t in named:
            if on_host:
                comm.broadcast(t.data, 0, self.group)
            else:
                d = t.detach().to(self.device)
                t.data.copy_(comm.broadcast(d, 0, self.group))
        return named

    @torch.no_grad()
    def _fill(self, planes: _Planes, named: Sequence[Tuple[str, Any]],
              zero_moments: bool = True) -> None:
        """This rank's segment of the masters (and wires, cast) from a
        layer's whole leaves; the padding past ``n_elems`` zero."""
        self._check_layout(named)
        lo, hi = self.segments[0]
        for (name, shape, off), (_, t) in zip(self.layout, named):
            n = int(torch.Size(shape).numel())
            a, b = max(off, lo), min(off + n, hi)
            if a < b:
                planes.master[a - lo:b - lo].copy_(
                    torch.as_tensor(t).detach().reshape(-1)[a - off:b - off])
        if hi > self.n_elems:
            planes.master[max(self.n_elems, lo) - lo:].zero_()
        self._sync_wire(planes)
        if zero_moments:
            planes.m.zero_()
            planes.v.zero_()

    def _check_layout(self, named: Sequence[Tuple[str, Any]]) -> None:
        got = [(n, tuple(torch.as_tensor(t).shape)) for n, t in named]
        want = [(n, s) for n, s, _ in self.layout]
        if got != want:
            raise ValueError(f"layer leaves {got[:3]}... do not match the "
                             f"swapper's layout {want[:3]}...")

    def _sync_wire(self, planes: _Planes) -> None:
        planes.wire.copy_(planes.master)  # round to nearest even

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A whole flat layer's leaves by name, as views (a device buffer,
        a gathered plane, or a host plane in one process: on more, a host
        plane is a segment)."""
        return {name: flat[off:off + int(torch.Size(s).numel())].view(s)
                for name, s, off in self.layout}

    # -- nvme files -----------------------------------------------------

    def _path(self, i: int, kind: str) -> str:
        rank = f".r{self.shard_rank}" if self.shard_world > 1 else ""
        return os.path.join(self.nvme_dir, f"layer_{i:05d}{rank}.{kind}")

    def _aio_wait(self, what: str) -> None:
        failed = self._aio.wait()
        if failed:
            raise IOError(f"AIO {what} failed ({failed} ops)")

    def _write_layer_sync(self, i: int, planes: _Planes) -> None:
        for kind, buf in planes.files():
            self._aio.async_pwrite(buf, self._path(i, kind), truncate=True)
            self.io_bytes["disk_write"] += buf.numel() * buf.element_size()
        self._aio_wait(f"write of layer {i}")

    def _write_behind(self, i: int, planes: _Planes) -> None:
        with self._lock:
            for kind, buf in planes.files():
                self._aio.async_pwrite(buf, self._path(i, kind))
                self.io_bytes["disk_write"] += buf.numel() * \
                    buf.element_size()
            self._dirty_writes += 4

    def _evict_for_slot(self, wait: bool) -> Optional[int]:
        """A slot for a new layer: a free one, else the least recently used
        layer's whose update is not queued (``wait``: until one is; else
        None).  Every read into and write from the slots is done first."""
        if self._free:
            return self._free.pop()
        self._aio_wait("the slots' reads and writes")
        self._dirty_writes = 0
        while True:
            victim = next((l for l in self._lru if l not in self._pinned),
                          None)
            if victim is not None:
                break
            if not wait:
                return None
            self._unpinned.wait()
        self._wait_wire_read(victim)  # its wire may still be copying out
        self._lru.remove(victim)
        slot = self._slot_of.pop(victim)
        self._slot_full.pop(victim, None)
        self._invalidate_device(victim)
        return slot

    def prefetch_host(self, i: int, full: bool = False,
                      wait: bool = False) -> None:
        """Start reading layer ``i``'s wire (and, ``full``, its master, m
        and v) from its files into a slot (nvme tier; a no-op on cpu).  A
        read-ahead (``wait`` False) is skipped while every slot holds a
        layer whose update is queued: reading it would evict one."""
        if self.nvme_dir is None or not (0 <= i < self.L):
            return
        with self._lock:
            if i in self._slot_of:
                self._touch(i)
                if self._slot_full[i] or not full:
                    return
                planes = self._slots[self._slot_of[i]]
                kinds = planes.files()[1:]
            else:
                slot = self._evict_for_slot(wait)
                if slot is None:
                    return
                self._slot_of[i] = slot
                self._lru.append(i)
                planes = self._slots[self._slot_of[i]]
                kinds = planes.files() if full else planes.files()[:1]
            for kind, buf in kinds:
                self._aio.async_pread(buf, self._path(i, kind))
                self.io_bytes["disk_read"] += buf.numel() * buf.element_size()
            self._slot_full[i] = full

    def _touch(self, i: int) -> None:
        if i in self._lru:
            self._lru.remove(i)
        self._lru.append(i)

    def _ensure_host(self, i: int, full: bool = False) -> _Planes:
        """Layer ``i``'s host planes, read in (nvme) and waited for."""
        if self.nvme_dir is None:
            return self._resident[i]
        with self._lock:
            self.prefetch_host(i, full, wait=True)
            self._touch(i)
            self._aio_wait(f"read of layer {i}")
            self._dirty_writes = 0
            return self._slots[self._slot_of[i]]

    # -- the device buffers ----------------------------------------------

    def _wait_wire_read(self, i: int) -> None:
        ev = self._wire_read.pop(i, None)
        if ev is not None:
            ev.synchronize()

    def _invalidate_device(self, i: int) -> None:
        """Layer ``i``'s device copy is stale (its wire changes); a busy
        buffer stays busy until :meth:`release`."""
        b = i % 2
        if self._dev_layer[b] == i:
            self._dev_layer[b] = None

    def prefetch(self, i: int, full: bool = False) -> None:
        """Start moving layer ``i`` toward the device: its file reads
        (nvme; ``full`` also master, m and v) and, on the cpu tier, the
        copy into its device buffer."""
        if not (0 <= i < self.L):
            return
        if self.nvme_dir is not None:
            self.prefetch_host(i, full)
            return
        self._to_device(i)

    def _to_device(self, i: int) -> int:
        b = i % 2
        if self._dev_layer[b] == i:
            return b
        if self._dev_busy[b]:
            raise RuntimeError(
                f"swap: device buffer {b} still holds layer "
                f"{self._dev_layer[b]} (not released) when layer {i} needs "
                "it")
        planes = self._ensure_host(i)
        src = planes.wire
        lo, hi = self.segments[0]
        dst = self._dev[b][lo:hi]
        if self.cuda:
            with torch.cuda.stream(self._h2d_stream):
                if self._dev_free[b] is not None:
                    self._h2d_stream.wait_event(self._dev_free[b])
                dst.copy_(src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._h2d_stream)
            self._dev_ready[b] = ev
            with self._lock:
                self._wire_read[i] = ev
        else:
            dst.copy_(src)
        self.io_bytes["h2d"] += self.n_plane * self._wire_size()
        self._dev_layer[b] = i
        return b

    def get_device(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s leaves on the device (views of its buffer, in the
        wire dtype); the compute stream waits for their copy.  On more
        than one rank the buffer is all-gathered over the group first, at
        every call (so the collectives do not depend on which layers a
        rank's ring still holds)."""
        b = self._to_device(i)
        if self.cuda and self._dev_ready[b] is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._dev_ready[b])
        if self.shard_world > 1:
            lo, hi = self.segments[0]
            comm.all_gather_into(self._dev[b], self._dev[b][lo:hi],
                                 self.group)
            self.io_bytes["gather"] += self.n_pad * self._wire_size()
        self._dev_busy[b] = True
        return self.views(self._dev[b])

    def release(self, i: int) -> None:
        """The compute stream is done with layer ``i``'s buffer (the next
        copy into it waits for this point)."""
        b = i % 2
        if not self._dev_busy[b]:
            return
        self._dev_busy[b] = False
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._dev_free[b] = ev

    # -- gradients off the device ------------------------------------------

    @torch.no_grad()
    def reduce_layer_grads(self, grads: Dict[str, torch.Tensor]) -> Any:
        """What the update of a layer consumes: its gradient leaves in one
        process; on more, this rank's segment of their sum over the group
        times ``grad_scale`` (fp32 ``[n_plane]`` on the device), from one
        flat fp32 ``[n_pad]`` buffer (the padding stays zero)."""
        if self.shard_world == 1:
            return grads
        if self._gflat is None:
            self._gflat = torch.zeros((self.n_pad,), dtype=torch.float32,
                                      device=self.device)
        for name, s, off in self.layout:
            n = int(torch.Size(s).numel())
            self._gflat[off:off + n].copy_(grads[name].reshape(-1))
        seg = comm.reduce_scatter(self._gflat, group=self.group)
        if self.grad_scale != 1.0:
            seg.mul_(self.grad_scale)
        self.io_bytes["reduce_scatter"] += self.n_pad * 4
        return seg

    def _grads_to_stage(self, grads: Any) -> Tuple[int, Any]:
        """Copy a layer's gradient leaves (or this rank's reduced segment)
        into a free pinned staging buffer; ``(buffer, event of the
        copy)``."""
        k = self._stage_free.get()  # blocks while both are being consumed
        stage = self._stage[k]
        if isinstance(grads, torch.Tensor):
            flat = [(grads, 0, self.n_plane)]
        else:
            flat = [(grads[name], off, int(torch.Size(s).numel()))
                    for name, s, off in self.layout]
        if self.cuda:
            self._d2h_stream.wait_stream(
                torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._d2h_stream):
                for g, off, n in flat:
                    stage[off:off + n].copy_(g.reshape(-1),
                                             non_blocking=True)
                    g.record_stream(self._d2h_stream)
                ev = torch.cuda.Event()
                ev.record(self._d2h_stream)
        else:
            for g, off, n in flat:
                stage[off:off + n].copy_(g.reshape(-1))
            ev = None
        self.io_bytes["d2h"] += self.n_plane * stage.element_size()
        return k, ev

    def _take_stage(self, k: int, ev: Any, out: torch.Tensor,
                    accumulate: bool = False) -> None:
        """``out`` (fp32) = (or +=) staging buffer ``k`` once its copy is
        done; the buffer is then free again."""
        if ev is not None:
            ev.synchronize()
        try:
            if accumulate:
                out.add_(self._stage[k])
            else:
                out.copy_(self._stage[k])
        finally:
            self._stage_free.put(k)

    # -- the optimizer ------------------------------------------------------

    def begin_step(self) -> None:
        self.drain_updates()  # no update straddles a step boundary
        self.state_step += 1

    def cancel_step(self) -> None:
        """Undo :meth:`begin_step`'s count (an fp16 overflow skip: the
        bias correction must not advance)."""
        self.drain_updates()
        self.state_step = max(self.state_step - 1, 0)

    def _adam(self, i: int, planes: _Planes, g: torch.Tensor,
              lr: float) -> None:
        """One fused C++ Adam(W) over layer ``i``'s whole plane; the wire
        is rewritten only after its last copy to the device is done."""
        self._wait_wire_read(i)
        bf16 = self.wire_dtype == torch.bfloat16
        adam_step(planes.master, g, planes.m, planes.v, self.state_step, lr,
                  self.betas, self.eps, self.weight_decay, self.adamw_mode,
                  self.bias_correction, planes.wire if bf16 else None)
        if not bf16:
            self._sync_wire(planes)
        if self.nvme_dir is not None:
            self._write_behind(i, planes)

    @torch.no_grad()
    def _update(self, kind: str, i: int, stage: Any, lr: Optional[float],
                scale: float) -> None:
        planes = self._ensure_host(i, full=True)
        if kind == "fused":
            if self._pipe is not None:
                g = self._pipe_g
            else:
                if self._scratch_g is None:
                    self._scratch_g = _host(self.n_plane, torch.float32,
                                            False)
                g = self._scratch_g
            self._take_stage(*stage, g)
        else:
            g = self._gplanes.pop(i)
            if scale != 1.0:
                g.mul_(scale)
        self._adam(i, planes, g, float(self.lr if lr is None else lr))

    @torch.no_grad()  # grad mode is thread-local: the worker's own
    def _pipe_step(self, kind: str, i: int, stage: Any, lr: Optional[float],
                   scale: float) -> None:
        try:
            self._update(kind, i, stage, lr, scale)
        finally:
            with self._lock:
                self._pinned.discard(i)
                self._unpinned.notify_all()

    def _submit(self, kind: str, i: int, stage: Any, lr: Optional[float],
                scale: float) -> None:
        """Queue layer ``i``'s update, its slot pinned until it is done."""
        with self._lock:
            self._pinned.add(i)
        self._invalidate_device(i)
        self._pipe.submit(kind, i, stage, None if lr is None else float(lr),
                          float(scale))

    def step_layer(self, i: int, grads: Any,
                   lr: Optional[float] = None) -> None:
        """The fused path's update of layer ``i`` from its device
        gradients (:meth:`reduce_layer_grads`): copy off, C++ Adam,
        write-behind (nvme)."""
        stage = self._grads_to_stage(grads)
        self._invalidate_device(i)
        self._update("fused", i, stage, lr, 1.0)

    def step_layer_async(self, i: int, grads: Any,
                         lr: Optional[float] = None) -> None:
        """:meth:`step_layer` on the worker thread (serial without the
        pipeline): the copy off the device starts here."""
        if self._pipe is None:
            return self.step_layer(i, grads, lr)
        if getattr(self, "_pipe_g", None) is None:
            self._pipe_g = _host(self.n_plane, torch.float32, False)
        self._submit("fused", i, self._grads_to_stage(grads), lr, 1.0)

    def stash_grads(self, i: int, grads: Any,
                    accumulate: bool = False) -> None:
        """Land layer ``i``'s gradients (:meth:`reduce_layer_grads`) in its
        fp32 host gradient plane (``accumulate``: add to it) instead of
        updating (gradient accumulation, clipping, fp16)."""
        g = self._gplanes.get(i)
        if g is None:
            g = self._gplanes[i] = _host(self.n_plane, torch.float32, False)
            accumulate = False
        self._take_stage(*self._grads_to_stage(grads), g, accumulate)

    def discard_stashed(self) -> None:
        """Drop every stashed plane unapplied (an fp16 overflow skip)."""
        self._gplanes.clear()

    def sq_parts(self, grads: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(Σg² of the split leaves, Σg² of the whole ones)`` of a
        layer's gradients (the leaves by name in one process, this rank's
        segment on more; fp32 on their device)."""
        if isinstance(grads, torch.Tensor):
            g = grads.float()
            return tuple(sum((g[a:b].square().sum() for a, b in
                              self._ranges[split]),
                             g.new_zeros(())) for split in (True, False))
        out = [torch.zeros((), dtype=torch.float32,
                           device=next(iter(grads.values())).device)
               for _ in range(2)]
        for name, g in grads.items():
            k = 0 if name in self.split_leaves else 1
            out[k] = out[k] + g.float().square().sum()
        return out[0], out[1]

    def stashed_sq_norm(self) -> Tuple[float, float]:
        """``(Σg² of the split leaves, Σg² of the whole ones)`` over every
        stashed plane (this rank's segments), kept apart: under tensor
        parallelism the first is summed over ``tensor``, the second is
        the same on every tensor rank."""
        return tuple(sum(float(torch.dot(g[a:b], g[a:b]))
                         for g in self._gplanes.values()
                         for a, b in self._ranges[split])
                     for split in (True, False))

    def apply_stashed(self, i: int, lr: Optional[float] = None,
                      scale: float = 1.0) -> None:
        """The second pass: layer ``i``'s update from its stashed plane
        times ``scale`` (the unscale and clip factor)."""
        self._invalidate_device(i)
        self._update("stash", i, None, lr, scale)

    def apply_stashed_async(self, i: int, lr: Optional[float] = None,
                            scale: float = 1.0) -> None:
        if self._pipe is None:
            return self.apply_stashed(i, lr, scale)
        self._submit("stash", i, None, lr, scale)

    def drain_updates(self) -> None:
        """Wait for every pipelined update so far (re-raises a failure)."""
        if self._pipe is not None:
            self._pipe.drain()

    def flush(self) -> None:
        """Drain the updates, then the write-behind (end of a step, a
        checkpoint)."""
        self.drain_updates()
        with self._lock:
            if self._aio is not None and self._dirty_writes:
                self._aio_wait("flush")
                self._dirty_writes = 0

    def aio_stats(self) -> Dict[str, int]:
        return self._aio.stats() if self._aio is not None else {}

    def close(self) -> None:
        if getattr(self, "_pipe", None) is not None:
            self._pipe.close()
            self._pipe = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown
            pass

    # -- checkpoint surface ---------------------------------------------------
    #
    # Whole layers: on more than one rank every rank of the group calls
    # layer_master_tree and layer_moments alike (they gather).

    def gather_plane(self, plane: torch.Tensor) -> torch.Tensor:
        """A host plane's whole ``[n_pad]`` layer: every rank's segment in
        order (a copy; the plane itself in one process)."""
        if self.shard_world == 1:
            return plane
        return comm.all_gather(plane.to(self.device), group=self.group).cpu()

    def layer_master_tree(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s fp32 masters by leaf name (copies)."""
        self.drain_updates()
        planes = self._ensure_host(i, full=True)
        full = self.gather_plane(planes.master)
        return {k: v.clone() for k, v in self.views(full).items()}

    def layer_moments(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s flat m and v over its ``n_elems`` (copies)."""
        self.drain_updates()
        planes = self._ensure_host(i, full=True)
        return {k: self.gather_plane(p)[:self.n_elems].clone()
                for k, p in (("m", planes.m), ("v", planes.v))}

    @torch.no_grad()
    def load_layer(self, i: int, masters: Dict[str, Any],
                   moments: Optional[Dict[str, Any]] = None) -> None:
        """Install restored masters by leaf name (and flat moments over the
        layer's ``n_elems``; None keeps the current ones: a parameters-only
        load), whole: this rank keeps its segment."""
        self.drain_updates()
        planes = self._ensure_host(i, full=True)
        self._wait_wire_read(i)
        self._fill(planes, [(n, masters[n]) for n, _, _ in self.layout],
                   zero_moments=False)
        if moments is not None:
            lo, hi = self.segments[0]
            k = max(0, min(hi, self.n_elems) - lo)
            for key, plane in (("m", planes.m), ("v", planes.v)):
                src = torch.as_tensor(moments[key]).reshape(-1)
                plane[:k].copy_(src[lo:lo + k])
                plane[k:].zero_()
        self._invalidate_device(i)
        if self.nvme_dir is not None:
            self._write_layer_sync(i, planes)
