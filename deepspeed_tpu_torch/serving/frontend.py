"""SLO-aware streaming front-end: submit / stream / cancel over
latency-class queues, with admission control and preemption.

Counterpart of ``deepspeed_tpu/serving/frontend.py``:

* **submit(prompt, klass)** validates the request, assigns its latency
  class (``interactive`` / ``batch`` / ``background``) and queues it; the
  :class:`ServingHandle` streams tokens (``stream()``), collects them
  (``result()``) or aborts (``cancel()``).
* **Admission** drains the class queues in strict priority order each pump:
  a request is admitted to its routed replica when the replica has a free
  slot and enough KV pages (prefix matches counted), its outstanding-token
  budget has room, and, for non-interactive classes, an interactive page
  reserve stays free.
* **Preemption**: when the interactive head cannot be placed for want of a
  slot, a seated background request leaves its slot (pages kept) and goes
  back to the front of its queue; it resumes in place later.
* **Replica drain**: a replica that goes unhealthy has its in-flight work
  re-queued onto healthy replicas; delivery resumes past the tokens already
  streamed.

Driven by hand (``pump()``, ``run_until_idle()``) or by its own thread
(``start()`` / ``stop()``).  One re-entrant lock guards the front-end state;
tokens reach consumers through per-handle thread-safe queues.  Under tensor
parallelism every rank runs its own front-end over its shard and drives
``pump()`` itself, with the same submissions in the same order; ``start()``
refuses, since a thread's timing would let the ranks' decisions diverge.

Not ported yet: the flight recorder and watchdog hooks, request tracing,
the disaggregated KV adoption, and the HBM-headroom gate
(``min_hbm_headroom_frac`` keeps its field and gates nothing until the
memory plane is ported).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from ..utils.logging import log_dist, warn_once
from .metrics import CLASSES, ServingMetrics, count_admission_reject
from .router import Replica, ReplicaRouter

_DONE = object()


class NoHealthyReplicaError(RuntimeError):
    """Every replica behind the front-end is dead."""


@dataclasses.dataclass
class ServingParams:
    """Front-end knobs (the ``serving.*`` config group)."""

    #: per-replica admitted-but-unfinished token budget
    max_outstanding_tokens: int = 8192
    #: fraction of the allocatable pool kept free of batch/background
    #: reservations so interactive admission never waits on pages
    interactive_reserve_frac: float = 0.10
    #: admit only interactive work below this HBM headroom; gates nothing
    #: until the memory plane is ported
    min_hbm_headroom_frac: float = 0.0
    #: allow interactive to preempt background decode slots
    preemption: bool = True
    #: router prefix-affinity threshold (tokens)
    affinity_min_tokens: int = 16
    #: sampling temperature of every dispatch (0 = greedy)
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    #: per-handle stream bound (tokens): a stalled consumer loses the oldest
    stream_buffer: int = 4096


class ServingHandle:
    """One submitted request: stream / result / cancel."""

    def __init__(self, uid: int, prompt: List[int], max_new_tokens: int,
                 klass: str, submitted_at: float,
                 frontend: "ServingFrontend", stream_buffer: int):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.klass = klass
        self.submitted_at = submitted_at
        self.status = "queued"  # queued|running|done|cancelled|failed
        self.replica_id: Optional[int] = None
        self.request: Any = None          # live scheduler Request
        self.preempted = False
        self.pinned_replica: Optional[int] = None
        self.delivered = 0                # tokens pushed to the stream
        self.consumed = 0                 # tokens read off the request
        self.dropped = 0                  # tokens evicted unread
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.replays = 0                  # replica-death re-executions
        self._frontend = frontend
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(stream_buffer)))

    # -- consumer surface --------------------------------------------------

    def stream(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield tokens as they arrive (``timeout`` per token); raises the
        handle's error if the request failed."""
        while True:
            item = self._queue.get(timeout=timeout)
            if item is _DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return list(self.stream(timeout=timeout))

    def cancel(self) -> None:
        self._frontend.cancel(self)

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return (self.first_token_at - self.submitted_at) * 1e3

    def _put_drop_oldest(self, item: Any) -> None:
        """Bounded stream, slow consumer: evict the oldest unread token so
        the pump never blocks (``dropped`` counts the loss)."""
        while True:
            try:
                self._queue.put_nowait(item)
                return
            except queue.Full:
                try:
                    self._queue.get_nowait()
                    self.dropped += 1
                except queue.Empty:  # the consumer drained it meanwhile
                    pass

    def _push(self, tok: int) -> None:
        self._put_drop_oldest(tok)

    def _finish(self, status: str,
                error: Optional[BaseException] = None) -> None:
        self.status = status
        self.error = error
        self._put_drop_oldest(_DONE)


class ServingFrontend:
    def __init__(self, replicas: List[Replica],
                 params: Optional[ServingParams] = None,
                 clock=time.monotonic):
        self.params = params or ServingParams()
        self.router = ReplicaRouter(
            replicas, affinity_min_tokens=self.params.affinity_min_tokens)
        self.clock = clock
        self.metrics = ServingMetrics()
        self._queues: Dict[str, List[ServingHandle]] = {c: [] for c in CLASSES}
        self._uid = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._drained: set = set()  # replica ids already drained
        self._round = 0  # pump rounds: probe-memo invalidation

    # -- request surface ---------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 64,
               klass: str = "interactive") -> ServingHandle:
        if klass not in CLASSES:
            raise ValueError(f"klass: unknown latency class {klass!r} "
                             f"(one of {', '.join(CLASSES)})")
        with self._lock:
            healthy = self.router.healthy()
            if not healthy:
                raise NoHealthyReplicaError(
                    "submit rejected: no healthy replica "
                    + "; ".join(f"replica{r.id}: {r.dead_reason}"
                                for r in self.router.replicas))
            healthy[0].scheduler.validate(list(prompt), max_new_tokens)
            if max_new_tokens >= self.params.stream_buffer:
                warn_once(
                    "serving/stream-buffer",
                    f"max_new_tokens {max_new_tokens} >= stream_buffer "
                    f"{self.params.stream_buffer}: an unread stream "
                    f"drops its oldest tokens")
            h = ServingHandle(self._uid, list(prompt), int(max_new_tokens),
                              klass, self.clock(), self,
                              self.params.stream_buffer)
            self._uid += 1
            self._queues[klass].append(h)
            self.metrics.inc("submitted")
            return h

    def cancel(self, handle: ServingHandle) -> None:
        with self._lock:
            if handle.status == "queued":
                if handle in self._queues[handle.klass]:
                    self._queues[handle.klass].remove(handle)
                if handle.request is not None:
                    # preempted: pages are still reserved on its replica
                    rep = self._replica_by_id(handle.pinned_replica)
                    if rep is not None:
                        rep.scheduler.cancel(handle.request)
            elif handle.status == "running":
                rep = self._replica_by_id(handle.replica_id)
                if rep is not None:
                    rep.scheduler.cancel(handle.request)
                    if handle in rep.active:
                        rep.active.remove(handle)
            else:
                return
            self.metrics.inc("cancelled")
            handle._finish("cancelled")

    # -- the pump ----------------------------------------------------------

    def pump(self) -> int:
        """One serving round: drain dead replicas, admit (with preemption),
        step every replica with work, deliver tokens.  Returns the tokens
        processed; 0 means idle."""
        with self._lock:
            self._round += 1
            for r in self.router.replicas:
                r.new_round(self._round)
            self._drain_dead()
            if not self.router.healthy():
                # no caller to raise to in start() mode: fail pending
                # handles so consumers parked in stream() unblock
                if any(self._queues.values()):
                    self._fail_pending_no_replica()
                return 0
            self._admit_all()
            if self.params.preemption and self._queues["interactive"]:
                if self._preempt_for_interactive():
                    self._admit_all()
            n = 0
            for rep in self.router.healthy():
                if rep.scheduler.has_work:
                    n += rep.engine.step(
                        temperature=self.params.temperature,
                        eos_token_id=self.params.eos_token_id)
                self._deliver(rep)
            return n

    def run_until_idle(self, max_rounds: int = 100_000) -> None:
        """Pump until no queued or in-flight work remains.  Raises
        :class:`NoHealthyReplicaError` if work is pending with every replica
        dead."""
        for _ in range(max_rounds):
            with self._lock:
                pending = (any(self._queues.values())
                           or any(r.active for r in self.router.replicas))
                if not pending:
                    return
                if not self.router.healthy():
                    self._drain_dead()
                    self._fail_pending_no_replica()
                    raise NoHealthyReplicaError(
                        "pending serving work but no healthy replica")
            self.pump()
        raise RuntimeError(f"run_until_idle: no quiescence in "
                           f"{max_rounds} rounds")

    # -- background drive --------------------------------------------------

    def start(self, idle_sleep_s: float = 0.001) -> None:
        if any(getattr(r.engine, "tp", 1) > 1 for r in self.router.replicas):
            raise RuntimeError("under tensor parallelism each rank drives "
                               "pump() itself: a background thread would "
                               "let the ranks' steps diverge")
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._serve_loop, args=(idle_sleep_s,), daemon=True,
                name="ds-serving-frontend")
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            self._stop.set()
            t.join(timeout=10.0)
            if t.is_alive():
                raise RuntimeError("serving front-end loop did not stop "
                                   "within 10 s")

    def _serve_loop(self, idle_sleep_s: float) -> None:
        log_dist("serving front-end loop started")
        while not self._stop.is_set():
            if self.pump() == 0:
                self._stop.wait(idle_sleep_s)

    # -- internals (lock held) ---------------------------------------------

    def _replica_by_id(self, rid: Optional[int]) -> Optional[Replica]:
        for r in self.router.replicas:
            if r.id == rid:
                return r
        return None

    def prefix_hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from shared pages,
        over every replica."""
        hits = looks = 0
        for r in self.router.replicas:
            p = getattr(r.scheduler, "prefix", None)
            if p is not None:
                hits += p.hit_tokens
                looks += p.lookup_tokens
        return hits / looks if looks else 0.0

    def _reset_for_replay(self, h: ServingHandle) -> None:
        """The dead replica's state is unreachable: the handle restarts from
        its prompt elsewhere, delivery resuming past what was streamed."""
        h.request = None
        h.replica_id = None
        h.pinned_replica = None
        h.preempted = False
        h.consumed = 0
        h.replays += 1
        h.status = "queued"

    def _drain_dead(self) -> None:
        for rep in self.router.replicas:
            if rep.healthy() or rep.id in self._drained:
                continue
            self._drained.add(rep.id)
            moved = 0
            # preempted handles wait in the class queues, pinned to this
            # replica's pages: restart them elsewhere
            for q in self._queues.values():
                for h in q:
                    if h.request is not None and h.pinned_replica == rep.id:
                        self._reset_for_replay(h)
                        moved += 1
            # in-flight work goes to the class front, earliest first
            for h in reversed(rep.active):
                self._reset_for_replay(h)
                self._queues[h.klass].insert(0, h)
                moved += 1
            rep.active.clear()
            if moved:
                self.metrics.inc("requeued_replica_death", moved)
            log_dist(f"serving: replica{rep.id} drained "
                     f"({rep.dead_reason}); {moved} requests re-queued")

    def _fail_pending_no_replica(self) -> None:
        err = NoHealthyReplicaError(
            "all replicas dead: "
            + "; ".join(f"replica{r.id}: {r.dead_reason}"
                        for r in self.router.replicas))
        for q in self._queues.values():
            for h in q:
                self.metrics.inc("failed")
                h._finish("failed", err)
            q.clear()

    def _admit_all(self) -> None:
        for klass in CLASSES:
            q = self._queues[klass]
            while q:
                if not self._try_admit(q[0]):
                    break  # FIFO within a class: no overtaking
                q.pop(0)
            # strict priority: a class that could not drain blocks the
            # lower ones this round, unless nothing is seated anywhere (then
            # only a lower-class admission can free what the head waits on)
            if q and any(r.scheduler.has_work for r in self.router.healthy()):
                break

    def _reserve_pages(self, rep: Replica, klass: str) -> int:
        if klass == "interactive":
            return 0
        allocatable = rep.scheduler.cache.num_blocks - 1
        return int(self.params.interactive_reserve_frac * allocatable)

    def _try_admit(self, h: ServingHandle) -> bool:
        if h.request is not None:
            # preempted: pinned to the replica holding its KV pages
            rep = self._replica_by_id(h.pinned_replica)
            if rep is None or not rep.healthy():
                return False
            if not rep.scheduler.resume(h.request):
                return False
            h.status = "running"
            h.replica_id = rep.id
            rep.active.append(h)
            return True
        rejected = {r: 0 for r in ("slots", "pages", "token_budget")}
        for rep in self.router.route_candidates(h.prompt):
            if (rep.outstanding_tokens() + len(h.prompt) + h.max_new_tokens
                    > self.params.max_outstanding_tokens):
                rejected["token_budget"] += 1
                continue
            reserve = self._reserve_pages(rep, h.klass)
            if not rep.scheduler.can_admit(h.prompt, h.max_new_tokens,
                                           reserve_pages=reserve):
                if rep.scheduler.can_admit(h.prompt, h.max_new_tokens,
                                           reserve_pages=reserve,
                                           ignore_slots=True):
                    rejected["slots"] += 1
                else:
                    rejected["pages"] += 1
                continue
            h.request = rep.engine.put(h.prompt, h.max_new_tokens)
            h.request.priority = CLASSES.index(h.klass)
            rep.scheduler.admit_now(h.request)
            h.status = "running"
            h.replica_id = rep.id
            h.pinned_replica = rep.id
            h.admitted_at = self.clock()
            rep.active.append(h)
            return True
        if any(rejected.values()):
            count_admission_reject(self.metrics,
                                   max(rejected, key=rejected.get))
        return False

    def _preempt_for_interactive(self) -> bool:
        """Free a decode slot for the interactive head by bumping a seated
        background request; True when a preemption happened."""
        head = self._queues["interactive"][0]
        healthy = self.router.healthy()
        if any(rep.scheduler.can_admit(head.prompt, head.max_new_tokens)
               for rep in healthy):
            return False  # admissible without preemption
        for rep in healthy:
            if not rep.scheduler.can_admit(head.prompt, head.max_new_tokens,
                                           ignore_slots=True):
                # page-blocked here: the victim's pages stay resident, so
                # bumping it cannot free what the head needs
                continue
            victims = [h for h in rep.active
                       if h.klass == "background" and h.request is not None
                       and h.request.slot >= 0
                       and h.request.state.value in ("running", "prefill")]
            if not victims:
                continue
            # the request expected to hold its slot longest
            victim = max(victims, key=lambda h: h.request.remaining_budget)
            rep.scheduler.preempt(victim.request)
            rep.active.remove(victim)
            victim.status = "queued"
            victim.preempted = True
            self._queues["background"].insert(0, victim)
            self.metrics.inc("preemptions")
            return True
        return False

    def _deliver(self, rep: Replica) -> None:
        for h in list(rep.active):
            req = h.request
            for tok in req.generated[h.consumed:]:
                h.consumed += 1
                if h.consumed > h.delivered:
                    if h.first_token_at is None:
                        h.first_token_at = self.clock()
                        self.metrics.record_ttft(h.klass, h.ttft_ms,
                                                 ref=h.uid)
                    h.delivered += 1
                    h._push(int(tok))
            if req.state.value == "done" and h.status == "running":
                rep.active.remove(h)
                h.finished_at = self.clock()
                gen_s = h.finished_at - (h.first_token_at or h.finished_at)
                self.metrics.record_completion(h.klass, h.delivered, gen_s)
                h._finish("done")

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = self.metrics.snapshot()
            out["queues"] = {c: len(q) for c, q in self._queues.items()}
            out["router"] = self.router.snapshot()
            out["prefix_hit_rate"] = round(self.prefix_hit_rate(), 4)
            out["params"] = dataclasses.asdict(self.params)
            return out
