"""Multi-replica routing: health, prefix affinity, least outstanding tokens.

Counterpart of ``deepspeed_tpu/serving/router.py``.  Placement policy, in
order: only healthy replicas (not marked dead, probe passing); the replica
whose prefix trie holds the longest indexed prefix of the prompt (at least
``affinity_min_tokens``); the fewest admitted-but-unfinished tokens; the
replica id.  Not ported yet: the device-unresponsive latch, the memory
ledger attribution and the MoE hot-expert penalty.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class Replica:
    """One engine behind the router + its serving bookkeeping."""

    def __init__(self, engine: Any, replica_id: int,
                 probe: Optional[Callable[[], bool]] = None):
        self.engine = engine
        self.id = int(replica_id)
        self.scheduler = engine.scheduler
        #: handles admitted to this replica and not yet finished
        self.active: List[Any] = []
        self._probe = probe
        self._dead_reason: Optional[str] = None
        #: one probe evaluation per pump round
        self._probe_round = 0
        self._probe_seen = -1
        self._probe_ok = True

    # -- health ------------------------------------------------------------

    def new_round(self, gen: int) -> None:
        """Invalidate the probe memo (the front-end, once per pump)."""
        self._probe_round = gen

    def healthy(self) -> bool:
        if self._dead_reason is not None:
            return False
        if self._probe is not None:
            if self._probe_seen != self._probe_round:
                self._probe_seen = self._probe_round
                self._probe_ok = self._run_probe()
            if not self._probe_ok:
                return False
        return True

    def _run_probe(self) -> bool:
        try:
            ok = bool(self._probe())
        except Exception as e:  # a raising probe means a dead replica
            self._dead_reason = f"health probe raised: {e!r}"
            return False
        if not ok:
            self._dead_reason = "health probe reported dead"
        return ok

    def mark_dead(self, reason: str) -> None:
        self._dead_reason = str(reason)

    @property
    def dead_reason(self) -> Optional[str]:
        return self._dead_reason

    # -- load --------------------------------------------------------------

    def outstanding_tokens(self) -> int:
        total = 0
        for h in self.active:
            req = h.request
            if req is None:
                continue
            total += max(len(req.prompt) - req.prefilled, 0) \
                + req.remaining_budget
        return total

    def snapshot(self) -> dict:
        sched = self.scheduler
        out = {"id": self.id,
               "healthy": self._dead_reason is None,
               "active_requests": len(self.active),
               "outstanding_tokens": self.outstanding_tokens()}
        if self._dead_reason:
            out["dead_reason"] = self._dead_reason
        if hasattr(sched, "prefix"):
            out["prefix"] = sched.prefix.stats()
            out["kv_pages_free"] = sched.allocator.num_free
            out["kv_pages_cached"] = sched.allocator.num_cached
            out["preemptions"] = sched.preemptions
        return out


class ReplicaRouter:
    """Least-outstanding-tokens with prefix affinity over healthy
    replicas."""

    def __init__(self, replicas: List[Replica],
                 affinity_min_tokens: int = 16):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.affinity_min_tokens = int(affinity_min_tokens)

    def healthy(self) -> List[Replica]:
        return [r for r in self.replicas if r.healthy()]

    def route_candidates(self, prompt: List[int]) -> List[Replica]:
        """Healthy replicas, best first: prefix affinity, then load, then
        id."""
        def score(r: Replica):
            affinity = 0
            if hasattr(r.scheduler, "match_tokens"):
                m = r.scheduler.match_tokens(prompt)
                if m >= self.affinity_min_tokens:
                    affinity = m
            return (-affinity, r.outstanding_tokens(), r.id)

        return sorted(self.healthy(), key=score)

    def snapshot(self) -> dict:
        return {"replicas": [r.snapshot() for r in self.replicas]}
