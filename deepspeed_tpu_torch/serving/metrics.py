"""Serving observability: per-latency-class TTFT and per-token latency.

Counterpart of the in-process part of ``deepspeed_tpu/serving/metrics.py``:
:class:`LatencyTracker` keeps a bounded sample window with exact
percentiles, :class:`ServingMetrics` one TTFT and one TPOT tracker per class
plus the serving counters.  Not ported yet: publishing through the telemetry
hub, the disaggregation breakdown, and the per-request lifecycle records.
All methods are called with the front-end's lock held.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

#: latency classes in strict priority order: admission drains them left to
#: right, preemption moves the rightmost work out of the way
CLASSES = ("interactive", "batch", "background")

#: why an admission attempt bounced: no free decode slot, not enough KV
#: pages, the per-replica outstanding-token budget
ADMISSION_REJECT_REASONS = ("slots", "pages", "token_budget")


class LatencyTracker:
    """Bounded sample window with exact percentiles (ms); a sample may carry
    an exemplar ref so the window's tail is traceable."""

    def __init__(self, max_samples: int = 512):
        self._samples: deque = deque(maxlen=int(max_samples))
        self._refs: deque = deque(maxlen=int(max_samples))

    def observe(self, ms: float, ref: Optional[Any] = None) -> None:
        self._samples.append(float(ms))
        self._refs.append(ref)

    @property
    def count(self) -> int:
        return len(self._samples)

    def percentile(self, p: float) -> float:
        """Exact percentile over the window (nearest rank); 0.0 empty."""
        if not self._samples:
            return 0.0
        ordered = sorted(self._samples)
        rank = min(len(ordered) - 1,
                   max(0, int(round(p / 100.0 * (len(ordered) - 1)))))
        return ordered[rank]

    def exemplar(self) -> Optional[tuple]:
        """``(ms, ref)`` of the slowest ref-carrying sample in the window."""
        best = None
        for ms, ref in zip(self._samples, self._refs):
            if ref is not None and (best is None or ms > best[0]):
                best = (ms, ref)
        return best

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": float(self.count),
                               "p50_ms": round(self.percentile(50), 3),
                               "p99_ms": round(self.percentile(99), 3)}
        ex = self.exemplar()
        if ex is not None:
            out["p99_exemplar"] = ex[1]
            out["p99_exemplar_ms"] = round(ex[0], 3)
        return out


def count_admission_reject(metrics: "ServingMetrics", reason: str) -> None:
    """One admission rejection, attributed to its blocking resource."""
    metrics.inc(f"admission_rejected_{reason}")


class ServingMetrics:
    """The serving plane's numbers: per-class latency + counters."""

    def __init__(self, window: int = 512):
        self.ttft = {c: LatencyTracker(window) for c in CLASSES}
        self.tpot = {c: LatencyTracker(window) for c in CLASSES}
        self.tokens = {c: 0 for c in CLASSES}
        self.completed = {c: 0 for c in CLASSES}
        self.counters: Dict[str, int] = {
            "submitted": 0, "cancelled": 0, "failed": 0, "preemptions": 0,
            "requeued_replica_death": 0}
        for r in ADMISSION_REJECT_REASONS:
            self.counters[f"admission_rejected_{r}"] = 0

    def inc(self, name: str, v: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def record_ttft(self, klass: str, ms: float,
                    ref: Optional[Any] = None) -> None:
        self.ttft[klass].observe(ms, ref=ref)

    def record_completion(self, klass: str, n_tokens: int,
                          gen_time_s: float) -> None:
        self.completed[klass] += 1
        self.tokens[klass] += int(n_tokens)
        if n_tokens > 1 and gen_time_s > 0:
            self.tpot[klass].observe(gen_time_s * 1e3 / (n_tokens - 1))

    def snapshot(self) -> Dict[str, Any]:
        classes = {c: {"ttft": self.ttft[c].summary(),
                       "tpot": self.tpot[c].summary(),
                       "tokens": self.tokens[c],
                       "completed": self.completed[c]} for c in CLASSES}
        return {"classes": classes, "counters": dict(self.counters)}
