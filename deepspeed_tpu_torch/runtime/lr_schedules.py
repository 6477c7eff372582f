"""LR schedules: pure functions ``step -> lr``, and the stateful wrapper.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (the reference's
``LRRangeTest``, ``OneCycle``, ``WarmupLR``, ``WarmupDecayLR``,
``WarmupCosineLR``, and the constant rate the engine uses without a
scheduler).  The JAX schedules run in float32 on an int32 step; these repeat
that arithmetic in numpy float32, operation by operation, so the two give the
same rate.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np

LRRANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LRRANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]

Schedule = Callable[[int], float]
F32 = np.float32


def _ratio(num: int, den: int) -> np.float32:
    return F32(num) / F32(den)


def _warmup(step: int, warmup_min_lr: float, warmup_max_lr: float,
            warmup_num_steps: int, warmup_type: str = "log") -> np.float32:
    """Shared warmup ramp; "log" (the reference default) rises fast early."""
    frac = np.clip(_ratio(step, max(warmup_num_steps, 1)), F32(0), F32(1))
    gamma = (np.log1p(frac * F32(math.e - 1.0)) if warmup_type == "log"
             else frac)
    return F32(warmup_min_lr) + F32(warmup_max_lr - warmup_min_lr) * gamma


def constant_lr(lr: float) -> Schedule:
    return lambda step: float(F32(lr))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_: Any) -> Schedule:
    return lambda step: float(_warmup(step, warmup_min_lr, warmup_max_lr,
                                      warmup_num_steps, warmup_type))


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_: Any) -> Schedule:
    """Linear decay to 0 after the warmup."""

    def schedule(step: int) -> float:
        if step < warmup_num_steps:
            return float(_warmup(step, warmup_min_lr, warmup_max_lr,
                                 warmup_num_steps, warmup_type))
        decay = np.clip(_ratio(total_num_steps - step,
                               max(total_num_steps - warmup_num_steps, 1)),
                        F32(0), F32(1))
        return float(F32(warmup_max_lr) * decay)

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     warmup_max_lr: float = 1e-3, warmup_type: str = "log",
                     **_: Any) -> Schedule:
    """Warmup, then cosine decay to ``cos_min_ratio x warmup_max_lr``."""

    def schedule(step: int) -> float:
        if step < warmup_num_steps:
            return float(_warmup(step, warmup_min_ratio * warmup_max_lr,
                                 warmup_max_lr, warmup_num_steps,
                                 warmup_type))
        progress = np.clip(_ratio(step - warmup_num_steps,
                                  max(total_num_steps - warmup_num_steps, 1)),
                           F32(0), F32(1))
        cosine = F32(cos_min_ratio) + F32((1 - cos_min_ratio) * 0.5) * (
            F32(1) + np.cos(F32(np.pi) * progress))
        return float(F32(warmup_max_lr) * cosine)

    return schedule


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False,
                  **_: Any) -> Schedule:
    """LR range test: the rate grows with the step."""

    def schedule(step: int) -> float:
        interval = _ratio(step, lr_range_test_step_size)
        if lr_range_test_staircase:
            interval = np.floor(interval)
        return float(F32(lr_range_test_min_lr) * (
            F32(1) + interval * F32(lr_range_test_step_rate)))

    return schedule


def one_cycle(cycle_min_lr: float = 1e-3, cycle_max_lr: float = 1e-2,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_: Any) -> Schedule:
    """1cycle: min to max over the first phase, back over the second, then
    decay (or hold the minimum)."""
    second = cycle_second_step_size or cycle_first_step_size
    cycle_len = cycle_first_step_size + second
    span = F32(cycle_max_lr - cycle_min_lr)

    def schedule(step: int) -> float:
        if step < cycle_first_step_size:
            up = np.clip(_ratio(step, cycle_first_step_size), F32(0), F32(1))
            return float(F32(cycle_min_lr) + span * up)
        if step < cycle_len:
            down = np.clip(_ratio(step - cycle_first_step_size, second),
                           F32(0), F32(1))
            return float(F32(cycle_max_lr) - span * down)
        if decay_step_size > 0:
            return float(F32(cycle_min_lr) * F32(1 - decay_lr_rate) ** _ratio(
                step - cycle_len, decay_step_size))
        return float(F32(cycle_min_lr))

    return schedule


_FACTORIES: Dict[str, Callable[..., Schedule]] = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    LRRANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
}


def get_lr_schedule(name: str, params: Dict[str, Any]) -> Schedule:
    if name not in _FACTORIES:
        raise ValueError(
            f"Unknown scheduler '{name}'; valid: {VALID_LR_SCHEDULES}")
    clean = {k: v for k, v in params.items()
             if not (isinstance(v, str) and v == "auto") and v is not None}
    return _FACTORIES[name](**clean)


class LRScheduler:
    """The reference's scheduler object: ``step()`` / ``get_lr()`` /
    ``state_dict()`` over a schedule."""

    def __init__(self, schedule: Schedule, last_step: int = 0):
        self.schedule = schedule
        self.last_step = last_step

    def step(self, increment: int = 1) -> None:
        self.last_step += increment

    def get_lr(self) -> List[float]:
        return [float(self.schedule(self.last_step))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def state_dict(self) -> Dict[str, Any]:
        return {"last_step": self.last_step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.last_step = int(state["last_step"])
