"""Curriculum difficulty schedules.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/
curriculum_scheduler.py``: ``difficulty(step)`` between ``min_difficulty``
and ``max_difficulty`` under ``fixed_linear``, ``fixed_root``,
``fixed_discrete`` or a custom function; the fixed linear and root
schedules snap down to multiples of ``difficulty_step`` (for a seqlen
curriculum: a few sequence lengths, each a multiple of the kernels' tile).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:
    """difficulty(step) of the reference's schedule family.

    config keys: ``schedule_type`` and ``schedule_config``:
      fixed_linear:   {total_curriculum_step, difficulty_step}
      fixed_root:     {total_curriculum_step, difficulty_step, root_degree}
      fixed_discrete: {difficulty: [...], max_step: [...]}
    plus top-level ``min_difficulty`` / ``max_difficulty``.
    """

    def __init__(self, config: Dict[str, Any],
                 custom_fn: Optional[Callable[[int], int]] = None):
        self.min = int(config.get("min_difficulty", 1))
        self.max = int(config.get("max_difficulty", self.min))
        self.schedule_type = config.get("schedule_type", FIXED_LINEAR)
        self.schedule = dict(config.get("schedule_config", {}))
        self.custom_fn = custom_fn
        if self.schedule_type == CUSTOM and custom_fn is None:
            raise ValueError("custom schedule needs custom_fn")
        if self.schedule_type in (FIXED_LINEAR, FIXED_ROOT):
            self.total = int(self.schedule.get("total_curriculum_step", 1))
            self.step_quantum = int(self.schedule.get("difficulty_step", 8))
        self.current_difficulty = self.min
        self.first_step = True

    def _fixed_linear(self, step: int) -> int:
        frac = min(step / max(self.total, 1), 1.0)
        return int(self.min + (self.max - self.min) * frac)

    def _fixed_root(self, step: int) -> int:
        degree = float(self.schedule.get("root_degree", 2))
        frac = min(step / max(self.total, 1), 1.0) ** (1.0 / degree)
        return int(self.min + (self.max - self.min) * frac)

    def _fixed_discrete(self, step: int) -> int:
        diffs = self.schedule["difficulty"]
        for d, s in zip(diffs, self.schedule["max_step"]):
            if step <= s:
                return int(d)
        return int(diffs[-1])

    def get_difficulty(self, step: int) -> int:
        if self.schedule_type == FIXED_LINEAR:
            d = self._fixed_linear(step)
        elif self.schedule_type == FIXED_ROOT:
            d = self._fixed_root(step)
        elif self.schedule_type == FIXED_DISCRETE:
            return min(self._fixed_discrete(step), self.max)
        elif self.schedule_type == CUSTOM:
            return int(self.custom_fn(step))
        else:
            raise ValueError(f"unknown schedule_type {self.schedule_type}")
        q = max(self.step_quantum, 1)
        d = (d // q) * q
        return max(self.min, min(d, self.max))

    def update_difficulty(self, step: int) -> int:
        self.current_difficulty = self.get_difficulty(step)
        return self.current_difficulty
