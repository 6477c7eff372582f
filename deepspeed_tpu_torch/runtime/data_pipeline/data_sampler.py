"""Curriculum data sampling.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``:

* sample pools (:class:`CurriculumSampler`, :class:`DeepSpeedDataSampler`):
  only samples whose difficulty is at most the schedule's value are drawn,
  deterministically in (seed, step); the caller supplies a difficulty per
  sample;
* sequence truncation (:func:`truncate_batch`, :class:`CurriculumDataLoader`):
  the seqlen curriculum, batches cut to the scheduled length.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from ..dataloader import default_collate
from .curriculum_scheduler import CurriculumScheduler


class CurriculumSampler:
    """Sample indices whose difficulty is at most the schedule's value."""

    def __init__(self, difficulties: Sequence[float],
                 scheduler: CurriculumScheduler, seed: int = 1234):
        self.difficulties = np.asarray(difficulties)
        self.order = np.argsort(self.difficulties, kind="stable")
        self.sorted_difficulties = self.difficulties[self.order]
        self.scheduler = scheduler
        self.seed = seed

    def eligible_count(self, step: int) -> int:
        d = self.scheduler.get_difficulty(step)
        return int(np.searchsorted(self.sorted_difficulties, d, side="right"))

    def sample(self, step: int, batch_size: int) -> np.ndarray:
        """A batch of indices drawn uniformly from the eligible pool
        (deterministic in (seed, step))."""
        n = self.eligible_count(step)
        if n == 0:
            raise ValueError("no samples eligible at current difficulty "
                             f"{self.scheduler.get_difficulty(step)}")
        rng = np.random.default_rng((self.seed, step))
        return self.order[rng.integers(0, n, size=batch_size)]


class DeepSpeedDataSampler:
    """An endless curriculum batch stream over a dataset and a difficulty
    per sample; batches collated into CPU tensors."""

    def __init__(self, dataset: Any, difficulties: Sequence[float],
                 batch_size: int, curriculum_config: Dict[str, Any],
                 seed: int = 1234):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.scheduler = CurriculumScheduler(curriculum_config)
        self.sampler = CurriculumSampler(difficulties, self.scheduler, seed)
        self.global_step = 0

    def set_step(self, step: int) -> None:
        self.global_step = int(step)
        self.scheduler.update_difficulty(step)

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        idx = self.sampler.sample(self.global_step, self.batch_size)
        self.global_step += 1
        return default_collate([self.dataset[int(i)] for i in idx])


class CurriculumDataLoader:
    """A batch iterable cut to the schedule's sequence length at the step
    ``step_fn()`` returns when a batch is drawn (the legacy
    ``curriculum_learning`` group's behaviour)."""

    def __init__(self, loader: Any, scheduler: CurriculumScheduler,
                 step_fn: Any):
        self.loader = loader
        self.scheduler = scheduler
        self.step_fn = step_fn  # () -> the current global step

    def __iter__(self) -> Iterator[Any]:
        for batch in self.loader:
            seqlen = self.scheduler.get_difficulty(int(self.step_fn()))
            yield (truncate_batch(batch, seqlen)
                   if isinstance(batch, dict) else batch)

    def __len__(self) -> int:
        return len(self.loader)


def truncate_batch(batch: Dict[str, Any], seqlen: int,
                   keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Cut the sequence-shaped entries (rank 2 and up) of ``batch`` to
    ``seqlen`` along dim 1."""
    keys = keys or ("input_ids", "attention_mask", "labels",
                    "token_type_ids")
    out = dict(batch)
    for k in keys:
        v = out.get(k)
        if v is not None and getattr(v, "ndim", 0) >= 2:
            out[k] = v[:, :seqlen]
    return out
