"""Data loaders: ``DeepSpeedDataLoader`` (one data-parallel rank's rows of
each global batch) and ``RepeatingLoader``.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``.  ``batch_size`` is
the global batch (``train_batch_size``: micro x gas x dp) one
``train_step`` consumes over all ranks; the sample order is JAX's
(``np.random.default_rng(seed + epoch)`` when shuffled), and rank ``r`` of
``dp`` yields the rows ``[r n, (r + 1) n)`` of each global batch, ``n =
batch_size / dp``: the contiguous block JAX's batch sharding gives a
process (``_local_rows``), so the ranks' union is JAX's global batch.  A
final partial batch that does not split over the ranks goes whole to every
rank, as JAX replicates it (the mean over the ranks is the batch's mean).

Batches are CPU tensors (pinned when ``pin_memory``); the engine moves
them to its device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch


class RepeatingLoader:
    """Wraps an iterable to restart it on StopIteration."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self._iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self.loader)
            return next(self._iter)


def default_collate(items: list) -> Any:
    """Stack a list of samples (arrays, tensors, numbers, or dicts, lists
    and tuples of them) into one batch of tensors."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(default_collate(list(col))
                           for col in zip(*items))
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return torch.from_numpy(np.stack([np.asarray(x) for x in items]))


def _as_tensors(tree: Any, pin: bool) -> Any:
    if isinstance(tree, dict):
        return {k: _as_tensors(v, pin) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v, pin) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor) and pin and not tree.is_pinned():
        tree = tree.pin_memory()
    return tree


class DeepSpeedDataLoader:
    """Yields this rank's rows of each global batch of ``dataset`` (any
    indexable of samples), collated by ``collate_fn`` (default:
    :func:`default_collate`) into CPU tensors."""

    def __init__(self, dataset: Any, batch_size: int, dp_rank: int = 0,
                 dp_world_size: int = 1,
                 collate_fn: Optional[Callable] = None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.dp_rank, self.dp_world_size = int(dp_rank), int(dp_world_size)
        if self.batch_size % self.dp_world_size:
            raise ValueError(f"batch_size={batch_size} does not split over "
                             f"{dp_world_size} data-parallel ranks")
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pin_memory = pin_memory
        self._epoch = 0
        #: batches of the next epoch to skip (set by resume_from_samples)
        self._resume_skip_batches = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def resume_from_samples(self, consumed: int) -> None:
        """Point the cursor at an absolute sample position: the next batch
        boundary at or past ``consumed`` (rounding up: skipping a few
        unseen samples beats feeding seen ones again); past what this
        batch size yields from the epoch, the next epoch's head."""
        consumed = max(int(consumed), 0)
        n = len(self.dataset)
        if n <= 0 or self.batch_size <= 0:
            self._epoch, self._resume_skip_batches = 0, 0
            return
        self._epoch = consumed // n
        within = consumed - self._epoch * n
        skip = -(-within // self.batch_size)  # ceil
        per_epoch_batches = n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)
        if skip >= per_epoch_batches:
            self._epoch += 1
            skip = 0
        self._resume_skip_batches = skip

    def __iter__(self) -> Iterator[Any]:
        order = self._order()
        self._epoch += 1
        skip, self._resume_skip_batches = self._resume_skip_batches, 0
        if skip:
            order = order[skip * self.batch_size:]
        for start in range(0, len(order), self.batch_size):
            sel = order[start:start + self.batch_size]
            if len(sel) < self.batch_size and self.drop_last:
                break
            if len(sel) % self.dp_world_size == 0:
                n = len(sel) // self.dp_world_size
                sel = sel[self.dp_rank * n:(self.dp_rank + 1) * n]
            batch = self.collate_fn([self.dataset[int(i)] for i in sel])
            yield _as_tensors(batch, self.pin_memory)
