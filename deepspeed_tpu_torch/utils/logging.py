"""Rank-aware logging for the PyTorch port.

Counterpart of ``deepspeed_tpu/utils/logging.py``: ``log_dist`` logs only
on the selected ranks (the ``torch.distributed`` rank when a process group
is up, else 0) and ``warn_once`` says a recurring warning exactly once.
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional

import torch.distributed as dist

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def _create_logger(name: str = "deepspeed_tpu_torch") -> logging.Logger:
    lg = logging.getLogger(name)
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(LOG_FORMAT,
                                               datefmt="%Y-%m-%d %H:%M:%S"))
        lg.addHandler(handler)
        lg.propagate = False
        lg.setLevel(logging.INFO)
    return lg


logger = _create_logger()


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[List[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` on the given ranks (default rank 0; ``[-1]`` = all)."""
    rank = _rank()
    ranks = ranks if ranks is not None else [0]
    if -1 in ranks or rank in ranks:
        logger.log(level, f"[Rank {rank}] {message}")


#: keys already warned about — process-wide, so a warning raised every
#: step is said once instead of flooding the log
_warned: set = set()


def warn_once(key: str, message: str) -> None:
    if key in _warned:
        return
    _warned.add(key)
    logger.warning(message)
