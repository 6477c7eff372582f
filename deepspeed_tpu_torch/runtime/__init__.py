"""The training runtime: config, engine, optimizers, schedules, precision."""

from .config import DeepSpeedConfig
from .engine import DeepSpeedEngine
from .entry import initialize

__all__ = ["DeepSpeedConfig", "DeepSpeedEngine", "initialize"]
