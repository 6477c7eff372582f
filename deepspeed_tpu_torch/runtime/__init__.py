"""The training runtime: config, engine, optimizers, schedules, precision."""

from .config import DeepSpeedConfig
from .engine import DeepSpeedEngine
from .entry import initialize
from .hybrid_engine import DeepSpeedHybridEngine
from .tensor_parallel import tp_model_init

__all__ = ["DeepSpeedConfig", "DeepSpeedEngine", "DeepSpeedHybridEngine",
           "initialize", "tp_model_init"]
