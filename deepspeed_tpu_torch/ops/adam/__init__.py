"""The host optimizers of ZeRO-Offload and ZeRO-Infinity (C++, through
``ctypes``)."""

from .cpu_adagrad import DeepSpeedCPUAdagrad
from .cpu_adam import DeepSpeedCPUAdam
from .cpu_lion import DeepSpeedCPULion

__all__ = ["DeepSpeedCPUAdagrad", "DeepSpeedCPUAdam", "DeepSpeedCPULion"]
