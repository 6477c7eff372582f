"""The asynchronous file I/O engine of the NVMe tier."""

from .aio_handle import AIOHandle

__all__ = ["AIOHandle"]
