"""AIOHandle: the Python surface of the asynchronous file I/O engine, the
NVMe tier of ZeRO-Infinity.

Counterpart of ``deepspeed_tpu/ops/aio/aio_handle.py`` (the reference's
``aio_handle(block_size, queue_depth, single_submit, overlap_events,
thread_count)`` with ``async_pread`` / ``async_pwrite`` / ``wait``): a
worker-thread pool in ``csrc/host/aio_engine.cpp`` (the JAX package's
``csrc/aio/aio_engine.cpp``, unchanged) moves the bytes of contiguous CPU
tensors to and from files, through ``O_DIRECT`` where the file system
allows it (the page cache is bypassed) and buffered I/O otherwise and for
tails under 4 KiB.  ``stats`` splits the bytes moved between the two.  A
tensor must stay alive and untouched until ``wait`` returns.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..op_builder import ASYNC_IO


def _lib() -> ctypes.CDLL:
    lib = ASYNC_IO.load()
    if not getattr(lib, "_ds_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ds_aio_new.restype = ptr
        lib.ds_aio_new.argtypes = [ctypes.c_int] * 5
        lib.ds_aio_free.argtypes = [ptr]
        for fn in (lib.ds_aio_pread, lib.ds_aio_pwrite,
                   lib.ds_aio_pwrite_trunc):
            fn.argtypes = [ptr, ptr, i64, ctypes.c_char_p, i64]
        for fn in (lib.ds_aio_wait, lib.ds_aio_read_retries):
            fn.argtypes = [ptr]
            fn.restype = i64
        lib.ds_aio_stats.argtypes = [ptr, ctypes.POINTER(i64),
                                     ctypes.POINTER(i64)]
        lib._ds_typed = True
    return lib


def _buffer(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"aio needs a contiguous CPU tensor, got one on "
                         f"{t.device} (contiguous={t.is_contiguous()})")
    return t


class AIOHandle:
    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 32,
                 single_submit: bool = False, overlap_events: bool = True,
                 thread_count: int = 4):
        self.lib = _lib()
        self._h = self.lib.ds_aio_new(int(block_size), int(queue_depth),
                                      int(single_submit),
                                      int(overlap_events), int(thread_count))
        if not self._h:
            raise RuntimeError("ds_aio_new failed")

    def async_pread(self, buf: torch.Tensor, path: str,
                    offset: int = 0) -> None:
        """Fill ``buf`` from ``path`` at ``offset`` (queued)."""
        buf = _buffer(buf)
        self.lib.ds_aio_pread(self._h, buf.data_ptr(),
                              buf.numel() * buf.element_size(),
                              str(path).encode(), int(offset))

    def async_pwrite(self, buf: torch.Tensor, path: str, offset: int = 0,
                     truncate: bool = False) -> None:
        """Write ``buf`` to ``path`` at ``offset`` (queued); ``truncate``
        drops the file's bytes past this write (whole-file rewrites)."""
        buf = _buffer(buf)
        fn = self.lib.ds_aio_pwrite_trunc if truncate else \
            self.lib.ds_aio_pwrite
        fn(self._h, buf.data_ptr(), buf.numel() * buf.element_size(),
           str(path).encode(), int(offset))

    def sync_pread(self, buf: torch.Tensor, path: str,
                   offset: int = 0) -> int:
        self.async_pread(buf, path, offset)
        return self.wait()

    def sync_pwrite(self, buf: torch.Tensor, path: str, offset: int = 0,
                    truncate: bool = False) -> int:
        self.async_pwrite(buf, path, offset, truncate=truncate)
        return self.wait()

    def wait(self) -> int:
        """Drain the queue; the number of operations that FAILED since the
        last wait."""
        return int(self.lib.ds_aio_wait(self._h))

    def stats(self) -> Dict[str, int]:
        """Bytes moved through ``O_DIRECT`` and through buffered I/O (a
        file system without ``O_DIRECT``, such as tmpfs, and tails under 4
        KiB), and the reads retried."""
        d, b = ctypes.c_int64(0), ctypes.c_int64(0)
        self.lib.ds_aio_stats(self._h, ctypes.byref(d), ctypes.byref(b))
        return {"direct_bytes": int(d.value), "buffered_bytes": int(b.value),
                "read_retries": int(self.lib.ds_aio_read_retries(self._h))}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self.lib.ds_aio_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: the library may be gone
            pass
