"""Builds the port's CUDA sources with ``nvcc`` at first use.

Role of ``deepspeed_tpu/ops/op_builder/builder.py``: compile the repo's own
native sources once and load them.  Here the sources are the ``.cu`` files
of ``deepspeed_tpu_torch/csrc/``, compiled for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``: one
``nvcc -c`` per source, all started together, then one link.

The library lives in ``build/deepspeed_tpu_torch/`` beside the package
(``.gitignore`` lists ``build/``) and is keyed by a hash of the sources and
flags, so a fresh checkout builds it on the first kernel call and a changed
source never loads a stale library.  It builds only from the repo's
sources, and raises when ``nvcc`` cannot be found.

The host half of ZeRO-Offload and ZeRO-Infinity is two C++ sources in
``csrc/host/`` (the roles of ``CPUAdamBuilder`` and ``AsyncIOBuilder`` of
``deepspeed_tpu/ops/op_builder/builder.py``): :class:`HostBuilder` compiles
each with ``g++ -O3 -march=native -shared -fPIC`` (``-fopenmp`` for the
optimizers, ``-pthread`` for the file I/O engine) into
``build/deepspeed_tpu_torch/host/``, keyed by the source, the flags and
the host CPU (``-march=native`` code must never load on another CPU), and
loads it with ``ctypes``.  A build writes a temporary name and renames it,
so two processes building at once never load half a file.  There is no
fallback: without ``g++`` the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HOST_CSRC = CSRC / "host"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "deepspeed_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: compiler output of the last build in this process (ptxas register and
#: spill report), empty when the library was already built
build_log = ""


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from deepspeed_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdeepspeed_tpu_torch_{_digest()}.so"


def _run(cmd: List[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _compile_all(nvcc: str, tmp: Path) -> Tuple[List[Path], str]:
    """One ``nvcc -c`` per source, all started together."""
    jobs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [obj for _, obj, _ in jobs], "".join(logs)


def build() -> Path:
    """Compile the sources into the shared library (one ``nvcc`` per
    source, in parallel, then one link); a no-op when the keyed library
    exists."""
    global build_log
    target = library_path()
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, log = _compile_all(nvcc, Path(tmp))
        tmp_lib = Path(tmp) / target.name
        log += _run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
                     *map(str, objs)])
        os.replace(tmp_lib, target)  # atomic: a reader never sees half a file
    build_log = log
    return target


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Sets ``argtypes``
    (``c_void_p`` for every pointer and the stream) on each entry point."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            # decode: q, k, v, (tables,) lengths, out, partials, counters |
            # B, h, kv_h, d, Smax (paged: pages, bs, max blocks), window,
            # chunk, splits, dtype | stream
            lib.ds_decode_attention.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
            lib.ds_decode_attention.restype = i32
            lib.ds_paged_decode_attention.argtypes = ([ptr] * 8 + [i32] * 11
                                                      + [ptr])
            lib.ds_paged_decode_attention.restype = i32
            # flash attention: q, k, v, seg, out, lse | B, S, H, d, causal,
            # window, dtype | stream; the backward passes take do, lse,
            # delta before seg and one (dq) or two (dk, dv) outputs
            lib.ds_flash_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
            lib.ds_flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
            lib.ds_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
            # MoE: tokens, src_idx, out | T, rows, row bytes | stream;
            # expert_out, flat_idx, gates, y | T, K, E*C, H, dtype | stream
            lib.ds_moe_dispatch.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
            lib.ds_moe_combine.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
            # fused Adam: pointer table, chunk table, counts, scalars, the
            # hyperparameters as fp32 | stream
            f32 = ctypes.c_float
            lib.ds_multi_tensor_sqsum.argtypes = ([ptr, ptr, i32, ptr, ptr,
                                                   ptr])
            lib.ds_fused_adam.argtypes = ([ptr, i32, ptr, i32, ptr]
                                          + [f32] * 6 + [i32, ptr])
            # block-sparse attention: q, k, v (do, lse, delta), the plan's
            # ptr, idx, masks, order, the outputs | B, S, H, d, layout
            # heads, causal, mask shift, dtype | stream
            lib.ds_block_sparse_fwd.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
            lib.ds_block_sparse_bwd_dq.argtypes = ([ptr] * 11 + [i32] * 8
                                                   + [ptr])
            lib.ds_block_sparse_bwd_dkv.argtypes = ([ptr] * 12 + [i32] * 8
                                                    + [ptr])
            # quantizer: x, q, scales | rows (int64), cols, dtype, vector |
            # stream
            lib.ds_quantize_int8.argtypes = ([ptr] * 3 + [ctypes.c_int64]
                                             + [i32] * 3 + [ptr])
            for fn in (lib.ds_flash_fwd, lib.ds_flash_bwd_dq,
                       lib.ds_flash_bwd_dkv, lib.ds_block_sparse_fwd,
                       lib.ds_block_sparse_bwd_dq,
                       lib.ds_block_sparse_bwd_dkv, lib.ds_moe_dispatch,
                       lib.ds_moe_combine, lib.ds_multi_tensor_sqsum,
                       lib.ds_fused_adam, lib.ds_quantize_int8):
                fn.restype = i32
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


# -- the host (g++) sources ---------------------------------------------------

def host_cpu_key() -> str:
    """What ``-march=native`` compiles for: the machine, and the first
    processor's model name and feature flags."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    parts.append(line.strip())
                if not line.strip() and len(parts) > 1:
                    break  # the first processor's block
    except OSError:
        parts.append(platform.processor())
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:12]


class HostBuilder:
    """One C++ source of ``csrc/host/`` built with ``g++`` into a shared
    library with a plain C interface, loaded once a process."""

    FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

    def __init__(self, name: str, source: str, extra: List[str]):
        self.name, self.source, self.extra = name, HOST_CSRC / source, extra
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def flags(self) -> List[str]:
        return self.FLAGS + self.extra

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags).encode())
        h.update(self.source.read_bytes())
        h.update(host_cpu_key().encode())
        return BUILD_DIR / "host" / f"{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile unless the keyed library exists; raises without
        ``g++`` or when the compile fails."""
        target = self.library_path()
        if target.exists():
            return target
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                f"g++ not found on PATH: the host library {self.name} is "
                f"built from {self.source.relative_to(CSRC.parent)} at first "
                "use (offload and ZeRO-Infinity need it; there is no "
                "fallback)")
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=target.parent,
                                   prefix=target.stem + ".", suffix=".tmp")
        os.close(fd)
        try:
            cmd = [gxx, *self.flags, str(self.source), "-o", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, target)  # atomic: a reader never sees half
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return target

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
            return self._lib


#: the fused host optimizers (``csrc/host/cpu_adam.cpp``)
CPU_ADAM = HostBuilder("cpu_adam", "cpu_adam.cpp", ["-fopenmp"])
#: the asynchronous file I/O engine (``csrc/host/aio_engine.cpp``)
ASYNC_IO = HostBuilder("async_io", "aio_engine.cpp", ["-pthread"])
