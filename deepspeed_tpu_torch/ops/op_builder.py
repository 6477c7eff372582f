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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
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
            lib.ds_decode_attention.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
            lib.ds_decode_attention.restype = i32
            lib.ds_paged_decode_attention.argtypes = ([ptr] * 6 + [i32] * 9
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
            for fn in (lib.ds_flash_fwd, lib.ds_flash_bwd_dq,
                       lib.ds_flash_bwd_dkv, lib.ds_moe_dispatch,
                       lib.ds_moe_combine, lib.ds_multi_tensor_sqsum,
                       lib.ds_fused_adam):
                fn.restype = i32
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
