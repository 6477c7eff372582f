"""Checkpoint engines: the synchronous and the decoupled (async) save of one
rank's state file, and the integrity manifest beside a checkpoint.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine.py``.  The JAX
engines write orbax trees; the card has no orbax, so the port writes one
``torch.save`` file a rank (``runtime/checkpointing.py`` owns the layout).

* :class:`TorchCheckpointEngine` copies the state to host memory and
  writes it before :meth:`~CheckpointEngine.save` returns.
* :class:`DecoupledCheckpointEngine` returns once the device-to-host
  snapshot is taken (into pinned host buffers it reuses across saves, the
  copy stream synchronised), and writes on a background thread: the next
  step may update the masters and moments in place.  At most one save is
  in flight; :meth:`~CheckpointEngine.wait` joins it, then runs its commit
  (the manifest, then ``latest``), so ``latest`` never names a torn save.

Both write every tensor from a host buffer of its own shape: a chunk that
is a view of a whole master (ZeRO stages 1-2) is written as the chunk, not
as the storage behind it.  ``ds_manifest.json`` holds each file's size and
sha256 (the JAX package writes the same sidecar); a load checks the sizes
(:func:`verify_sidecar_manifest`) and, when a file fails to load, the
hashes, and raises :class:`CheckpointCorruptionError` naming the file.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
import weakref
import zipfile
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from ..utils.logging import log_dist, logger

#: sidecar integrity manifest written next to every saved checkpoint tree
SIDECAR_MANIFEST = "ds_manifest.json"

Commit = Optional[Callable[[], None]]


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity validation (truncated, corrupt or
    missing files); the message names the first offending file."""


def _iter_payload_files(path: str) -> Iterator[Tuple[str, str]]:
    """Every regular file under ``path`` except the sidecar itself, as
    (relative name, absolute path), in a fixed order."""
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), path)
            if rel in (SIDECAR_MANIFEST, SIDECAR_MANIFEST + ".tmp"):
                continue
            yield rel, os.path.join(root, f)


def _sha256_file(p: str) -> str:
    h = hashlib.sha256()
    with open(p, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def write_sidecar_manifest(path: str) -> Dict[str, Any]:
    """Stamp ``<path>/ds_manifest.json`` with each file's size and sha256.
    Called after every file is on disk and before ``latest`` names the
    checkpoint, so a manifest implies the payload it describes was whole."""
    files = {rel: {"bytes": os.path.getsize(p), "sha256": _sha256_file(p)}
             for rel, p in _iter_payload_files(path)}
    manifest = {"version": 1, "files": files}
    tmp = os.path.join(path, SIDECAR_MANIFEST + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(tmp, os.path.join(path, SIDECAR_MANIFEST))
    return manifest


def verify_sidecar_manifest(path: str, strict: bool = False,
                            deep: Optional[bool] = None) -> bool:
    """Check ``path`` against its manifest: every listed file exists with
    its size (and, ``deep``, its sha256; default: ``strict``).  Without a
    manifest: raises when ``strict``, else True.  Raises
    :class:`CheckpointCorruptionError` naming the first mismatch."""
    deep = strict if deep is None else deep
    mp = os.path.join(path, SIDECAR_MANIFEST)
    if not os.path.isdir(path):
        raise CheckpointCorruptionError(
            f"checkpoint {path!r} does not exist or is not a directory")
    if not os.path.exists(mp):
        if strict:
            raise CheckpointCorruptionError(
                f"checkpoint {path!r} has no {SIDECAR_MANIFEST} sidecar: the "
                "save never completed")
        return True
    try:
        with open(mp) as fh:
            files = json.load(fh)["files"]
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint {path!r}: unreadable sidecar manifest "
            f"{SIDECAR_MANIFEST} ({e!r})") from e
    for rel, meta in sorted(files.items()):
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            raise CheckpointCorruptionError(
                f"checkpoint {path!r}: file {rel!r} listed in the manifest "
                "is missing (torn or partial checkpoint)")
        size = os.path.getsize(p)
        if size != int(meta["bytes"]):
            raise CheckpointCorruptionError(
                f"checkpoint {path!r}: file {rel!r} is {size} bytes, the "
                f"manifest says {meta['bytes']} (truncated write)")
        if deep and _sha256_file(p) != meta["sha256"]:
            raise CheckpointCorruptionError(
                f"checkpoint {path!r}: file {rel!r} fails its sha256 "
                "checksum (bit rot or a partial overwrite)")
    return True


@torch.no_grad()
def _map_tensors(tree: Any, fn: Callable[[Tuple[Any, ...], torch.Tensor],
                                         torch.Tensor],
                 path: Tuple[Any, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def _write(tree: Any, path: str) -> None:
    """``torch.save`` to a temporary name, then an atomic rename."""
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


class CheckpointEngine:
    """The reference's engine surface: ``save`` one state tree to a file,
    ``load`` it, ``commit`` / ``wait`` for durability."""

    def __init__(self, config_params: Any = None):
        self.config_params = config_params

    def create(self, tag: str) -> None:
        """Bookkeeping hook of the reference's surface."""

    def save(self, state_tree: Any, path: str, commit_fn: Commit = None
             ) -> None:
        """Write ``state_tree`` (tensors anywhere, plain values) to
        ``path``; ``commit_fn()`` runs once the write is durable."""
        raise NotImplementedError

    def load(self, path: str, map_location: Any = "cpu") -> Any:
        """The tree of ``path``, its tensors memory-mapped (a caller copies
        only the slices it needs).  A file that fails to load and fails
        the manifest's hashes raises :class:`CheckpointCorruptionError`."""
        try:
            return torch.load(path, map_location=map_location, mmap=True,
                              weights_only=True)
        except (RuntimeError, OSError, EOFError, zipfile.BadZipFile,
                pickle.UnpicklingError) as e:
            try:
                verify_sidecar_manifest(os.path.dirname(path), deep=True)
            except CheckpointCorruptionError as ce:
                raise CheckpointCorruptionError(
                    f"checkpoint file {path!r} failed to load "
                    f"({type(e).__name__}: {e}); integrity check agrees: "
                    f"{ce}") from e
            raise CheckpointCorruptionError(
                f"checkpoint file {path!r} failed to load "
                f"({type(e).__name__}: {e})") from e

    def commit(self, tag: str) -> bool:
        """True once the tag is durable."""
        self.wait()
        return True

    def wait(self) -> None:
        """Join an in-flight save and run its commit (nothing for a
        synchronous engine)."""


class TorchCheckpointEngine(CheckpointEngine):
    """Synchronous ``torch.save``: each tensor copied to a host tensor of
    its own shape, written, then committed."""

    def save(self, state_tree: Any, path: str, commit_fn: Commit = None
             ) -> None:
        host = _map_tensors(state_tree, lambda _, t: torch.empty(
            t.shape, dtype=t.dtype).copy_(t))
        _write(host, path)
        if commit_fn is not None:
            commit_fn()


#: in-flight async saves of every engine in the process, by absolute path:
#: a reader joins any writer of what it reads, whichever engine owns it
_inflight_lock = threading.Lock()
_inflight: Dict[str, Any] = {}  # path -> weakref to the engine


def join_inflight_save(path: str) -> None:
    """Join any engine's in-flight async save of ``path`` or of a tree
    above or below it (every load calls this before reading)."""
    path = os.path.abspath(path)
    with _inflight_lock:
        engines = set()
        for p in list(_inflight):
            if (p == path or p.startswith(path + os.sep)
                    or path.startswith(p + os.sep)):
                eng = _inflight[p]()
                if eng is None:
                    _inflight.pop(p, None)
                else:
                    engines.add(eng)
    for eng in engines:
        eng.wait()


class DecoupledCheckpointEngine(CheckpointEngine):
    """Async save: :meth:`save` returns after the device-to-host snapshot;
    a background thread writes the file; :meth:`wait` joins it, raises
    what it raised, then commits.  Every save waits for the one before."""

    def __init__(self, config_params: Any = None):
        super().__init__(config_params)
        #: host buffers by tree path, reused by the next save of that shape
        self._buffers: Dict[Tuple[Any, ...], torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[str] = None
        self._pending_commit: Commit = None

    def _buffer(self, key: Tuple[Any, ...], t: torch.Tensor) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._buffers[key] = buf
        return buf

    def snapshot(self, state_tree: Any) -> Any:
        """``state_tree`` copied into this engine's host buffers; on return
        every device-to-host copy has finished."""
        devices = set()

        def copy(key, t):
            if t.is_cuda:
                devices.add(t.device)
            return self._buffer(key, t).copy_(t, non_blocking=t.is_cuda)
        host = _map_tensors(state_tree, copy)
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        return host

    def save(self, state_tree: Any, path: str, commit_fn: Commit = None
             ) -> None:
        self.wait()
        host = self.snapshot(state_tree)
        self._pending, self._pending_commit = path, commit_fn
        self._error = None
        with _inflight_lock:
            _inflight[os.path.abspath(path)] = weakref.ref(self)
        self._thread = threading.Thread(target=self._write, args=(host, path),
                                        name="ds-checkpoint-writer")
        self._thread.start()
        log_dist(f"async checkpoint save started: {path}")

    def _write(self, host: Any, path: str) -> None:
        try:
            _write(host, path)
        except BaseException as e:  # re-raised by wait() on the caller
            self._error = e

    def load(self, path: str, map_location: Any = "cpu") -> Any:
        self.wait()
        join_inflight_save(path)
        return super().load(path, map_location)

    def wait(self) -> None:
        if self._pending is None:
            return
        self._thread.join()
        pending, commit = self._pending, self._pending_commit
        self._pending, self._pending_commit, self._thread = None, None, None
        with _inflight_lock:
            ref = _inflight.get(os.path.abspath(pending))
            if ref is not None and ref() in (self, None):
                _inflight.pop(os.path.abspath(pending), None)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save of {pending} "
                               f"failed: {err!r}") from err
        if commit is not None:
            commit()

    def __del__(self):
        thread = self._thread
        if thread is not None and thread.is_alive():
            logger.warning(f"async checkpoint {self._pending}: the engine was "
                           "dropped before wait(); joining the writer, the "
                           "checkpoint stays uncommitted")
            thread.join()


def make_checkpoint_engine(config) -> CheckpointEngine:
    """The backend ``checkpoint.checkpoint_engine.type`` names: ``sync``
    (default), ``async`` or ``decoupled`` (the same engine)."""
    ce = config.checkpoint.checkpoint_engine or {}
    kind = str(ce.get("type", "sync")).lower()
    if kind in ("async", "decoupled"):
        return DecoupledCheckpointEngine(ce)
    return TorchCheckpointEngine(ce)
