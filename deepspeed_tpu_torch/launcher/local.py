"""Run one function in several local processes, one per rank.

Counterpart of ``deepspeed_tpu/launcher/multinode_runner.py``: its
``rank_env`` and ``LocalMultiRunner`` (N local processes with the rank
environment).  :func:`launch` starts ``world`` fresh interpreters (the
``spawn`` start method: a process that has touched CUDA must never
``fork``), gives each the rank environment and a free ``MASTER_PORT``,
runs ``fn(rank, *args)`` in each, and returns their results in rank order.

A rank's exception fails the launch with the rank's traceback, and a launch
that outlives ``timeout`` seconds fails too: either way every rank still
running is killed, so a collective that one rank never joins ends in an
error, not a hang.  A rank's standard output goes to standard error, so
the caller's standard output carries only what the caller prints.  ``fn``
must be importable by name (a module-level function), and its arguments
and result must pickle by value (numbers, strings, lists, dicts, numpy
arrays): a tensor sent back through the queue would be shared memory that
dies with its rank.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import socket
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence


def rank_env(rank: int, world: int, master_addr: str,
             master_port: int) -> Dict[str, str]:
    """The environment ``init_distributed`` reads, for one local rank."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port)}


def free_port(host: str = "127.0.0.1") -> int:
    """A port that was free a moment ago (bound to port 0, then closed)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, env: Dict[str, str],
               args: Sequence[Any], results: Any) -> None:
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    os.environ.update(env)
    try:
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world: int, args: Sequence[Any] = (),
           timeout: float = 120.0, master_addr: str = "127.0.0.1"
           ) -> List[Any]:
    """``fn(rank, *args)`` in ``world`` local processes; their results in
    rank order.  Raises when a rank fails or dies, or after ``timeout``
    seconds, having killed every rank still running."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port(master_addr)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, rank_env(rank, world, master_addr,
                                                  port), args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    done: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"launch: ranks {sorted(set(range(world)) - set(done))} "
                    f"of {world} did not finish within {timeout:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"launch: ranks exited without a "
                                       f"result (rank: exit code) {dead}")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} of {world} "
                                   f"failed:\n{payload}")
            done[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [done[r] for r in range(world)]
