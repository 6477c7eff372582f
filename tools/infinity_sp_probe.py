#!/usr/bin/env python3
"""ZeRO-Infinity x Ulysses at Llama-3-70B widths, a card a rank.

    python3 tools/infinity_sp_probe.py [--configs 2x1,2x2] [--layers 3]
                                       [--steps 3] [--seq 8192] [--seed 0]

Each configuration ``SPxDP`` launches ``SP x DP`` ranks, each on its own
card over NCCL, that train Llama-3-70B widths at ``--layers`` of its 80
layers through ``initialize`` with ``offload_param`` (the cpu tier, the
fused path) and ``sequence_parallel.sp_size`` SP: one ``[DP, --seq]``
batch (each data coordinate's row whole on its ``seq`` ranks), bf16 on
fp32 masters, flash, ``loss_tiles`` 8, AdamW lr 1e-4, ``--steps`` steps.
It prints one JSON line a configuration: per rank the losses, grad norms,
step times on the host clock (each step ends in a synchronize) and their
split, the flash launches and all-to-alls, the peak device memory, the
host plane bytes and the bytes gathered, reduce-scattered and copied a
step; then the card's name and power limit.  It fails unless the losses
are finite and bit-equal on the ranks, the flash launches are ``2 L`` /
``L`` / ``L`` and the all-to-alls ``12 L`` a step.

Two ranks at these widths do not fit one card (each holds the
2.1 B-parameter resident subtree with its fp32 Adam state), so this probe
needs as many cards as ranks and stays out of ``chip_smoke.py``, which
runs on one.  Without enough CUDA devices it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
A2A_PER_LAYER_STEP = 12  # q, k, v, out: streamed, recomputed, backward


def probe_rank(rank: int, sp: int, dp: int, layers: int, steps: int,
               seq: int, seed: int) -> dict:
    """One rank: its card, NCCL, the streamed model and ``steps`` steps."""
    from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, comm,
                                     init_distributed, initialize)
    from deepspeed_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    init_distributed(device=dev)
    cfg = LlamaConfig.llama3_70b(num_layers=layers, dtype=torch.bfloat16,
                                 param_dtype=torch.float32,
                                 attn_impl="flash", loss_tiles=8)
    t0 = time.perf_counter()
    # drawn with the card's generator; initialize broadcasts rank 0's
    model = LlamaModel(cfg, device="cpu", seed=seed + rank, init_device=dev)
    engine, *_ = initialize(model=model, device=dev, config={
        "train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": True},
        "steps_per_print": 0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
        "sequence_parallel": {"sp_size": sp},
        "zero_optimization": {"stage": 3,
                              "offload_param": {"device": "cpu"},
                              "offload_optimizer": {"device": "cpu"}}})
    setup_s = time.perf_counter() - t0
    inf = engine.infinity
    sw = inf.swapper
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    ids = torch.randint(0, cfg.vocab_size, (dp, seq), generator=gen,
                        device=dev)
    d = comm.get_rank(engine.dp_group) if dp > 1 else 0
    rows = {"input_ids": ids[d:d + 1]}
    for name in FLASH:
        getattr(kernels, name).launches = 0
    comm.all_to_all_in_graph.calls = 0
    torch.cuda.reset_peak_memory_stats()
    out = {k: [] for k in ("loss", "grad_norm", "step_s", "split_s")}
    for _ in range(steps):
        before = dict(sw.io_bytes)
        t0 = time.perf_counter()
        m = engine.train_step(rows)
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["split_s"].append(dict(inf.last_timings))
        io = {k: sw.io_bytes[k] - before[k] for k in before}
    out.update(
        rank=rank, dp_rank=d, sp_rank=engine.sp_rank, setup_s=setup_s,
        launches={n: getattr(kernels, n).launches for n in FLASH},
        all_to_all=comm.all_to_all_in_graph.calls,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        n_elems=sw.n_elems, n_pad=sw.n_pad, n_plane=sw.n_plane,
        host_plane_bytes=sw.host_plane_bytes(),
        device_param_bytes=inf.peak_device_param_bytes(),
        resident_params=inf.resident_param_count(),
        io_bytes_per_step=io, card=torch.cuda.get_device_name(dev))
    return out


def check(ranks: list, layers: int, steps: int) -> None:
    base = ranks[0]
    for r in ranks:
        if not (all(np.isfinite(r["loss"])) and r["loss"] == base["loss"]
                and r["grad_norm"] == base["grad_norm"]):
            raise RuntimeError(f"rank {r['rank']}: losses {r['loss']} / grad "
                               f"norms {r['grad_norm']}, rank 0's "
                               f"{base['loss']} / {base['grad_norm']}")
        want = dict(flash_fwd=2 * layers * steps,
                    flash_bwd_dq=layers * steps, flash_bwd_dkv=layers * steps)
        if r["launches"] != want:
            raise RuntimeError(f"rank {r['rank']}: flash launches "
                               f"{r['launches']}, want {want}")
        if r["all_to_all"] != A2A_PER_LAYER_STEP * layers * steps:
            raise RuntimeError(f"rank {r['rank']}: {r['all_to_all']} "
                               "all-to-alls")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="2x1,2x2",
                    help="comma-separated SPxDP configurations")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    configs = [tuple(int(x) for x in c.split("x"))
               for c in args.configs.split(",")]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = max(sp * dp for sp, dp in configs)
    if cards < need:
        print(f"infinity_sp_probe: {need} CUDA devices needed, {cards} "
              "visible", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build()  # here, so the ranks do not each run nvcc
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    for sp, dp in configs:
        t0 = time.perf_counter()
        ranks = launch(probe_rank, sp * dp, (sp, dp, args.layers,
                                             args.steps, args.seq,
                                             args.seed), timeout=1200)
        wall = time.perf_counter() - t0
        check(ranks, args.layers, args.steps)
        print(json.dumps({
            "probe": "infinity_sp", "model": "llama3_70b", "sp": sp,
            "dp": dp, "layers": args.layers, "steps": args.steps,
            "batch": [dp, args.seq], "tokens_per_rank": args.seq // sp,
            "dtype": "bfloat16", "tier": "cpu", "comm": "nccl",
            "reduced": [f"num_layers 80 -> {args.layers}"],
            "step_s_median": statistics.median(
                ranks[0]["step_s"][1:] or ranks[0]["step_s"]),
            "launch_wall_s": wall, "ranks": ranks, "card": card}),
            flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
