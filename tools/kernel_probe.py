#!/usr/bin/env python3
"""Checks and times the port's flash-attention, block-sparse attention and
MoE dispatch kernels on one NVIDIA GPU, at ``chip_smoke.py``'s timed
shapes, for one tree of the port.

    python3 tools/kernel_probe.py [--root DIR]

``--root`` takes the ``deepspeed_tpu_torch`` package (and builds its
kernels under ``DIR/build``) from another checkout of the repo, such as an
earlier commit unpacked with ``git archive``: run the probe once per tree in
one session on the card, in turns (parent, change, change, parent), to
compare two versions of the kernels with the same inputs and the same timer.

Shapes (bf16, from ``chip_smoke.py``): flash at bench.py's headline (B 8,
S 2048, h 12, d 64, causal); block-sparse at the training shape (B 2, S
4096, h 16, d 64, BigBird cells of 128, causal); dispatch at the train
shape (T 2048, E 8, C 1024, H 4096, top-2).  Each kernel is held against
its plain version (within 2e-2 relative to 1 + |plain|; dispatch exactly),
then timed with ``chip_smoke.py``'s ``time_ms`` (median and range over 7
reps of 30 calls queued behind a GPU sleep, rotating over three input sets)
beside its bound and, for dispatch, ``index_select`` on the zero-row-padded
tokens.  Prints the card's name and power limit, then one JSON line per
kernel.  Exits 1 on a failed check or without a CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def load_smoke():
    """``chip_smoke.py`` of this checkout, for its inputs, timer and
    bounds (whatever tree ``--root`` names)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def flash_rows(smoke, k, gen, dev, cycles):
    """The three flash kernels at the headline shape."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import \
        attention_delta
    from deepspeed_tpu_torch.ops.kernels.lattice import live_pairs
    case = next(c for c in smoke.FLASH_CASES if c[0] == "headline")
    _, B, h, d, S, causal, _, _ = case
    sets = []
    for _ in range(3):
        q, kk, v, do, _ = smoke.flash_inputs(case, torch.bfloat16, gen, dev)
        out, lse = k.flash_attention_fwd_plain(q, kk, v, causal)
        sets.append((q, kk, v, do, out, lse, attention_delta(out, do)))
    q, kk, v, do, out, lse, delta = sets[0]
    want = k.flash_attention_bwd_plain(q, kk, v, out, lse, do, causal)
    got_out, got_lse = k.flash_fwd(q, kk, v, causal)
    checks = {
        "flash_fwd": ((got_out, out), (got_lse, lse)),
        "flash_bwd_dq": ((k.flash_bwd_dq(q, kk, v, out, lse, do, causal),
                          want[0]),),
        "flash_bwd_dkv": tuple(zip(k.flash_bwd_dkv(q, kk, v, out, lse, do,
                                                   causal), want[1:]))}
    runs = {"flash_fwd": lambda s: k.flash_fwd(s[0], s[1], s[2], causal),
            "flash_bwd_dq": lambda s: k.flash_bwd_dq(
                s[0], s[1], s[2], s[4], s[5], s[3], causal, delta=s[6]),
            "flash_bwd_dkv": lambda s: k.flash_bwd_dkv(
                s[0], s[1], s[2], s[4], s[5], s[3], causal, delta=s[6])}
    bounds = smoke.attention_bounds(B, S, h, d, 2,
                                    h * live_pairs(S, causal, None) * B)
    shape = dict(B=B, S=S, h=h, d=d, causal=causal)
    for name, fn in runs.items():
        err = max(smoke.check_close(name, g, w, torch.bfloat16)
                  for g, w in checks[name])
        yield dict(kernel=name, shape=shape, max_abs_err=err,
                   **smoke.time_ms([lambda s=s: fn(s) for s in sets],
                                   cycles),
                   bound_ms=bounds[name][0], bound_by=bounds[name][1])


def sparse_rows(smoke, k, gen, dev, cycles):
    """The three block-sparse kernels at the training shape."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import \
        attention_delta
    name, B, S, h, d, family, kw, causal = next(
        c for c in smoke.SPARSE_CHECKS if c[0] == smoke.SPARSE_TIMED)
    cfg = smoke.sparse_config(family, h, **kw)
    layout, plan = smoke.sparse_plan(cfg, S, h, causal)
    cb = cfg.block
    sets = []
    for _ in range(3):
        q, kk, v, do = smoke.sparse_inputs(B, S, h, d, torch.bfloat16, gen,
                                           dev)
        out, lse = k.block_sparse_fwd_plain(q, kk, v, layout, cb, causal)
        sets.append((q, kk, v, do, out, lse, attention_delta(out, do)))
    q, kk, v, do, out, lse, delta = sets[0]
    want = k.block_sparse_bwd_plain(q, kk, v, out, lse, do, layout, cb,
                                    causal)
    got_out, got_lse = k.block_sparse_fwd(q, kk, v, plan)
    checks = {
        "block_sparse_fwd": ((got_out, out), (got_lse, lse)),
        "block_sparse_bwd_dq": ((k.block_sparse_bwd_dq(q, kk, v, out, lse,
                                                       do, plan), want[0]),),
        "block_sparse_bwd_dkv": tuple(zip(k.block_sparse_bwd_dkv(
            q, kk, v, out, lse, do, plan), want[1:]))}
    runs = {"block_sparse_fwd": lambda s: k.block_sparse_fwd(s[0], s[1],
                                                             s[2], plan),
            "block_sparse_bwd_dq": lambda s: k.block_sparse_bwd_dq(
                s[0], s[1], s[2], s[4], s[5], s[3], plan, s[6]),
            "block_sparse_bwd_dkv": lambda s: k.block_sparse_bwd_dkv(
                s[0], s[1], s[2], s[4], s[5], s[3], plan, s[6])}
    bounds = smoke.attention_bounds(
        B, S, h, d, 2, smoke.sparse_pairs(plan, B, h), tuple(runs),
        (smoke.plan_bytes(plan), smoke.plan_bytes(plan),
         smoke.plan_bytes(plan, True)))
    shape = dict(B=B, S=S, h=h, d=d, family=family, config=kw,
                 causal=causal, **smoke.walk_lengths(plan))
    for kernel, fn in runs.items():
        err = max(smoke.check_close(kernel, g, w, torch.bfloat16)
                  for g, w in checks[kernel])
        yield dict(kernel=kernel, shape=shape, max_abs_err=err,
                   **smoke.time_ms([lambda s=s: fn(s) for s in sets],
                                   cycles),
                   bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1])


def dispatch_rows(smoke, k, gen, dev, cycles):
    """The dispatch kernel at the train shape, beside ``index_select``."""
    case, T, C = smoke.MOE_CASES[0]
    sets = []
    for _ in range(3):
        tokens, _, src, flat, _ = smoke.moe_inputs(T, C, torch.bfloat16,
                                                   gen, dev)
        padded = torch.cat([tokens, tokens.new_zeros(1, smoke.MOE_H)])
        rows = torch.where(src >= 0, src, T).reshape(-1).long()
        sets.append((tokens, src, padded, rows, flat))
    tokens, src, _, _, flat = sets[0]
    smoke.require(torch.equal(k.moe_dispatch_fwd(tokens, src),
                              k.dispatch_reference(tokens, src)),
                  "moe_dispatch: not equal to the plain version")
    bound, by = smoke.moe_bounds(tokens, src, flat)["moe_dispatch"]
    yield dict(kernel="moe_dispatch",
               shape=dict(T=T, E=smoke.MOE_E, C=C, H=smoke.MOE_H),
               max_abs_err=0.0,
               **smoke.time_ms([lambda s=s: k.moe_dispatch_fwd(s[0], s[1])
                                for s in sets], cycles),
               bound_ms=bound, bound_by=by,
               index_select=smoke.time_ms(
                   [lambda s=s: torch.index_select(s[2], 0, s[3])
                    for s in sets], cycles))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="checkout whose deepspeed_tpu_torch is timed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels, op_builder
    package = Path(deepspeed_tpu_torch.__file__).resolve()
    if root not in package.parents:
        print(f"kernel_probe: imported {package}, not from {root}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    op_builder.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(97531)
    cycles = smoke.sleep_cycles_per_ms()
    try:
        for rows in (flash_rows, sparse_rows, dispatch_rows):
            for row in rows(smoke, kernels, gen, dev, cycles):
                print(json.dumps(dict(tree=str(root), **row)), flush=True)
            torch.cuda.empty_cache()
    except RuntimeError as exc:
        print(f"kernel_probe: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
