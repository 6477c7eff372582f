#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:

1. ``build``    — nvcc builds the kernels from ``deepspeed_tpu_torch/csrc``.
2. ``kernels``  — one line per decode kernel: the kernel against its plain
   version at every shape the main path gives it (32/8 heads, d 128, pages
   of 16; B 8 over up to 2048 keys with ragged lengths and window None and
   512, as served; B 4 over generate's 256 + 32 keys), bf16 and fp32; then
   timed with CUDA events (calls queued back to back behind a GPU sleep so
   the host's overhead is hidden, median and range over 7 reps, inputs
   rotated over more than the 50 MB L2) beside its plain version, a PyTorch
   library yardstick and its bound (K/V bytes over 3.35 TB/s).
3. ``kernels``  — one line per flash kernel (forward, dq pass, dk/dv pass):
   against its plain version at every ``FLASH_CASES`` shape, bf16 and fp32,
   then timed the same way at the two training shapes beside its plain
   version, SDPA and its bound (causal flops over 989 TFLOP/s in bf16).
4. ``serve``    — Llama-3-8B at full width and depth (bf16, random weights
   from a seed) behind ``build_serving_frontend``: 8 requests of mixed
   classes, two sharing a 512-token header.  Every handle must return its
   budget, the prefix cache must hit, and the paged kernel must launch
   ``num_layers`` times per decode step.
5. ``generate`` — ``init_inference(...).generate`` on the same weights,
   ``[4, 256]`` prompts, 32 new tokens: ``32 x 31`` decode-kernel launches.
6. ``agree``    — a narrow fp32 model: v2 greedy tokens equal v1 greedy
   tokens (both through the kernels) and the CPU plain path's tokens.
7. ``train``    — ``initialize`` + 12 ``train_step``s of bench.py's
   headline (12 x 768, 12/12 heads, V 32000, bf16 on fp32 masters, AdamW
   lr 1e-4, ZeRO 0, remat, flash attention) on a repeated ``[8, 2048]``
   batch of random ids: a finite, falling loss, the flash launches of the
   formula (forward 2 L per step under remat, each backward pass L), the
   median step time of CUDA events after the first, tokens/s, MFU (6N +
   12 L S H flops per token over 989 TFLOP/s) and peak memory.
8. ``train_8b_width`` — the same at Llama-3-8B widths, 4 of its 32 layers
   (fp32 masters, grads and Adam moments of all 32 would need ~128 GB),
   ``[1, 2048]``, 5 steps.
9. ``train_agree`` — a narrow fp32 GQA model: five steps through the
   kernels give the CPU plain path's loss and grad-norm sequences to 1e-4.

Then a ``kernels`` line (every kernel's launches on the main paths: the
decode kernels' from ``serve`` and ``generate``, the flash kernels' from
``train``; times at the main paths' shapes), the card's name and power
limit, and the result line.  TF32 is off for matmuls and cuDNN.  Length 0
is not tested: the TPU kernel gives 0 there and its reference the mean of
V; the engines never pass it (an idle slot attends one key on scratch page
0).
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SLICE = dict(B=8, h=32, kv_h=8, d=128, bs=16, smax=2048)
LENGTHS = [1, 15, 16, 17, 1000, 2048, 640, 1999]
V1_BATCH, V1_PROMPT, V1_NEW = 4, 256, 32
#: (name, lengths, Smax, windows): every shape the main path gives the
#: kernels.  "slice": B 8 over 2048 keys; its pool of 8 x 128 + 1 = 1025
#: pages and [8, 128] tables are the serve phase's.  "v1": generate's
#: padded cache of 256 + 32 keys, at the lengths its decode steps pass.
CHECKS = [("slice", LENGTHS, SLICE["smax"], (None, 512)),
          ("v1", [V1_PROMPT + 1, V1_PROMPT + 14, V1_PROMPT + V1_NEW - 1,
                  V1_PROMPT + V1_NEW], V1_PROMPT + V1_NEW, (None,))]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


# -- phase 1 ---------------------------------------------------------------

def phase_build() -> dict:
    from deepspeed_tpu_torch.ops import op_builder

    t0 = time.perf_counter()
    path = op_builder.build()
    op_builder.load_library()
    # ptxas -v reports each instance: "Compiling entry function '<name>'",
    # then its spill stores and its registers; kept per kernel family
    families, fam, compiled = {}, None, 0
    for line in op_builder.build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            compiled += 1
            name = re.search(r"(gqa_decode|flash_fwd|flash_bwd_dq|"
                             r"flash_bwd_dkv)_kernel", entry.group(1))
            fam = name.group(1) if name else entry.group(1)
            families.setdefault(fam, [0, 0])
        for i, pattern in enumerate((r"Used (\d+) registers",
                                     r"(\d+) bytes spill stores")):
            found = re.search(pattern, line)
            if found and fam is not None:
                families[fam][i] = max(families[fam][i], int(found.group(1)))
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "library": path.name, "kernels_compiled": compiled,
            "max_registers": {f: r for f, (r, _) in families.items()},
            "max_spill_bytes": {f: sp for f, (_, sp) in families.items()}}


# -- phase 2 ---------------------------------------------------------------

def make_inputs(dtype, lengths, smax, gen, dev):
    """q; a padded cache of ``smax`` keys; a pool holding the same keys
    behind a shuffled block table; one sequence per entry of ``lengths``."""
    h, kv_h, d, bs = (SLICE[k] for k in ("h", "kv_h", "d", "bs"))
    B, mb = len(lengths), smax // bs
    q = torch.randn(B, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, smax, kv_h, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, smax, kv_h, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(B * mb, generator=gen, device=dev) + 1
    tables = perm.reshape(B, mb).to(torch.int32)
    k_pool = torch.zeros(B * mb + 1, bs, kv_h, d, dtype=dtype, device=dev)
    v_pool = torch.zeros_like(k_pool)
    k_pool[perm] = k.reshape(B * mb, bs, kv_h, d)
    v_pool[perm] = v.reshape(B * mb, bs, kv_h, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, k_pool, v_pool, tables, lens


def event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def sleep_cycles_per_ms() -> float:
    """Rate of ``torch.cuda._sleep``, to size the sleeps of :func:`time_ms`."""
    a, b = event_pair()
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 1e7 / a.elapsed_time(b)


def time_ms(calls, cycles_per_ms: float, reps: int = 7,
            per_rep: int = 30) -> dict:
    """Device time of one call.  Each rep queues ``per_rep`` calls back to
    back behind a GPU sleep that outlasts the host's enqueueing, so the card
    runs them without gaps and the host's per-call overhead is not measured;
    one event pair times the lot.  The calls rotate over ``calls`` (each on
    its own inputs, so a call finds its K/V cold).  Median and range of the
    per-call time over ``reps``; ``host_hidden`` says every sleep outlasted
    its enqueueing."""
    def enqueue() -> float:
        t0 = time.perf_counter()
        for i in range(per_rep):
            calls[i % len(calls)]()
        return (time.perf_counter() - t0) * 1e3

    enqueue()
    torch.cuda.synchronize()
    sleep_ms = 3 * enqueue() + 2.0
    torch.cuda.synchronize()
    per_call, hidden = [], True
    for _ in range(reps):
        a, b = event_pair()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        a.record()
        hidden &= enqueue() < sleep_ms
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / per_rep)
    return {"ms": statistics.median(per_call), "min_ms": min(per_call),
            "max_ms": max(per_call), "reps": reps, "calls_per_rep": per_rep,
            "host_hidden": hidden}


def decode_bound_ms(q, lens, kv_h, smax, with_tables: bool) -> tuple:
    """Least time for one call without a window: bytes (q, out, live K and
    V, lengths and tables read once) over the memory rate, against 4*d flops
    per (query head, live key) over the peak rate of the inputs' type."""
    B, h, d = q.shape
    el = q.element_size()
    live_keys = int(lens.long().clamp(min=0, max=smax).sum())
    nbytes = (2 * q.numel() * el + 2 * live_keys * kv_h * d * el
              + lens.numel() * 4)
    if with_tables:
        nbytes += B * (smax // SLICE["bs"]) * 4
    flops = 4 * d * h * live_keys
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernels(dev) -> dict:
    """One dict per kernel: its errors against its plain version, its
    times, its bound, and the launches this phase made."""
    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 decode_attention_plain,
                                                 paged_decode_attention,
                                                 paged_decode_attention_plain)

    reset_launches(decode_attention, paged_decode_attention)
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {"decode_attention": {}, "paged_decode_attention": {}}
    for (case, lengths, smax, windows), dtype in itertools.product(
            CHECKS, (torch.bfloat16, torch.float32)):
        q, k, v, kp, vp, tables, lens = make_inputs(dtype, lengths, smax,
                                                    gen, dev)
        for window in windows:
            pairs = {
                "decode_attention": (
                    decode_attention(q, k, v, lens, window=window),
                    decode_attention_plain(q, k, v, lens, window)),
                "paged_decode_attention": (
                    paged_decode_attention(q, kp, vp, tables, lens,
                                           window=window),
                    paged_decode_attention_plain(q, kp, vp, tables, lens,
                                                 window))}
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                require(got.dtype == dtype and got.shape == want.shape,
                        f"{name}: wrong dtype/shape")
                err = (got.float() - want.float()).abs()
                tol = TOL[dtype] * (1 + want.float().abs())
                require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                require(bool((err <= tol).all()),
                        f"{name} {case} {dtype} window={window}: max error "
                        f"{err.max().item()} over tolerance {TOL[dtype]}")
                key = f"{case}_{str(dtype).split('.')[-1]}_w{window}"
                errs[name][key] = err.max().item()

    # timing: bf16, every sequence at the full 2048 context, no window;
    # three input sets (3 x 67 MB of K/V) so no call finds its K/V in L2
    sets = [make_inputs(torch.bfloat16, [SLICE["smax"]] * SLICE["B"],
                        SLICE["smax"], gen, dev) for _ in range(3)]
    q0, k0, v0, *_, l0 = sets[0]
    cycles = sleep_cycles_per_ms()
    mask = torch.ones(SLICE["B"], 1, 1, SLICE["smax"], dtype=torch.bool,
                      device=dev)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0, :]

    lib_err = (sdpa(q0, k0, v0).float()
               - decode_attention_plain(q0, k0, v0, l0).float()).abs().max()
    def timed(fn, **extra) -> dict:
        """``fn(q, k, v, k_pool, v_pool, tables, lengths)`` timed over the
        input sets."""
        t = time_ms([lambda s=s: fn(*s) for s in sets], cycles)
        return dict(t, **extra)

    timing = {
        "decode_attention": dict(
            kernel_time=timed(lambda q, k, v, kp, vp, t, n:
                              decode_attention(q, k, v, n)),
            plain_time=timed(lambda q, k, v, kp, vp, t, n:
                             decode_attention_plain(q, k, v, n)),
            library_time=timed(lambda q, k, v, kp, vp, t, n: sdpa(q, k, v),
                               call="F.scaled_dot_product_attention("
                                    "enable_gqa=True, bool mask)",
                               max_abs_err_vs_plain=lib_err.item())),
        "paged_decode_attention": dict(
            kernel_time=timed(lambda q, k, v, kp, vp, t, n:
                              paged_decode_attention(q, kp, vp, t, n)),
            plain_time=timed(lambda q, k, v, kp, vp, t, n:
                             paged_decode_attention_plain(q, kp, vp, t, n)),
            library_time=None,
            library_call="none: no single PyTorch call attends through a "
                         "block table"),
    }
    launches = {"decode_attention": decode_attention.launches,
                "paged_decode_attention": paged_decode_attention.launches}
    for name, with_tables in (("decode_attention", False),
                              ("paged_decode_attention", True)):
        bound, by = decode_bound_ms(q0, l0, SLICE["kv_h"], SLICE["smax"],
                                    with_tables)
        timing[name].update(
            bound_ms=bound, bound_by=by, launches_this_phase=launches[name],
            max_abs_err=max(errs[name].values()),
            max_abs_err_by_case=errs[name],
            checked_at={case: dict(B=len(lengths), smax=smax,
                                   lengths=lengths, windows=list(windows))
                        for case, lengths, smax, windows in CHECKS},
            heads=dict(h=SLICE["h"], kv_h=SLICE["kv_h"], d=SLICE["d"],
                       bs=SLICE["bs"]),
            tolerance={"float32": TOL[torch.float32],
                       "bfloat16": TOL[torch.bfloat16]},
            timed_at="bf16, B 8, every length 2048, no window",
            tf32=torch.backends.cuda.matmul.allow_tf32)
    return timing


# -- phase 3 ---------------------------------------------------------------

#: (case, B, h, d, S, causal, window, segments): every shape the training
#: phases give the flash kernels (``headline``: bench.py's model, ``8b``:
#: Llama-3-8B widths), and the masks and lengths the kernels promise besides:
#: a window with packed segments, an S that is not a multiple of the 64-row
#: tile, and an S at which the TPU package streamed (S * d > 2M elements)
FLASH_CASES = [("headline", 8, 12, 64, 2048, True, None, False),
               ("8b", 1, 32, 128, 2048, True, None, False),
               ("window_segments", 2, 8, 128, 2048, True, 512, True),
               ("ragged", 2, 4, 64, 1000, True, None, False),
               ("long", 1, 2, 128, 20480, True, None, False)]
FLASH_TIMED = ("headline", "8b")  # bf16, the training phases' shapes
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def flash_inputs(case, dtype, gen, dev):
    """q, k, v, do ``[B, S, h, d]`` and int32 segment ids (three packed
    sequences per row, cut at random points) or None."""
    _, B, h, d, S, _, _, with_seg = case
    q, k, v, do = (torch.randn(B, S, h, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    seg = None
    if with_seg:
        cuts = torch.randint(1, S, (B, 2), generator=gen, device=dev)
        pos = torch.arange(S, device=dev)
        seg = (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(
            torch.int32).contiguous()
    return q, k, v, do, seg


def flash_bound_ms(case, el: int, pairs: int) -> dict:
    """Least time per kernel for one call: ``pairs`` live (q, k) pairs (all
    heads and rows, counted from this run's mask) times the kernel's flops
    per pair (forward 4d: q·k and p·V; dq pass 6d: q·k, do·V, ds·K; dk/dv
    pass 8d: q·k, do·V, pᵀ·do, dsᵀ·q) over the peak rate of the inputs'
    type, against the bytes it must move (each input read once, each output
    written once, lse and delta fp32) over the memory rate."""
    _, B, h, d, S, _, _, _ = case
    n = B * S * h * d * el              # one [B, S, h, d] tensor
    stats = B * h * S * 4               # one fp32 [B, h, S] row statistic
    work = {"flash_fwd": (4 * d, 4 * n + stats),
            "flash_bwd_dq": (6 * d, 5 * n + 2 * stats),
            "flash_bwd_dkv": (8 * d, 6 * n + 2 * stats)}
    peak = PEAK_FLOPS[torch.bfloat16 if el == 2 else torch.float32]
    out = {}
    for name, (flops_per_pair, nbytes) in work.items():
        t_ops = flops_per_pair * pairs / peak * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_flash_kernels(dev) -> dict:
    """The three flash kernels against their plain versions at every
    ``FLASH_CASES`` shape, bf16 and fp32 (the backward passes start from the
    plain forward's out and lse, so each kernel is held alone); then timed
    at the training shapes beside the plain versions, SDPA and the bound."""
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain,
                                                 flash_bwd_dkv, flash_bwd_dq,
                                                 flash_fwd)
    from deepspeed_tpu_torch.ops.kernels.flash_attention import \
        attention_delta
    from deepspeed_tpu_torch.ops.kernels.lattice import live_pairs

    gen = torch.Generator(device=dev).manual_seed(4321)
    errs = {name: {} for name in FLASH_KERNELS}
    for case, dtype in itertools.product(FLASH_CASES,
                                         (torch.bfloat16, torch.float32)):
        name, _, _, _, _, causal, window, _ = case
        q, k, v, do, seg = flash_inputs(case, dtype, gen, dev)
        out, lse = flash_fwd(q, k, v, causal, window, seg)
        want_out, want_lse = flash_attention_fwd_plain(q, k, v, causal,
                                                       window, seg)
        dq = flash_bwd_dq(q, k, v, want_out, want_lse, do, causal, window,
                          seg)
        dk, dv = flash_bwd_dkv(q, k, v, want_out, want_lse, do, causal,
                               window, seg)
        want = flash_attention_bwd_plain(q, k, v, want_out, want_lse, do,
                                         causal, window, seg)
        torch.cuda.synchronize()
        pairs = {"flash_fwd": ((out, want_out), (lse, want_lse)),
                 "flash_bwd_dq": ((dq, want[0]),),
                 "flash_bwd_dkv": ((dk, want[1]), (dv, want[2]))}
        key = f"{name}_{str(dtype).split('.')[-1]}"
        for kernel, outputs in pairs.items():
            worst = 0.0
            for got, ref in outputs:
                require(got.shape == ref.shape and got.dtype == ref.dtype,
                        f"{kernel} {key}: wrong dtype/shape")
                require(bool(torch.isfinite(got).all()),
                        f"{kernel} {key}: non-finite")
                err = (got.float() - ref.float()).abs()
                tol = TOL[dtype] * (1 + ref.float().abs())
                require(bool((err <= tol).all()),
                        f"{kernel} {key}: max error {err.max().item()} over "
                        f"tolerance {TOL[dtype]} x (1 + |plain|)")
                worst = max(worst, err.max().item())
            errs[kernel][key] = worst
        del q, k, v, do, out, lse, want_out, want_lse, dq, dk, dv, want
        torch.cuda.empty_cache()

    cycles = sleep_cycles_per_ms()
    timing = {name: {} for name in FLASH_KERNELS}
    for case in (c for c in FLASH_CASES if c[0] in FLASH_TIMED):
        name, B, h, d, S, causal, window, _ = case
        sets = []
        for _ in range(3):
            q, k, v, do, _ = flash_inputs(case, torch.bfloat16, gen, dev)
            out, lse = flash_attention_fwd_plain(q, k, v, causal, window)
            sets.append((q, k, v, do, out, lse, attention_delta(out, do)))

        def sdpa_fwd(q, k, v, *_):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)

        graphs = []
        for q, k, v, do, *_ in sets:
            leaves = [t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v)]
            graphs.append((leaves, F.scaled_dot_product_attention(
                *leaves, is_causal=True), do.transpose(1, 2)))

        def sdpa_bwd(i):
            leaves, o, g = graphs[i]
            return torch.autograd.grad(o, leaves, g, retain_graph=True)

        lib_err = (sdpa_fwd(*sets[0]).transpose(1, 2).float()
                   - sets[0][4].float()).abs().max().item()
        run = {
            "flash_fwd": (lambda q, k, v, do, o, l, dl:
                          flash_fwd(q, k, v, causal),
                          lambda q, k, v, do, o, l, dl:
                          flash_attention_fwd_plain(q, k, v, causal)),
            "flash_bwd_dq": (lambda q, k, v, do, o, l, dl:
                             flash_bwd_dq(q, k, v, o, l, do, causal,
                                          delta=dl),
                             lambda q, k, v, do, o, l, dl:
                             flash_attention_bwd_plain(q, k, v, o, l, do,
                                                       causal)),
            "flash_bwd_dkv": (lambda q, k, v, do, o, l, dl:
                              flash_bwd_dkv(q, k, v, o, l, do, causal,
                                            delta=dl),
                              lambda q, k, v, do, o, l, dl:
                              flash_attention_bwd_plain(q, k, v, o, l, do,
                                                        causal))}
        bounds = flash_bound_ms(case, 2, h * live_pairs(S, causal, window)
                                * B)
        for kernel, (fn, plain) in run.items():
            library = (sdpa_fwd if kernel == "flash_fwd" else None)
            timing[kernel][name] = dict(
                kernel_time=time_ms([lambda s=s: fn(*s) for s in sets],
                                    cycles),
                plain_time=time_ms([lambda s=s: plain(*s) for s in sets],
                                   cycles),
                library_time=time_ms(
                    [lambda s=s: sdpa_fwd(*s) for s in sets] if library
                    else [lambda i=i: sdpa_bwd(i) for i in range(3)],
                    cycles),
                library_call=("F.scaled_dot_product_attention(is_causal="
                              "True)" if library else
                              "torch.autograd.grad of F.scaled_dot_product_"
                              "attention(is_causal=True): dq, dk and dv in "
                              "one backward"),
                library_max_abs_err_vs_plain=lib_err,
                bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1],
                shape=dict(B=B, h=h, d=d, S=S, causal=causal),
                dtype="bfloat16")
        del sets, graphs
        torch.cuda.empty_cache()
    return {kernel: dict(
        max_abs_err=max(errs[kernel].values()),
        max_abs_err_by_case=errs[kernel],
        checked_at={c[0]: dict(zip(("B", "h", "d", "S", "causal", "window",
                                    "segments"), c[1:]))
                    for c in FLASH_CASES},
        tolerance={"float32": TOL[torch.float32],
                   "bfloat16": TOL[torch.bfloat16]},
        timed=timing[kernel], tf32=torch.backends.cuda.matmul.allow_tf32)
        for kernel in FLASH_KERNELS}


# -- phase 4 ---------------------------------------------------------------

SERVE_REQUESTS = [  # (prompt length, max_new_tokens, class); the first two
    (712, 48, "interactive"),   # start with the shared 512-token header
    (812, 40, "batch"),
    (64, 64, "interactive"),
    (1500, 32, "background"),
    (900, 56, "batch"),
    (256, 40, "background"),
    (1200, 36, "interactive"),
    (128, 60, "background"),
]


def serve(model, rng, *, cache_config, header_len, requests, **engine) -> dict:
    """Serve ``requests`` through ``build_serving_frontend``; the first two
    share a ``header_len`` header, and the second is submitted once the
    first's prefill is done so the prefix cache can hit."""
    from deepspeed_tpu_torch import build_serving_frontend
    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 paged_decode_attention)

    V = model.config.vocab_size
    header = rng.integers(0, V, header_len).tolist()
    prompts = []
    for i, (n, _, _) in enumerate(requests):
        body = rng.integers(0, V, n - (header_len if i < 2 else 0)).tolist()
        prompts.append((header if i < 2 else []) + body)
    fe = build_serving_frontend(model, cache_config=cache_config,
                                device=model.device, **engine)
    eng = fe.router.replicas[0].engine
    reset_launches(decode_attention, paged_decode_attention)
    t0 = time.perf_counter()
    handles = {0: fe.submit(prompts[0], requests[0][1], requests[0][2])}
    for i in range(2, len(requests)):
        handles[i] = fe.submit(prompts[i], requests[i][1], requests[i][2])
    first = handles[0]
    while first.request is None or first.request.prefilled < len(prompts[0]):
        fe.pump()
    handles[1] = fe.submit(prompts[1], requests[1][1], requests[1][2])
    fe.run_until_idle()  # every engine step ends in a device-to-host copy
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "decode_attention": decode_attention.launches}
    results = {i: h.result() for i, h in handles.items()}
    for i, (n, budget, _) in enumerate(requests):
        require(len(results[i]) == budget,
                f"serve: request {i} returned {len(results[i])} of "
                f"{budget} tokens")
        require(all(0 <= t < V for t in results[i]),
                f"serve: request {i} produced ids outside the vocabulary")
    hit = fe.prefix_hit_rate()
    require(hit > 0, "serve: the shared header never hit the prefix cache")
    st = eng.stats
    ttft = sorted(h.ttft_ms for h in handles.values())
    generated = sum(len(r) for r in results.values())
    return {"wall_s": wall, "requests": len(requests),
            "prompt_tokens_prefilled": st["prefill_tokens"],
            "generated_tokens": generated,
            "prefix_hit_rate": hit,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "decode_steps": st["decode_steps"],
            "decode_bursts": st["decode_bursts"],
            "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
            "prefill_calls": st["prefill_calls"],
            "prefill_call_ms": st["prefill_s"] / st["prefill_calls"] * 1e3,
            "decode_tokens_per_s": st["decode_tokens"] / st["decode_s"],
            "prefill_tokens_per_s": st["prefill_tokens"] / st["prefill_s"],
            "total_tokens_per_s": (st["prefill_tokens"] + generated) / wall,
            "launches": launches}


# -- phase 5 ---------------------------------------------------------------

def generate_v1(model, ids: torch.Tensor, n_new: int) -> dict:
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 paged_decode_attention)

    eng = init_inference(model, device=model.device)
    reset_launches(decode_attention, paged_decode_attention)
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=n_new)
    out_host = out.cpu()
    wall = time.perf_counter() - t0
    B, S = ids.shape
    require(tuple(out_host.shape) == (B, S + n_new), "generate: wrong shape")
    require(torch.equal(out_host[:, :S], ids.cpu()),
            "generate: the prompt was not kept")
    require(bool(((out_host >= 0) & (out_host < model.config.vocab_size))
                 .all()), "generate: ids outside the vocabulary")
    return {"wall_s": wall, "batch": B, "prompt_len": S, "new_tokens": n_new,
            "tokens_per_s": B * n_new / wall,
            "launches": {"decode_attention": decode_attention.launches,
                         "paged_decode_attention":
                             paged_decode_attention.launches}}


# -- phase 6 ---------------------------------------------------------------

def agree(dev, seed: int) -> dict:
    """v2 greedy == v1 greedy (both through the kernels on ``dev``) == the
    CPU plain path's v1 greedy, on a narrow fp32 model, with and without a
    sliding window."""
    from deepspeed_tpu_torch import (KVCacheConfig, LlamaConfig, LlamaModel,
                                     build_engine_v2, init_inference)
    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 paged_decode_attention)

    rng = np.random.default_rng(seed + 1)
    out = {}
    for window in (None, 48):
        cfg = LlamaConfig(vocab_size=32000, hidden_size=512,
                          intermediate_size=1408, num_layers=4, num_heads=8,
                          num_kv_heads=2, max_seq_len=512,
                          sliding_window=window, dtype=torch.float32)
        model = LlamaModel(cfg, device=dev, seed=seed + 2)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (5, 37, 100, 260)]
        n_new = 16
        reset_launches(decode_attention, paged_decode_attention)
        v2 = build_engine_v2(model, cache_config=KVCacheConfig(
            num_blocks=128, block_size=16, max_seq_len=512),
            max_batch_slots=4, prefill_chunk=64, decode_burst=8,
            device=dev).generate(prompts, max_new_tokens=n_new)
        v1 = init_inference(model, device=dev)
        cpu_model = LlamaModel(cfg, device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        v1_cpu = init_inference(cpu_model, device="cpu")
        for p, got in zip(prompts, v2):
            want = v1.generate([p], max_new_tokens=n_new)[0, len(p):].tolist()
            ref = v1_cpu.generate([p], max_new_tokens=n_new)[0, len(p):]
            require(got == want, f"agree (window={window}): v2 {got} != v1 "
                                 f"{want} for a prompt of {len(p)}")
            require(want == ref.tolist(),
                    f"agree (window={window}): {dev} v1 {want} != CPU v1 "
                    f"{ref.tolist()}")
        launches = {"decode_attention": decode_attention.launches,
                    "paged_decode_attention": paged_decode_attention.launches}
        if dev.type == "cuda":
            require(launches["paged_decode_attention"] > 0
                    and launches["decode_attention"] > 0,
                    "agree: a kernel was not launched")
        out[f"window_{window}"] = {"prompts": len(prompts),
                                   "new_tokens": n_new, "launches": launches}
    return out


# -- phases 7-9 ------------------------------------------------------------

#: bench.py's headline training model (12 x 768, 12/12 heads of 64)
HEADLINE = dict(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                num_layers=12, num_heads=12, num_kv_heads=12,
                max_seq_len=2048)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 12, 8, 2048
WIDE_LAYERS, WIDE_STEPS, WIDE_BATCH = 4, 5, 1
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]


def ds_config(model, micro_batch: int) -> dict:
    """bench.build_engine's ds_config: AdamW lr 1e-4, ZeRO 0, the model's
    dtype; the groups the port accepts without effect stay in."""
    return {"train_micro_batch_size_per_gpu": micro_batch,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "zero_optimization": {"stage": 0},
            "bf16": {"enabled": model.config.dtype == torch.bfloat16},
            "steps_per_print": 0,
            "telemetry": {"enabled": True, "jsonl": False,
                          "prometheus": False},
            "tuning": {"auto_apply": False}}


def flash_launches() -> dict:
    from deepspeed_tpu_torch.ops import kernels
    return {name: getattr(kernels, name).launches for name in FLASH_KERNELS}


def train(model, steps: int, batch: int, seq: int, seed: int) -> dict:
    """``initialize`` then ``steps`` ``train_step``s on one repeated batch
    of random ids; each step timed with CUDA events (on a CPU model, with
    the host clock).  The flash kernels' launch counts are read from zero
    around the steps."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import kernels

    dev, cfg = model.device, model.config
    engine, *_ = initialize(model=model, config=ds_config(model, batch),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches(*(getattr(kernels, n) for n in FLASH_KERNELS))
    marks, metrics = [], []
    for _ in range(steps):
        if cuda:
            a, b = event_pair()
            a.record()
        else:
            t0 = time.perf_counter()
        metrics.append(engine.train_step({"input_ids": ids}))
        if cuda:
            b.record()
            marks.append((a, b))
        else:
            marks.append((time.perf_counter() - t0) * 1e3)
    if cuda:
        torch.cuda.synchronize()
        marks = [a.elapsed_time(b) for a, b in marks]
    launches = flash_launches()
    losses = [float(m["loss"]) for m in metrics]
    step_ms = statistics.median(marks[1:]) if steps > 1 else marks[0]
    tokens = batch * seq
    n_params = cfg.num_params()
    flops = (6 * n_params + 12 * cfg.num_layers * seq * cfg.hidden_size) \
        * tokens
    require(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train: loss did not fall over {steps} steps: {losses}")
    return {"steps": steps, "batch": batch, "seq": seq, "params": n_params,
            "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.hd,
            "dtype": str(cfg.dtype).split(".")[-1], "remat": cfg.remat,
            "attn_impl": cfg.attn_impl, "loss": losses,
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "lr": [m["lr"] for m in metrics],
            "step_ms": step_ms, "step_ms_all": marks,
            "first_step_ms": marks[0],
            "tokens_per_s": tokens / step_ms * 1e3,
            "model_flops_per_step": flops,
            "mfu": flops / (step_ms / 1e3) / PEAK_BF16,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None),
            "launches": launches}


def require_flash_launches(what: str, t: dict) -> None:
    """Each flash kernel launched as often as its formula says: per step,
    the forward once per layer and once more under remat (the layer is
    recomputed in the backward), each backward pass once per layer."""
    L, steps = t["layers"], t["steps"]
    want = {"flash_fwd": steps * L * (2 if t["remat"] else 1),
            "flash_bwd_dq": steps * L, "flash_bwd_dkv": steps * L}
    require(t["launches"] == want,
            f"{what}: flash launches {t['launches']}, want {want}")


def train_agree(dev, seed: int) -> dict:
    """Five ``train_step``s of a narrow fp32 GQA model (d 64, S 200: a tail
    tile) through the kernels on ``dev`` give the loss and grad-norm
    sequences of the same steps on the CPU's plain path, to 1e-4."""
    from deepspeed_tpu_torch import LlamaConfig, LlamaModel, initialize
    from deepspeed_tpu_torch.ops import kernels

    out = {}
    for window in (None, 96):
        cfg = LlamaConfig(vocab_size=2048, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=4,
                          num_kv_heads=2, max_seq_len=256,
                          sliding_window=window, dtype=torch.float32,
                          param_dtype=torch.float32, attn_impl="flash")
        ids = torch.from_numpy(np.random.default_rng(seed + 3).integers(
            0, cfg.vocab_size, (2, 200)))
        runs, weights = {}, None
        for where in (dev, torch.device("cpu")):  # the same initial weights
            model = LlamaModel(cfg, device=where, seed=seed + 4)
            if weights is None:
                weights = {k: v.cpu() for k, v in model.state_dict().items()}
            model.load_state_dict(weights)
            engine, *_ = initialize(model=model, config=dict(
                ds_config(model, 2), optimizer={
                    "type": "AdamW", "params": {"lr": 1e-3}}), device=where)
            reset_launches(*(getattr(kernels, n) for n in FLASH_KERNELS))
            ms = [engine.train_step({"input_ids": ids}) for _ in range(5)]
            runs[where.type] = ([float(m["loss"]) for m in ms],
                                [float(m["grad_norm"]) for m in ms],
                                flash_launches())
        (loss, norm, launches), (ref_loss, ref_norm, _) = \
            runs[dev.type], runs["cpu"]
        for name, got, want in (("loss", loss, ref_loss),
                                ("grad_norm", norm, ref_norm)):
            rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
            require(rel <= 1e-4, f"train_agree (window={window}): {name} "
                                 f"{got} != CPU {want} (rel {rel})")
        if dev.type == "cuda":
            require_flash_launches("train_agree", dict(
                layers=cfg.num_layers, steps=5, remat=cfg.remat,
                launches=launches))
        out[f"window_{window}"] = {"loss": loss, "cpu_loss": ref_loss,
                                   "grad_norm": norm, "cpu_grad_norm":
                                   ref_norm, "launches": launches}
    return out


# -- main ------------------------------------------------------------------

def nvidia_smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    return proc.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU path "
              "only", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch import KVCacheConfig, LlamaConfig, LlamaModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    emit(phase_build())
    timing = phase_kernels(dev)
    for name, row in timing.items():  # one line per kernel
        emit(dict(phase="kernels", kernel=name, **row))
    flash = phase_flash_kernels(dev)
    for name, row in flash.items():
        emit(dict(phase="kernels", kernel=name, **row))

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device=dev, seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    s = serve(model, rng, cache_config=KVCacheConfig(
        num_blocks=1025, block_size=16, max_seq_len=2048),
        header_len=512, requests=SERVE_REQUESTS, max_batch_slots=8,
        prefill_chunk=256, prefill_batch=2, decode_burst=8)
    paged = s["launches"]["paged_decode_attention"]
    require(paged == cfg.num_layers * s["decode_steps"],
            f"serve: paged kernel launched {paged} times, want "
            f"{cfg.num_layers} x {s['decode_steps']} decode steps")
    require(s["launches"]["decode_attention"] == 0,
            "serve: the padded-cache kernel ran on the paged path")
    emit(dict(phase="serve", model="llama3_8b", layers=cfg.num_layers,
              hidden=cfg.hidden_size, params=cfg.num_params(),
              dtype="bfloat16", reduced=[], init_s=init_s,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **s))

    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (V1_BATCH, V1_PROMPT)))
    g = generate_v1(model, ids, V1_NEW)
    want = cfg.num_layers * (V1_NEW - 1)
    require(g["launches"]["decode_attention"] == want,
            f"generate: decode kernel launched "
            f"{g['launches']['decode_attention']} times, want {want}")
    require(g["launches"]["paged_decode_attention"] == 0,
            "generate: the paged kernel ran on the padded-cache path")
    emit(dict(phase="generate", model="llama3_8b", **g))
    del model
    torch.cuda.empty_cache()

    emit(dict(phase="agree", **agree(dev, args.seed)))

    # the training main path: bench.py's headline at full width and depth
    t0 = time.perf_counter()
    model = LlamaModel(LlamaConfig(**HEADLINE, dtype=torch.bfloat16,
                                   param_dtype=torch.float32,
                                   attn_impl="flash"),
                       device=dev, seed=args.seed)
    t = train(model, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, args.seed)
    require_flash_launches("train", t)
    emit(dict(phase="train", model="bench.py headline", reduced=[],
              wall_s=time.perf_counter() - t0, **t))
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = LlamaModel(LlamaConfig.llama3_8b(
        num_layers=WIDE_LAYERS, dtype=torch.bfloat16,
        param_dtype=torch.float32, attn_impl="flash"),
        device=dev, seed=args.seed)
    w = train(model, WIDE_STEPS, WIDE_BATCH, TRAIN_SEQ, args.seed)
    require_flash_launches("train_8b_width", w)
    emit(dict(phase="train_8b_width", model="llama3_8b",
              reduced=[f"num_layers 32 -> {WIDE_LAYERS}"],
              wall_s=time.perf_counter() - t0, **w))
    del model
    torch.cuda.empty_cache()

    emit(dict(phase="train_agree", **train_agree(dev, args.seed)))

    decode_src = "deepspeed_tpu_torch/csrc/decode_attention.cu"
    flash_src = "deepspeed_tpu_torch/csrc/flash_attention.cu"
    pallas = "deepspeed_tpu/ops/pallas/"
    rows = {  # name: (source, TPU kernel, main-path launches, measured)
        "decode_attention": (decode_src, pallas + "decode_attention.py:98",
                             g["launches"]["decode_attention"],
                             timing["decode_attention"]),
        "paged_decode_attention": (decode_src,
                                   pallas + "paged_attention.py:116", paged,
                                   timing["paged_decode_attention"]),
        "flash_fwd": (flash_src, pallas + "flash_attention.py:260",
                      t["launches"]["flash_fwd"], flash["flash_fwd"]),
        "flash_bwd_dq": (flash_src, pallas + "flash_attention.py:453",
                         t["launches"]["flash_bwd_dq"],
                         flash["flash_bwd_dq"]),
        "flash_bwd_dkv": (flash_src, pallas + "flash_attention.py:472",
                          t["launches"]["flash_bwd_dkv"],
                          flash["flash_bwd_dkv"])}

    def kernel_row(name, source, replaces, launches, m):
        m = m["timed"]["headline"] if "timed" in m else m
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rows[name][3]["max_abs_err"],
                "ms": m["kernel_time"]["ms"],
                "plain_ms": m["plain_time"]["ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": (m["library_time"] or {}).get("ms")}

    emit({"kernels": [kernel_row(name, *row) for name, row in rows.items()],
          "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
