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
   kernels give the CPU plain path's loss and grad-norm sequences to 1e-4;
   then a narrow fp32 Mixtral with ``kernels.fused_adam``: the same against
   the CPU, and fused against unfused on the card to 1e-6.

The Mixtral slice adds:

- ``kernels`` lines for the MoE dispatch and combine kernels, against their
  plain versions at the train shape (T 2048, E 8, C 1024, H 4096) and the
  serve-prefill shape (T 512, C 256), bf16 and fp32, with empty slots and
  dropped assignments (dispatch exact), and for the multi-tensor gradient
  norm and fused Adam over the Mixtral-train parameter list (3.17 B fp32
  elements; an AdamW and an L2 Adam step, moments and parameters
  bit-equal); each timed as above beside its
  plain version, a one-call library yardstick and its bound;
- ``serve_moe``: Mixtral-8x7B widths, 24 of 32 layers, bf16, behind
  ``build_serving_frontend`` with the serve phase's knobs and requests:
  every budget returned, dispatch and combine ``num_layers`` times a
  prefill call and never in a decode burst (T 8 is the dense rung), the
  paged kernel ``num_layers`` times a decode step;
- ``generate_moe``: ``init_inference(...).generate`` on the same weights,
  ``[4, 256]`` + 32: dispatch and combine ``num_layers`` times (the one
  prefill), the decode kernel ``num_layers x 31`` times;
- ``agree_moe``: a narrow fp32 Mixtral (E 4, top-2, capacity factor 2: no
  drops) on the kernel rung: v2 greedy == v1 greedy == the CPU's;
- ``train_moe``: Mixtral-8x7B widths, 2 layers, ``[1, 2048]``, bf16 on
  fp32 masters, AdamW lr 1e-4, ``kernels.fused_adam``, flash, remat, 5
  steps: a finite, falling loss; per step dispatch and combine 2 L times,
  the norm and Adam once each; MFU counts the top-2 experts.

Then a ``kernels`` line (every kernel's launches on the main paths: the
decode kernels' from ``serve`` and ``generate``, the flash kernels' from
``train``, the MoE kernels' from ``serve_moe``, ``generate_moe`` and
``train_moe``, the norm and Adam kernels' from ``train_moe``; times at the
main paths' shapes), the card's name and power limit, and the result line.
``--only build,moe_kernels,...`` runs the named phases alone and prints
neither of the last two lines.  TF32 is off for matmuls and cuDNN.  Length 0
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


def kernel_wrappers() -> dict:
    """Every ported kernel's name in the ``kernels`` line → its wrapper,
    whose ``launches`` counts the kernel's launches."""
    from deepspeed_tpu_torch.ops import kernels as k
    return {"decode_attention": k.decode_attention,
            "paged_decode_attention": k.paged_decode_attention,
            "flash_fwd": k.flash_fwd, "flash_bwd_dq": k.flash_bwd_dq,
            "flash_bwd_dkv": k.flash_bwd_dkv,
            "moe_dispatch": k.moe_dispatch_fwd,
            "moe_combine": k.moe_combine_fwd,
            "multi_tensor_sqsum": k.tree_sqsum, "fused_adam": k.fused_adam}


def reset_counts() -> None:
    reset_launches(*kernel_wrappers().values())


def read_counts() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


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
                             r"flash_bwd_dkv|dispatch|combine|sqsum_partial|"
                             r"sqsum_final|adam)_kernel", entry.group(1))
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


# -- the MoE and fused-Adam kernels -----------------------------------------

#: (case, T, C): the training phase's [1, 2048] and the serve phase's
#: prefill call (chunk 256 x 2), at Mixtral-8x7B's E 8, H 4096, top-2
MOE_CASES = [("train", 2048, 1024), ("serve_prefill", 512, 256)]
MOE_E, MOE_H, MOE_K = 8, 4096, 2
MOE_KERNELS = ("moe_dispatch", "moe_combine")
ADAM_KERNELS = ("multi_tensor_sqsum", "fused_adam")


def moe_inputs(T, C, dtype, gen, dev) -> tuple:
    """Tokens ``[T, H]``, an expert output ``[E, C, H]`` and a top-2
    routing with expert 0's logits raised by 1.5: expert 0 overflows
    (dropped assignments) while the others leave slots empty."""
    from deepspeed_tpu_torch.moe import top_k_gating_indices
    from deepspeed_tpu_torch.ops.kernels.moe_dispatch import \
        routing_to_indices
    logits = torch.randn(T, MOE_E, generator=gen, device=dev)
    logits[:, 0] += 1.5
    gi, _, _ = top_k_gating_indices(logits, MOE_K, C)
    src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep, MOE_E, C)
    tokens = torch.randn(T, MOE_H, generator=gen, device=dev).to(dtype)
    eo = torch.randn(MOE_E, C, MOE_H, generator=gen, device=dev).to(dtype)
    return tokens, eo, src, flat, gi.gate.t().contiguous()


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def moe_bounds(tokens, src, flat) -> dict:
    """Least time per kernel for this routing: dispatch reads each routed
    token once and writes every slot (empty ones as zeros) and reads the
    index; combine reads each kept assignment's row, the indices and gates,
    and writes every token's row, 2 flops per kept element."""
    T, H = tokens.shape
    el = tokens.element_size()
    slots = src.numel()
    routed = int(torch.unique(src[src >= 0]).numel())
    kept = int((flat < slots).sum())
    peak = PEAK_FLOPS[tokens.dtype]
    return {"moe_dispatch": bound((routed + slots) * H * el + slots * 4, 0,
                                  peak),
            "moe_combine": bound((kept + T) * H * el + flat.numel() * 8,
                                 2 * kept * H, peak)}


def phase_moe_kernels(dev) -> dict:
    """Dispatch and combine against their plain versions at every
    ``MOE_CASES`` shape, bf16 and fp32; then timed at the train shape in
    bf16 beside the plain versions, a library call (``index_select`` on a
    zero-row-padded token table; ``F.embedding_bag`` with the gates as
    per-sample weights on the zero-row-padded expert output, built outside
    the timed call) and the bound."""
    from deepspeed_tpu_torch.ops.kernels import (combine_reference,
                                                 dispatch_reference,
                                                 moe_combine_fwd,
                                                 moe_dispatch_fwd)

    gen = torch.Generator(device=dev).manual_seed(2468)
    errs = {name: {} for name in MOE_KERNELS}
    for (case, T, C), dtype in itertools.product(
            MOE_CASES, (torch.bfloat16, torch.float32)):
        tokens, eo, src, flat, gates = moe_inputs(T, C, dtype, gen, dev)
        require(bool((src < 0).any()) and bool((flat == MOE_E * C).any()),
                f"moe {case}: no empty slot or no dropped assignment")
        got = moe_dispatch_fwd(tokens, src)
        want = dispatch_reference(tokens, src)
        y = moe_combine_fwd(eo, flat, gates)
        want_y = combine_reference(eo, flat, gates)
        torch.cuda.synchronize()
        key = f"{case}_{str(dtype).split('.')[-1]}"
        require(got.dtype == dtype and torch.equal(got, want),
                f"moe_dispatch {key}: not equal to the plain version")
        errs["moe_dispatch"][key] = 0.0
        require(y.dtype == dtype and y.shape == want_y.shape,
                f"moe_combine {key}: wrong dtype/shape")
        require(bool(torch.isfinite(y).all()), f"moe_combine {key}: "
                                               "non-finite")
        err = (y.float() - want_y.float()).abs()
        require(bool((err <= TOL[dtype] * (1 + want_y.float().abs())).all()),
                f"moe_combine {key}: max error {err.max().item()} over "
                f"tolerance {TOL[dtype]} x (1 + |plain|)")
        errs["moe_combine"][key] = err.max().item()

    case, T, C = MOE_CASES[0]
    sets = []
    for _ in range(3):  # 3 x 84 MB: no call finds its rows in L2
        tokens, eo, src, flat, gates = moe_inputs(T, C, torch.bfloat16, gen,
                                                  dev)
        padded = torch.cat([tokens, tokens.new_zeros(1, MOE_H)])
        rows = torch.where(src >= 0, src, T).reshape(-1).long()
        eo_padded = torch.cat([eo.reshape(-1, MOE_H),
                               eo.new_zeros(1, MOE_H)])
        sets.append((tokens, eo, src, flat, gates, padded, rows, eo_padded,
                     flat.long(), gates.to(torch.bfloat16)))
    tokens, eo, src, flat, gates, padded, rows, eo_padded, fl, gb = sets[0]
    lib = {"moe_dispatch": lambda s: torch.index_select(s[5], 0, s[6]),
           "moe_combine": lambda s: F.embedding_bag(
               s[8], s[7], per_sample_weights=s[9], mode="sum")}
    lib_err = {
        "moe_dispatch": (lib["moe_dispatch"](sets[0]).reshape(eo.shape)
                         .float() - dispatch_reference(tokens, src).float()
                         ).abs().max().item(),
        "moe_combine": (lib["moe_combine"](sets[0]).float()
                        - combine_reference(eo, flat, gates).float()
                        ).abs().max().item()}
    run = {"moe_dispatch": (lambda s: moe_dispatch_fwd(s[0], s[2]),
                            lambda s: dispatch_reference(s[0], s[2])),
           "moe_combine": (lambda s: moe_combine_fwd(s[1], s[3], s[4]),
                           lambda s: combine_reference(s[1], s[3], s[4]))}
    bounds = moe_bounds(tokens, src, flat)
    cycles = sleep_cycles_per_ms()
    out = {}
    for name, (fn, plain) in run.items():
        out[name] = dict(
            kernel_time=time_ms([lambda s=s: fn(s) for s in sets], cycles),
            plain_time=time_ms([lambda s=s: plain(s) for s in sets], cycles),
            library_time=time_ms([lambda s=s: lib[name](s) for s in sets],
                                 cycles),
            library_call=("torch.index_select on the zero-row-padded tokens"
                          if name == "moe_dispatch" else
                          "F.embedding_bag(flat_idx, padded expert output, "
                          "per_sample_weights=gates, mode='sum')"),
            library_max_abs_err_vs_plain=lib_err[name],
            bound_ms=bounds[name][0], bound_by=bounds[name][1],
            max_abs_err=max(errs[name].values()),
            max_abs_err_by_case=errs[name],
            checked_at={c: dict(T=t, E=MOE_E, C=cc, H=MOE_H, k=MOE_K)
                        for c, t, cc in MOE_CASES},
            tolerance=("exact" if name == "moe_dispatch" else
                       {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16]}),
            timed_at=f"bf16, {case}: T {T}, E {MOE_E}, C {C}, H {MOE_H}",
            dropped_assignments=int((flat == MOE_E * C).sum()),
            empty_slots=int((src < 0).sum()))
    del sets, tokens, eo, src, flat, gates, padded, rows, eo_padded, fl, gb
    torch.cuda.empty_cache()
    out["moe_dispatch"]["crossover"] = moe_crossover(dev)
    return out


#: token counts of the dense-vs-kernel crossover scan (top-2 of 8, capacity
#: factor 2, H 4096, bf16): T·E·C from 256 to 4.2 M
CROSSOVER_T = (8, 16, 32, 64, 128, 256, 512, 1024)


def moe_crossover(dev) -> list:
    """The MoE layer's two rungs without the experts, timed at each
    ``CROSSOVER_T``, whole (dense: ``top_k_gating`` and the two one-hot
    einsums; kernel: ``top_k_gating_indices``, the index form, dispatch and
    combine) and as data movement alone (the einsums on prebuilt masks
    against the two kernels on prebuilt indices; the same routing)."""
    from deepspeed_tpu_torch.moe import TopKGate
    from deepspeed_tpu_torch.ops.kernels import moe_combine_fwd, \
        moe_dispatch_fwd
    from deepspeed_tpu_torch.ops.kernels.moe_dispatch import \
        routing_to_indices

    gate = TopKGate(num_experts=MOE_E, k=MOE_K, capacity_factor=2.0)
    gen = torch.Generator(device=dev).manual_seed(97)
    cycles = sleep_cycles_per_ms()
    rows = []
    for T in CROSSOVER_T:
        C = gate.capacity(T)
        x = torch.randn(T, MOE_H, generator=gen, device=dev).to(
            torch.bfloat16)
        wg = torch.randn(MOE_H, MOE_E, generator=gen, device=dev)
        eo = torch.randn(MOE_E, C, MOE_H, generator=gen, device=dev).to(
            torch.bfloat16)

        def dense():
            combine, dispatch, _, _ = gate(wg, x)
            torch.einsum("tec,th->ech", dispatch.to(x.dtype), x)
            return torch.einsum("tec,ech->th", combine.to(x.dtype), eo)

        def kernels():
            gi, _, _ = gate.route(wg, x)
            src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep,
                                           MOE_E, C)
            moe_dispatch_fwd(x, src)
            return moe_combine_fwd(eo, flat, gi.gate.t())

        combine, dispatch, _, _ = gate(wg, x)
        masks = (dispatch.to(x.dtype), combine.to(x.dtype))
        gi, _, _ = gate.route(wg, x)
        src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep,
                                       MOE_E, C)
        gates = gi.gate.t().contiguous()

        def move_dense():
            torch.einsum("tec,th->ech", masks[0], x)
            return torch.einsum("tec,ech->th", masks[1], eo)

        def move_kernels():
            moe_dispatch_fwd(x, src)
            return moe_combine_fwd(eo, flat, gates)

        row = dict(T=T, C=C, tec=T * MOE_E * C)
        for name, fn in (("dense", dense), ("kernel", kernels),
                         ("move_dense", move_dense),
                         ("move_kernel", move_kernels)):
            t = time_ms([fn], cycles)
            row[name + "_ms"] = t["ms"]
            row[name + "_host_hidden"] = t["host_hidden"]
        rows.append(row)
    return rows


def mixtral_train_shapes(cfg) -> list:
    """The parameter shapes of a Mixtral model, in ``parameters()`` order
    (embedding, layers, final norm, head), without allocating them."""
    from deepspeed_tpu_torch.models.mixtral import MixtralDecoderLayer
    layer = [tuple(p.shape) for p in MixtralDecoderLayer(cfg,
                                                         "meta").parameters()]
    V, H = cfg.vocab_size, cfg.hidden_size
    return [(V, H)] + layer * cfg.num_layers + [(H,), (V, H)]


def adam_tensor(shape, seed: int, i: int, dev) -> tuple:
    """Parameter ``i``'s p and gradient (scale 1e-3), drawn again the same
    for the check; fresh moments are zeros."""
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + i)
    p = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev).mul_(1e-3)
    return p, g


#: the Adam check's two steps: (count, gradient multiplier, config) — AdamW
#: from fresh moments, then Adam with L2 decay on the moments it left
ADAM_CHECK_STEPS = ((1, 0.5, dict(weight_decay=0.1, decoupled_wd=True)),
                    (2, 0.25, dict(weight_decay=0.1, decoupled_wd=False)))


def phase_adam_kernels(dev, shapes, seed: int) -> dict:
    """The gradient norm and two fused Adam steps over ``shapes`` (fp32, lr
    1e-4, the :data:`ADAM_CHECK_STEPS`: both weight-decay branches, a
    gradient multiplier on the device), against their plain versions: the
    norm within 1e-6 relative, and after each step the moments and the
    parameters bit-equal, tensor by tensor (the plain version's inputs are
    drawn again from the same seeds and stepped again); then timed beside
    the plain versions, the library's ``torch._foreach_norm`` /
    ``torch._fused_adamw_`` and the bounds (4 and 28 bytes an element)."""
    from deepspeed_tpu_torch.ops.kernels import (FusedAdamConfig,
                                                 MultiTensorPlan, fused_adam,
                                                 reference_adam,
                                                 reference_sqsum, tree_sqsum)

    lr = 1e-4
    steps = [(count, torch.full((), mult, device=dev), FusedAdamConfig(**kw))
             for count, mult, kw in ADAM_CHECK_STEPS]
    pg = [adam_tensor(s, seed, i, dev) for i, s in enumerate(shapes)]
    params, grads = [p for p, _ in pg], [g for _, g in pg]
    del pg
    ms = [torch.zeros_like(p) for p in params]
    vs = [torch.zeros_like(p) for p in params]
    n = sum(p.numel() for p in params)
    plan = MultiTensorPlan(params)
    sq = tree_sqsum(grads, plan)
    sq_again = tree_sqsum(grads, plan)
    sq_plain = reference_sqsum(grads)
    torch.cuda.synchronize()
    sq_err = abs(sq.item() - sq_plain.item())
    require(sq_err <= 1e-6 * abs(sq_plain.item()),
            f"multi_tensor_sqsum: {sq.item()} != plain {sq_plain.item()}")
    require(torch.equal(sq, sq_again), "multi_tensor_sqsum: not repeatable")
    adam_err = 0.0
    for k, (count, mult, cfg) in enumerate(steps):
        fused_adam(params, grads, ms, vs, count, lr, mult, cfg, plan)
        torch.cuda.synchronize()
        for i, s in enumerate(shapes):
            p0, g0 = adam_tensor(s, seed, i, dev)
            m0, v0 = torch.zeros_like(p0), torch.zeros_like(p0)
            for c, mu, cf in steps[:k + 1]:
                reference_adam([p0], [g0], [m0], [v0], c, lr, mu, cf)
            for what, got, want in (("m", ms[i], m0), ("v", vs[i], v0),
                                    ("p", params[i], p0)):
                err = (got - want).abs().max().item()
                adam_err = max(adam_err, err)
                require(torch.equal(got, want),
                        f"fused_adam: step {count} ({cfg}): tensor {i} {s}: "
                        f"{what} not bit-equal (max error {err})")
            del p0, g0, m0, v0
        torch.cuda.empty_cache()
    count, mult, cfg = steps[0]
    counts = [torch.ones((), device=dev) for _ in params]
    lib_err = abs(torch.stack(torch._foreach_norm(grads)).square().sum()
                  .item() - sq_plain.item())
    cycles = sleep_cycles_per_ms()
    timing = {
        "multi_tensor_sqsum": dict(
            kernel_time=time_ms([lambda: tree_sqsum(grads, plan)], cycles),
            plain_time=time_ms([lambda: reference_sqsum(grads)], cycles,
                               per_rep=3),
            library_time=time_ms([lambda: torch._foreach_norm(grads)],
                                 cycles),
            library_call="torch._foreach_norm(grads) (per-tensor norms)",
            library_abs_err_vs_plain=lib_err,
            max_abs_err=sq_err, relative_err=sq_err / sq_plain.item()),
        "fused_adam": dict(
            kernel_time=time_ms([lambda: fused_adam(
                params, grads, ms, vs, 3, lr, mult, cfg, plan)], cycles,
                per_rep=3),
            plain_time=time_ms([lambda: reference_adam(
                params, grads, ms, vs, 3, lr, mult, cfg)], cycles,
                per_rep=3),
            library_time=time_ms([lambda: torch._fused_adamw_(
                params, grads, ms, vs, [], counts, lr=lr, beta1=cfg.b1,
                beta2=cfg.b2, weight_decay=cfg.weight_decay, eps=cfg.eps,
                amsgrad=False, maximize=False)], cycles, per_rep=3),
            library_call="torch._fused_adamw_ over the same lists",
            max_abs_err=adam_err,
            checked="moments and parameters bit-equal after an AdamW "
                    "step and an L2 Adam step")}
    peak = PEAK_FLOPS[torch.float32]
    for name, nbytes, flops in (("multi_tensor_sqsum", 4 * n, 2 * n),
                                ("fused_adam", 28 * n, 17 * n)):
        b, by = bound(nbytes, flops, peak)
        timing[name].update(bound_ms=b, bound_by=by, elements=n,
                            tensors=len(shapes), dtype="float32",
                            tolerance=("1e-6 relative" if name ==
                                       "multi_tensor_sqsum" else "exact"))
    del params, grads, ms, vs, counts, steps, plan
    torch.cuda.empty_cache()
    return timing


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

    V = model.config.vocab_size
    header = rng.integers(0, V, header_len).tolist()
    prompts = []
    for i, (n, _, _) in enumerate(requests):
        body = rng.integers(0, V, n - (header_len if i < 2 else 0)).tolist()
        prompts.append((header if i < 2 else []) + body)
    fe = build_serving_frontend(model, cache_config=cache_config,
                                device=model.device, **engine)
    eng = fe.router.replicas[0].engine
    reset_counts()
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
    launches = read_counts()
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

    eng = init_inference(model, device=model.device)
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=n_new)
    out_host = out.cpu()
    wall = time.perf_counter() - t0
    launches = read_counts()
    B, S = ids.shape
    require(tuple(out_host.shape) == (B, S + n_new), "generate: wrong shape")
    require(torch.equal(out_host[:, :S], ids.cpu()),
            "generate: the prompt was not kept")
    require(bool(((out_host >= 0) & (out_host < model.config.vocab_size))
                 .all()), "generate: ids outside the vocabulary")
    return {"wall_s": wall, "batch": B, "prompt_len": S, "new_tokens": n_new,
            "tokens_per_s": B * n_new / wall, "launches": launches}


# -- phase 6 ---------------------------------------------------------------

#: the agree phase's narrow fp32 model; ``agree_moe`` adds the experts
AGREE_MODEL = dict(vocab_size=32000, hidden_size=512, intermediate_size=1408,
                   num_layers=4, num_heads=8, num_kv_heads=2, max_seq_len=512,
                   dtype=torch.float32)
AGREE_MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0,
                 moe_dispatch_impl="pallas")


def agree(dev, seed: int, moe: bool = False) -> dict:
    """v2 greedy == v1 greedy (both through the kernels on ``dev``) == the
    CPU plain path's v1 greedy, on a narrow fp32 model, with and without a
    sliding window (``moe``: a Mixtral on the kernel rung, without
    drops)."""
    from deepspeed_tpu_torch import (KVCacheConfig, LlamaConfig, LlamaModel,
                                     MixtralConfig, MixtralModel,
                                     build_engine_v2, init_inference)

    rng = np.random.default_rng(seed + 1)
    cfg_cls, model_cls, extra = ((MixtralConfig, MixtralModel, AGREE_MOE)
                                 if moe else (LlamaConfig, LlamaModel, {}))
    kernels = ["decode_attention", "paged_decode_attention"] + (
        list(MOE_KERNELS) if moe else [])
    out = {}
    for window in (None, 48):
        cfg = cfg_cls(**AGREE_MODEL, **extra, sliding_window=window)
        model = model_cls(cfg, device=dev, seed=seed + 2)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (5, 37, 100, 260)]
        n_new = 16
        reset_counts()
        v2 = build_engine_v2(model, cache_config=KVCacheConfig(
            num_blocks=128, block_size=16, max_seq_len=512),
            max_batch_slots=4, prefill_chunk=64, decode_burst=8,
            device=dev).generate(prompts, max_new_tokens=n_new)
        v1 = init_inference(model, device=dev)
        cpu_model = model_cls(cfg, device="cpu")
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
        launches = {k: v for k, v in read_counts().items() if k in kernels}
        if dev.type == "cuda":
            require(all(launches.values()),
                    f"agree: a kernel was not launched: {launches}")
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


def ds_config(model, micro_batch: int, fused_adam: bool = False) -> dict:
    """bench.build_engine's ds_config: AdamW lr 1e-4, ZeRO 0, the model's
    dtype; the groups the port accepts without effect stay in.
    ``fused_adam`` turns on the two-kernel Adam step."""
    return {"train_micro_batch_size_per_gpu": micro_batch,
            "kernels": {"fused_adam": fused_adam},
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "zero_optimization": {"stage": 0},
            "bf16": {"enabled": model.config.dtype == torch.bfloat16},
            "steps_per_print": 0,
            "telemetry": {"enabled": True, "jsonl": False,
                          "prometheus": False},
            "tuning": {"auto_apply": False}}


TRAIN_KERNELS = FLASH_KERNELS + MOE_KERNELS + ADAM_KERNELS


def train_launches() -> dict:
    return {k: v for k, v in read_counts().items() if k in TRAIN_KERNELS}


def train(model, steps: int, batch: int, seq: int, seed: int,
          fused_adam: bool = False) -> dict:
    """``initialize`` then ``steps`` ``train_step``s on one repeated batch
    of random ids; each step timed with CUDA events (on a CPU model, with
    the host clock).  The training kernels' launch counts are read from
    zero around the steps.  MFU counts the parameters a token runs through
    (a Mixtral's top-k experts)."""
    from deepspeed_tpu_torch import initialize

    dev, cfg = model.device, model.config
    engine, *_ = initialize(model=model,
                            config=ds_config(model, batch, fused_adam),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    launches = train_launches()
    losses = [float(m["loss"]) for m in metrics]
    step_ms = statistics.median(marks[1:]) if steps > 1 else marks[0]
    tokens = batch * seq
    n_params = cfg.num_params()
    n_active = getattr(cfg, "active_params", cfg.num_params)()
    flops = (6 * n_active + 12 * cfg.num_layers * seq * cfg.hidden_size) \
        * tokens
    require(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train: loss did not fall over {steps} steps: {losses}")
    return {"steps": steps, "batch": batch, "seq": seq, "params": n_params,
            "active_params": n_active, "fused_adam": fused_adam,
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


def require_train_launches(what: str, t: dict, moe: bool = False) -> None:
    """Each training kernel launched as often as its formula says: per
    step, the flash forward once per layer and once more under remat (the
    layer is recomputed in the backward), each flash backward pass once per
    layer; for a Mixtral, dispatch and combine as often as the flash
    forward; under ``fused_adam`` the norm and the Adam kernels once a
    step; every other training kernel never."""
    L, steps = t["layers"], t["steps"]
    fwd = steps * L * (2 if t["remat"] else 1)
    want = {"flash_fwd": fwd, "flash_bwd_dq": steps * L,
            "flash_bwd_dkv": steps * L,
            "moe_dispatch": fwd if moe else 0,
            "moe_combine": fwd if moe else 0,
            "multi_tensor_sqsum": steps if t["fused_adam"] else 0,
            "fused_adam": steps if t["fused_adam"] else 0}
    require(t["launches"] == want,
            f"{what}: launches {t['launches']}, want {want}")


#: the train_agree phase's narrow fp32 GQA model (d 64, S 200: a tail
#: tile); its Mixtral case adds four experts (T 400 is on the kernel rung)
AGREE_TRAIN = dict(vocab_size=2048, hidden_size=256, intermediate_size=512,
                   num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
                   dtype=torch.float32, param_dtype=torch.float32,
                   attn_impl="flash")
AGREE_TRAIN_CASES = {  # name: (window, Mixtral, fused Adam)
    "window_None": (None, False, False), "window_96": (96, False, False),
    "mixtral_fused_adam": (None, True, True)}


def _agree_run(cfg, model_cls, where, weights, seed, ids, fused: bool,
               clip: float) -> tuple:
    from deepspeed_tpu_torch import initialize

    model = model_cls(cfg, device=where, seed=seed + 4)
    model.load_state_dict(weights)
    engine, *_ = initialize(model=model, config=dict(
        ds_config(model, 2, fused), optimizer={
            "type": "AdamW", "params": {"lr": 1e-3}},
        gradient_clipping=clip), device=where)
    reset_counts()
    ms = [engine.train_step({"input_ids": ids}) for _ in range(5)]
    return ([float(m["loss"]) for m in ms],
            [float(m["grad_norm"]) for m in ms], train_launches())


def _max_rel(got, want) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def train_agree(dev, seed: int) -> dict:
    """Five ``train_step``s of a narrow fp32 model through the kernels on
    ``dev`` give the loss and grad-norm sequences of the same steps on the
    CPU's plain path, to 1e-4: a GQA Llama with and without a window, and a
    Mixtral under ``kernels.fused_adam`` (with clipping), whose fused and
    unfused runs on ``dev`` also agree to 1e-6."""
    from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                     MixtralModel)

    out = {}
    for name, (window, moe, fused) in AGREE_TRAIN_CASES.items():
        cfg_cls, model_cls = ((MixtralConfig, MixtralModel) if moe
                              else (LlamaConfig, LlamaModel))
        cfg = cfg_cls(**AGREE_TRAIN, sliding_window=window,
                      **(dict(num_experts=4, top_k=2) if moe else {}))
        ids = torch.from_numpy(np.random.default_rng(seed + 3).integers(
            0, cfg.vocab_size, (2, 200)))
        weights = {k: v.cpu() for k, v in  # the same initial weights
                   model_cls(cfg, device=dev, seed=seed + 4)
                   .state_dict().items()}
        clip = 1.0 if fused else 0.0
        loss, norm, launches = _agree_run(cfg, model_cls, dev, weights, seed,
                                          ids, fused, clip)
        ref_loss, ref_norm, _ = _agree_run(cfg, model_cls,
                                           torch.device("cpu"), weights,
                                           seed, ids, fused, clip)
        row = {"loss": loss, "cpu_loss": ref_loss, "grad_norm": norm,
               "cpu_grad_norm": ref_norm, "launches": launches}
        for what, got, want in (("loss", loss, ref_loss),
                                ("grad_norm", norm, ref_norm)):
            rel = _max_rel(got, want)
            require(rel <= 1e-4, f"train_agree ({name}): {what} {got} != "
                                 f"CPU {want} (rel {rel})")
        if fused:
            plain_loss, plain_norm, _ = _agree_run(cfg, model_cls, dev,
                                                   weights, seed, ids, False,
                                                   clip)
            row.update(unfused_loss=plain_loss, unfused_grad_norm=plain_norm)
            for what, got, want in (("loss", loss, plain_loss),
                                    ("grad_norm", norm, plain_norm)):
                rel = _max_rel(got, want)
                require(rel <= 1e-6, f"train_agree ({name}): fused {what} "
                                     f"{got} != unfused {want} (rel {rel})")
        if dev.type == "cuda":
            require_train_launches(f"train_agree ({name})", dict(
                layers=cfg.num_layers, steps=5, remat=cfg.remat,
                fused_adam=fused, launches=launches), moe=moe)
        out[name] = row
    return out


# -- main ------------------------------------------------------------------

def nvidia_smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    return proc.stdout.strip()


#: Mixtral-8x7B serving keeps 24 of its 32 layers (93.4 GB of bf16
#: weights at 32, 70.2 GB at 24 on an 80 GB card); training keeps 2 (fp32
#: masters, gradients and both moments: 16 bytes a parameter, 50.6 GB)
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 24, 2, 5


def run_serving(model, name: str, seed: int, reduced: list) -> tuple:
    """The ``serve`` and ``generate`` phases of one model (and their
    launch checks); returns (serve, generate) results."""
    from deepspeed_tpu_torch import KVCacheConfig

    cfg = model.config
    moe = hasattr(cfg, "num_experts")
    rng = np.random.default_rng(seed)
    s = serve(model, rng, cache_config=KVCacheConfig(
        num_blocks=1025, block_size=16, max_seq_len=2048),
        header_len=512, requests=SERVE_REQUESTS, max_batch_slots=8,
        prefill_chunk=256, prefill_batch=2, decode_burst=8)
    L, la = cfg.num_layers, s["launches"]
    require(la["paged_decode_attention"] == L * s["decode_steps"],
            f"serve ({name}): paged kernel launched "
            f"{la['paged_decode_attention']} times, want {L} x "
            f"{s['decode_steps']} decode steps")
    require(la["decode_attention"] == 0,
            f"serve ({name}): the padded-cache kernel ran on the paged path")
    for kernel in MOE_KERNELS:  # prefill calls only: decode is dense
        want = L * s["prefill_calls"] if moe else 0
        require(la[kernel] == want, f"serve ({name}): {kernel} launched "
                                    f"{la[kernel]} times, want {want}")
    emit(dict(phase="serve_moe" if moe else "serve", model=name, layers=L,
              hidden=cfg.hidden_size, params=cfg.num_params(),
              dtype="bfloat16", reduced=reduced,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **s))

    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (V1_BATCH, V1_PROMPT)))
    g = generate_v1(model, ids, V1_NEW)
    la = g["launches"]
    want = L * (V1_NEW - 1)
    require(la["decode_attention"] == want,
            f"generate ({name}): decode kernel launched "
            f"{la['decode_attention']} times, want {want}")
    require(la["paged_decode_attention"] == 0,
            f"generate ({name}): the paged kernel ran on the padded-cache "
            "path")
    for kernel in MOE_KERNELS:  # the one prefill; decode (T 4) is dense
        want = L if moe else 0
        require(la[kernel] == want, f"generate ({name}): {kernel} launched "
                                    f"{la[kernel]} times, want {want}")
    emit(dict(phase="generate_moe" if moe else "generate", model=name, **g))
    return s, g


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run alone (build, "
                         "kernels, flash_kernels, moe_kernels, adam_kernels, "
                         "serve, agree, serve_moe, agree_moe, train, "
                         "train_8b_width, train_moe, train_agree)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU path "
              "only", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                     MixtralModel)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    res = {}

    def kernels():
        res["timing"] = phase_kernels(dev)
        for name, row in res["timing"].items():  # one line per kernel
            emit(dict(phase="kernels", kernel=name, **row))

    def flash_kernels():
        res["flash"] = phase_flash_kernels(dev)
        for name, row in res["flash"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def moe_kernels():
        res["moe"] = phase_moe_kernels(dev)
        for name, row in res["moe"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def adam_kernels():
        cfg = MixtralConfig.mixtral_8x7b(num_layers=MOE_TRAIN_LAYERS)
        res["adam"] = phase_adam_kernels(dev, mixtral_train_shapes(cfg),
                                         args.seed)
        for name, row in res["adam"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def serving(moe: bool):
        cfg = (MixtralConfig.mixtral_8x7b(num_layers=MOE_SERVE_LAYERS)
               if moe else LlamaConfig.llama3_8b())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = (MixtralModel if moe else LlamaModel)(cfg, device=dev,
                                                      seed=args.seed)
        torch.cuda.synchronize()
        emit(dict(phase="init", model="mixtral_8x7b" if moe else "llama3_8b",
                  seconds=time.perf_counter() - t0))
        key = "serve_moe" if moe else "serve"
        res[key] = run_serving(
            model, "mixtral_8x7b" if moe else "llama3_8b", args.seed,
            [f"num_layers 32 -> {MOE_SERVE_LAYERS}"] if moe else [])
        del model
        torch.cuda.empty_cache()

    def training(name: str):
        t0 = time.perf_counter()
        if name == "train":  # bench.py's headline at full width and depth
            cfg = LlamaConfig(**HEADLINE, dtype=torch.bfloat16,
                              param_dtype=torch.float32, attn_impl="flash")
            steps, batch, reduced, label = TRAIN_STEPS, TRAIN_BATCH, [], \
                "bench.py headline"
        elif name == "train_8b_width":
            cfg = LlamaConfig.llama3_8b(
                num_layers=WIDE_LAYERS, dtype=torch.bfloat16,
                param_dtype=torch.float32, attn_impl="flash")
            steps, batch, label = WIDE_STEPS, WIDE_BATCH, "llama3_8b"
            reduced = [f"num_layers 32 -> {WIDE_LAYERS}"]
        else:
            cfg = MixtralConfig.mixtral_8x7b(
                num_layers=MOE_TRAIN_LAYERS, dtype=torch.bfloat16,
                param_dtype=torch.float32, attn_impl="flash")
            steps, batch, label = MOE_TRAIN_STEPS, 1, "mixtral_8x7b"
            reduced = [f"num_layers 32 -> {MOE_TRAIN_LAYERS}"]
        moe = name == "train_moe"
        model = (MixtralModel if moe else LlamaModel)(cfg, device=dev,
                                                      seed=args.seed)
        t = train(model, steps, batch, TRAIN_SEQ, args.seed, fused_adam=moe)
        require_train_launches(name, t, moe=moe)
        emit(dict(phase=name, model=label, reduced=reduced,
                  wall_s=time.perf_counter() - t0, **t))
        res[name] = t
        del model
        torch.cuda.empty_cache()

    phases = {
        "build": lambda: emit(phase_build()),
        "kernels": kernels, "flash_kernels": flash_kernels,
        "moe_kernels": moe_kernels, "adam_kernels": adam_kernels,
        "serve": lambda: serving(False),
        "agree": lambda: emit(dict(phase="agree", **agree(dev, args.seed))),
        "serve_moe": lambda: serving(True),
        "agree_moe": lambda: emit(dict(phase="agree_moe",
                                       **agree(dev, args.seed, moe=True))),
        "train": lambda: training("train"),
        "train_8b_width": lambda: training("train_8b_width"),
        "train_moe": lambda: training("train_moe"),
        "train_agree": lambda: emit(dict(phase="train_agree",
                                         **train_agree(dev, args.seed)))}
    only = [p for p in args.only.split(",") if p]
    unknown = set(only) - set(phases)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    for name, run in phases.items():
        if not only or name in only:
            run()
    if only:
        return 0

    decode_src = "deepspeed_tpu_torch/csrc/decode_attention.cu"
    flash_src = "deepspeed_tpu_torch/csrc/flash_attention.cu"
    moe_src = "deepspeed_tpu_torch/csrc/moe_dispatch.cu"
    adam_src = "deepspeed_tpu_torch/csrc/fused_adam.cu"
    pallas = "deepspeed_tpu/ops/pallas/"
    (s, g), (sm, gm), t, tm = (res["serve"], res["serve_moe"], res["train"],
                               res["train_moe"])
    timing, flash, moe, adam = (res["timing"], res["flash"], res["moe"],
                                res["adam"])

    def moe_launches(kernel):  # every MoE main path
        return sum(x["launches"][kernel] for x in (sm, gm, tm))

    rows = {  # name: (source, TPU kernel, main-path launches, measured)
        "decode_attention": (decode_src, pallas + "decode_attention.py:98",
                             g["launches"]["decode_attention"],
                             timing["decode_attention"]),
        "paged_decode_attention": (decode_src,
                                   pallas + "paged_attention.py:116",
                                   s["launches"]["paged_decode_attention"],
                                   timing["paged_decode_attention"]),
        "flash_fwd": (flash_src, pallas + "flash_attention.py:260",
                      t["launches"]["flash_fwd"], flash["flash_fwd"]),
        "flash_bwd_dq": (flash_src, pallas + "flash_attention.py:453",
                         t["launches"]["flash_bwd_dq"],
                         flash["flash_bwd_dq"]),
        "flash_bwd_dkv": (flash_src, pallas + "flash_attention.py:472",
                          t["launches"]["flash_bwd_dkv"],
                          flash["flash_bwd_dkv"]),
        "moe_dispatch": (moe_src, pallas + "moe_dispatch.py:194",
                         moe_launches("moe_dispatch"), moe["moe_dispatch"]),
        "moe_combine": (moe_src, pallas + "moe_dispatch.py:215",
                        moe_launches("moe_combine"), moe["moe_combine"]),
        "multi_tensor_sqsum": (adam_src, pallas + "fused_optimizer.py:91",
                               tm["launches"]["multi_tensor_sqsum"],
                               adam["multi_tensor_sqsum"]),
        "fused_adam": (adam_src, pallas + "fused_optimizer.py:158",
                       tm["launches"]["fused_adam"], adam["fused_adam"])}

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
