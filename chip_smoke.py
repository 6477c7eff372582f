#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:

1. ``build``    — nvcc builds the kernels from ``deepspeed_tpu_torch/csrc``.
2. ``kernels``  — one line per kernel: the kernel against its plain
   version at every shape the main path gives it (32/8 heads, d 128, pages
   of 16; B 8 over up to 2048 keys with ragged lengths and window None and
   512, as served; B 4 over generate's 256 + 32 keys), bf16 and fp32; then
   timed with CUDA events (calls queued back to back behind a GPU sleep so
   the host's overhead is hidden, median and range over 7 reps, inputs
   rotated over more than the 50 MB L2) beside its plain version, a PyTorch
   library yardstick and its bound (K/V bytes over 3.35 TB/s).
3. ``serve``    — Llama-3-8B at full width and depth (bf16, random weights
   from a seed) behind ``build_serving_frontend``: 8 requests of mixed
   classes, two sharing a 512-token header.  Every handle must return its
   budget, the prefix cache must hit, and the paged kernel must launch
   ``num_layers`` times per decode step.
4. ``generate`` — ``init_inference(...).generate`` on the same weights,
   ``[4, 256]`` prompts, 32 new tokens: ``32 x 31`` decode-kernel launches.
5. ``agree``    — a narrow fp32 model: v2 greedy tokens equal v1 greedy
   tokens (both through the kernels) and the CPU plain path's tokens.

Then a ``kernels`` line, the card's name and power limit, and the result
line.  TF32 is off for matmuls and cuDNN.  Length 0 is not tested: the TPU
kernel gives 0 there and its reference the mean of V; the engines never
pass it (an idle slot attends one key on scratch page 0).
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
    regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                       op_builder.build_log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                         op_builder.build_log)]
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "library": path.name, "kernels_compiled": len(regs),
            "max_registers": max(regs, default=None),
            "max_spill_bytes": max(spills, default=None)}


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


# -- phase 4 ---------------------------------------------------------------

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


# -- phase 5 ---------------------------------------------------------------

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

    sources = {"decode_attention": "deepspeed_tpu/ops/pallas/"
                                   "decode_attention.py:98",
               "paged_decode_attention": "deepspeed_tpu/ops/pallas/"
                                         "paged_attention.py:116"}
    main_path = {"decode_attention": g["launches"]["decode_attention"],
                 "paged_decode_attention": paged}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
         "replaces": sources[name], "launches": main_path[name],
         "max_abs_err": timing[name]["max_abs_err"],
         "ms": timing[name]["kernel_time"]["ms"],
         "plain_ms": timing[name]["plain_time"]["ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": (timing[name]["library_time"] or {}).get("ms")}
        for name in ("decode_attention", "paged_decode_attention")],
        "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
