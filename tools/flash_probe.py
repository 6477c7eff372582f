#!/usr/bin/env python3
"""A quick check and timing of the port's flash-attention kernels on one
NVIDIA GPU, for iterating on ``deepspeed_tpu_torch/csrc/flash_attention*.cu``
without the whole of ``chip_smoke.py``.

    python3 tools/flash_probe.py

Builds the kernels, prints each flash kernel family's registers, spill
bytes and tensor-core (``HMMA``) instruction count, holds the forward, dq
and dk/dv kernels against their plain versions in bf16 and fp16 (d 64 and
128; causal, windows, segments, ragged S; the two training shapes) within
2e-2 relative to 1 + |plain|, and times the three kernels at the training
shapes back to back with CUDA events (30 calls after 3 warm-up calls, no
sleep in front: a quick number, not ``chip_smoke.py``'s) beside
``F.scaled_dot_product_attention``.  Exits 1 on a failed check.
"""

import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_fwd_plain, flash_bwd_dkv,
    flash_bwd_dq, flash_fwd)
from deepspeed_tpu_torch.ops.kernels.flash_attention import \
    attention_delta  # noqa: E402

CHECKS = [(2, S, 3, d, causal, window, segs)
          for d in (64, 128)
          for S, causal, window, segs in ((128, True, None, False),
                                          (200, True, None, False),
                                          (200, False, 70, False),
                                          (200, True, 48, True),
                                          (128, False, None, False),
                                          (1000, True, 130, True))]
TIMED = [(8, 2048, 12, 64), (1, 2048, 32, 128)]  # bench.py's, Llama-3-8B's


def report_build() -> None:
    path = op_builder.build()
    fam, regs = None, {}
    for line in op_builder.build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            fam = entry.group(1) if "flash" in entry.group(1) else None
        for pattern, i in ((r"Used (\d+) registers", 0),
                           (r"(\d+) bytes spill stores", 1)):
            found = re.search(pattern, line)
            if found and fam:
                regs.setdefault(fam, [0, 0])[i] = int(found.group(1))
    tool = Path(op_builder.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    hmma, cur = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            cur = fn.group(1) if "flash" in fn.group(1) else None
        elif cur and "HMMA" in line:
            hmma[cur] = hmma.get(cur, 0) + 1
    for name, (r, sp) in sorted(regs.items()):
        print(f"{name}: {r} registers, {sp} spill bytes, "
              f"{hmma.get(name, 0)} HMMA")


def check(gen, dev, B, S, h, d, causal, window, segs, dtype) -> bool:
    q, k, v, do = (torch.randn(B, S, h, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    seg = None
    if segs:
        cuts = torch.randint(1, S, (B, 2), generator=gen, device=dev)
        pos = torch.arange(S, device=dev)
        seg = (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(
            torch.int32).contiguous()
    out, lse = flash_fwd(q, k, v, causal, window, seg)
    want_out, want_lse = flash_attention_fwd_plain(q, k, v, causal, window,
                                                   seg)
    dq = flash_bwd_dq(q, k, v, want_out, want_lse, do, causal, window, seg)
    dk, dv = flash_bwd_dkv(q, k, v, want_out, want_lse, do, causal, window,
                           seg)
    want = flash_attention_bwd_plain(q, k, v, want_out, want_lse, do, causal,
                                     window, seg)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, got, ref in (("out", out, want_out), ("lse", lse, want_lse),
                           ("dq", dq, want[0]), ("dk", dk, want[1]),
                           ("dv", dv, want[2])):
        err = ((got.float() - ref.float()).abs()
               / (1 + ref.float().abs())).max().item()
        errs[name] = round(err, 5)
        ok &= bool(torch.isfinite(got).all()) and err <= 2e-2
    print("ok  " if ok else "FAIL", (B, S, h, d, str(dtype), causal, window,
                                     segs), errs, flush=True)
    return ok


def time_ms(fn, calls: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    report_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for dtype in (torch.bfloat16, torch.float16):
        for case in CHECKS:
            ok &= check(gen, dev, *case, dtype)
    for B, S, h, d in TIMED:
        ok &= check(gen, dev, B, S, h, d, True, None, False, torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float16):
            q, k, v, do = (torch.randn(B, S, h, d, device=dev).to(dtype)
                           for _ in range(4))
            out, lse = flash_fwd(q, k, v, True)
            delta = attention_delta(out, do)
            sdpa = (lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True))
            times = {
                "fwd": time_ms(lambda: flash_fwd(q, k, v, True)),
                "dq": time_ms(lambda: flash_bwd_dq(q, k, v, out, lse, do,
                                                   True, delta=delta)),
                "dkv": time_ms(lambda: flash_bwd_dkv(q, k, v, out, lse, do,
                                                     True, delta=delta)),
                "sdpa_fwd": time_ms(sdpa)}
            print("ms", (B, S, h, d, str(dtype)), times, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
