#!/usr/bin/env python3
"""Where a training step of BERT-large and of ResNet-56 spends its time on
one NVIDIA GPU (the shapes of ``chip_smoke.py``'s ``train_bert`` and
``train_resnet``).

    python3 tools/ladder_probe.py [--steps N] [--seed S]

For each case (BERT-large ``[8, 512]`` flash with remat on and off, and
ResNet-56 ``[128, 32, 32, 3]``; bf16 on fp32 masters, ZeRO 0) it prints one
JSON line: the median step time of CUDA events after the first step, then
a ``torch.profiler`` trace of two more steps: the device's busy time a step
(the kernels' summed self time), its idle share of the steps' wall, the
kernel launches a step and the five kernels with the most device time.
Needs a CUDA device; ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def bert_case(remat: bool, seed: int):
    from chip_smoke import BERT_BATCH, bert_batch, bert_config, ds_config
    from deepspeed_tpu_torch import BertModel, initialize

    dev = torch.device("cuda", 0)
    model = BertModel(bert_config(remat=remat), device=dev, seed=seed)
    engine, *_ = initialize(model=model, config=ds_config(model, BERT_BATCH),
                            device=dev)
    data = bert_batch(model.config.vocab_size, BERT_BATCH, seed + 1, dev)
    return engine, data


def resnet_case(seed: int):
    from chip_smoke import RESNET_BATCH
    from deepspeed_tpu_torch import ResNetConfig, ResNetModel, initialize

    dev = torch.device("cuda", 0)
    cfg = ResNetConfig.resnet56(dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    engine, *_ = initialize(model=ResNetModel(cfg, device=dev, seed=seed),
                            config={
        "train_micro_batch_size_per_gpu": RESNET_BATCH,
        "steps_per_print": 0, "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    data = {"images": torch.randn(RESNET_BATCH, 32, 32, 3, generator=gen,
                                  device=dev),
            "labels": torch.randint(0, 10, (RESNET_BATCH,), generator=gen,
                                    device=dev)}
    return engine, data


def probe(engine, data, steps: int) -> dict:
    """Median CUDA-event step time over ``steps`` after a first step, then
    the profiler's view of two steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.train_step(data)
    marks = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        engine.train_step(data)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in marks]
    traced = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            engine.train_step(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def device_us(e) -> float:
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:5]
    return {"step_ms": statistics.median(step_ms), "step_ms_all": step_ms,
            "traced_steps": traced, "traced_wall_ms_a_step": wall_ms / traced,
            "device_busy_ms_a_step": busy_ms / traced,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernel_launches_a_step": sum(e.count for e in kernels) / traced,
            "top_kernels": [{"name": e.key[:80],
                             "ms_a_step": device_us(e) / 1e3 / traced,
                             "launches_a_step": e.count / traced}
                            for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ladder_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, make in (("bert_large_remat", lambda: bert_case(True,
                                                              args.seed)),
                       ("bert_large_no_remat", lambda: bert_case(False,
                                                                 args.seed)),
                       ("resnet56", lambda: resnet_case(args.seed))):
        engine, data = make()
        print(json.dumps({"case": name, **probe(engine, data, args.steps)}),
              flush=True)
        del engine, data
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
