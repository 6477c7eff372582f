#!/usr/bin/env python3
"""Times the port's one-token decode kernels (#1 ``decode_attention``, #2
``paged_decode_attention``) on one NVIDIA GPU at the shapes the main paths
give them, for one tree of the port and each split-K chunk asked for.

    python3 tools/decode_probe.py [--root DIR] [--chunks 128,256]

``--root`` takes the ``deepspeed_tpu_torch`` package (and builds its
kernels under ``DIR/build``) from another checkout of the repo, such as an
earlier commit unpacked with ``git archive``: run the probe once per tree in
one session on the card to compare two versions of the kernels with the
same inputs and the same timer.  ``--chunks`` sets the decode module's
``SPLIT_CHUNK`` to each value in turn; a tree whose kernels do not split
ignores it.

Shapes (bf16, 32/8 heads, d 128, pages of 16): ``chip_smoke.py``'s timed
one (B 8, every length 2048), a serve decode step (``SERVE_STEP_LENGTHS``
in a 2048-key cache) and v1 ``generate``'s (B 4, 257-288 keys of a 288-key
cache).  Each kernel is held against its plain version at each shape within
2e-2 relative to 1 + |plain|, then timed with ``chip_smoke.py``'s
``time_ms`` (median and range over 7 reps of 30 calls queued behind a GPU
sleep, rotating over three input sets) beside its bound.  Prints the card's
name and power limit, then one JSON line per shape, chunk and kernel.
Exits 1 on a failed check or without a CUDA device.
"""

import argparse
import importlib
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="checkout whose deepspeed_tpu_torch is timed")
    parser.add_argument("--chunks", default="",
                        help="comma-separated SPLIT_CHUNK values to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 decode_attention_plain,
                                                 paged_decode_attention,
                                                 paged_decode_attention_plain)
    module = importlib.import_module(
        "deepspeed_tpu_torch.ops.kernels.decode_attention")
    package = Path(deepspeed_tpu_torch.__file__).resolve()
    if root not in package.parents:
        print(f"decode_probe: imported {package}, not from {root}",
              file=sys.stderr)
        return 1
    op_builder.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cfg = smoke.SLICE
    _, v1_lengths, v1_smax, _ = smoke.CHECKS[1]
    shapes = {"timed": ([cfg["smax"]] * cfg["B"], cfg["smax"]),
              "serve_step": (smoke.SERVE_STEP_LENGTHS, cfg["smax"]),
              "v1": (v1_lengths, v1_smax)}
    kernels = {
        "decode_attention": (
            False, lambda s: decode_attention(s[0], s[1], s[2], s[6]),
            lambda s: decode_attention_plain(s[0], s[1], s[2], s[6])),
        "paged_decode_attention": (
            True, lambda s: paged_decode_attention(*s[:1], *s[3:]),
            lambda s: paged_decode_attention_plain(*s[:1], *s[3:]))}
    kept = getattr(module, "SPLIT_CHUNK", None)
    chunks = ([int(c) for c in args.chunks.split(",") if c]
              if kept is not None else []) or [kept]
    cycles = smoke.sleep_cycles_per_ms()
    try:
        for shape, (lengths, smax) in shapes.items():
            sets = [smoke.make_inputs(torch.bfloat16, lengths, smax, gen,
                                      dev) for _ in range(3)]
            for chunk in chunks:
                if chunk is not None:
                    module.SPLIT_CHUNK = chunk
                for name, (tables, kernel, plain) in kernels.items():
                    err = smoke.check_close(
                        f"{name} {shape} chunk {chunk}", kernel(sets[0]),
                        plain(sets[0]), torch.bfloat16)
                    timed = smoke.time_ms(
                        [lambda s=s: kernel(s) for s in sets], cycles)
                    bound, by = smoke.decode_bound_ms(
                        sets[0][0], sets[0][6], cfg["kv_h"], smax, tables)
                    print(json.dumps(dict(
                        tree=str(root), kernel=name, shape=shape,
                        lengths=lengths, cache=smax, split_chunk=chunk,
                        max_abs_err=err, **timed, bound_ms=bound,
                        bound_by=by)), flush=True)
    except RuntimeError as exc:
        print(f"decode_probe: {exc}", file=sys.stderr)
        return 1
    finally:
        if kept is not None:
            module.SPLIT_CHUNK = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
