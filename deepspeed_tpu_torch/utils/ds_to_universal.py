"""ds_to_universal: convert a checkpoint to the universal per-parameter
layout, loadable at any stage and rank count by either package.

Counterpart of ``deepspeed_tpu/utils/ds_to_universal.py`` (``convert``,
``main``), writing the same numpy layout, keyed by the port's parameter
names::

    <out>/zero/<name>/fp32.npy         the fp32 master
    <out>/zero/<name>/exp_avg.npy      Adam's first moment (when saved)
    <out>/zero/<name>/exp_avg_sq.npy   Adam's second moment (when saved)
    <out>/universal_metadata.json      step, source tag, per-name shapes

``runtime/checkpointing.load_universal_checkpoint`` reads it back.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

from deepspeed_tpu_torch.runtime import checkpointing
from deepspeed_tpu_torch.utils.zero_to_fp32 import resolve_tag


def convert(checkpoint_dir: str, output_dir: str,
            tag: Optional[str] = None) -> Dict[str, Any]:
    """Write the universal layout; returns the metadata."""
    tag = resolve_tag(checkpoint_dir, tag)
    tag_dir = os.path.join(checkpoint_dir, tag)
    rank0 = checkpointing.load_rank_states(tag_dir)[0]
    saved = rank0["optimizer"]
    moments = {k: f for k, f in checkpointing.UNIVERSAL_MOMENTS.items()
               if saved["type"] == "Adam" and k in saved["state_names"]}
    zero_dir = os.path.join(output_dir, "zero")
    meta: Dict[str, Any] = {"step": int(saved["count"]), "source_tag": tag,
                            "params": {}}
    for key, fname in [("master", "fp32"), *moments.items()]:
        for name, t in checkpointing.full_tensors(tag_dir, key):
            pdir = os.path.join(zero_dir, name)
            os.makedirs(pdir, exist_ok=True)
            np.save(os.path.join(pdir, fname + ".npy"), t.numpy())
            meta["params"][name] = {"shape": list(t.shape),
                                    "has_moments": bool(moments)}
    with open(os.path.join(output_dir,
                           checkpointing.UNIVERSAL_META), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ds_to_universal",
        description="Convert a saved checkpoint to the universal "
                    "per-parameter fp32 layout")
    ap.add_argument("--input_folder", required=True)
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    meta = convert(args.input_folder, args.output_folder, args.tag)
    print(f"ds_to_universal: wrote {len(meta['params'])} params "
          f"(step {meta['step']}) to {args.output_folder}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
