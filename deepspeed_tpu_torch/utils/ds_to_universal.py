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

:func:`convert_jax_universal` carries a universal directory that the JAX
package's ``ds_to_universal`` wrote (the same files, keyed by the JAX
tree's ``/``-joined paths) into the port's names: each of ``fp32``,
``exp_avg`` and ``exp_avg_sq`` is rebuilt as a JAX tree and renamed by the
family's converter in ``models/convert.py`` (Adam's moments are
elementwise, so the parameters' map holds for them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

from deepspeed_tpu_torch.models import convert as model_convert
from deepspeed_tpu_torch.runtime import checkpointing
from deepspeed_tpu_torch.utils.zero_to_fp32 import resolve_tag

#: a JAX model family → its tree-to-``state_dict`` converter
JAX_CONVERTERS = {"llama": model_convert.llama_params_from_jax,
                  "mixtral": model_convert.mixtral_params_from_jax,
                  "bert": model_convert.bert_params_from_jax,
                  "opt": model_convert.opt_params_from_jax,
                  "resnet": model_convert.resnet_params_from_jax}


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


def _unflatten(paths: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` → ``{"a": {"b": {"c": x}}}``."""
    tree: Dict[str, Any] = {}
    for key, arr in paths.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def convert_jax_universal(jax_dir: str, output_dir: str,
                          family: str = "llama") -> Dict[str, Any]:
    """A universal directory of the JAX package (a ``family`` model: one of
    :data:`JAX_CONVERTERS`) → the port's universal layout in
    ``output_dir``; returns the port's metadata.  The moments are carried
    when the JAX directory holds them for every parameter."""
    if family not in JAX_CONVERTERS:
        raise ValueError(f"unknown model family {family!r}: one of "
                         f"{sorted(JAX_CONVERTERS)}")
    with open(os.path.join(jax_dir, checkpointing.UNIVERSAL_META)) as f:
        jmeta = json.load(f)
    moments = all(e.get("has_moments") for e in jmeta["params"].values())
    fnames = ["fp32"] + (list(checkpointing.UNIVERSAL_MOMENTS.values())
                         if moments else [])
    port = {fname: JAX_CONVERTERS[family](_unflatten({
        key: np.load(os.path.join(jax_dir, "zero", key, fname + ".npy"))
        for key in jmeta["params"]})) for fname in fnames}
    meta: Dict[str, Any] = {"step": int(jmeta["step"]),
                            "source_tag": jmeta.get("source_tag"),
                            "params": {}}
    for name, t in port["fp32"].items():
        pdir = os.path.join(output_dir, "zero", name)
        os.makedirs(pdir, exist_ok=True)
        for fname, sd in port.items():
            np.save(os.path.join(pdir, fname + ".npy"), sd[name].numpy())
        meta["params"][name] = {"shape": list(t.shape),
                                "has_moments": moments}
    with open(os.path.join(output_dir, checkpointing.UNIVERSAL_META),
              "w") as f:
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
