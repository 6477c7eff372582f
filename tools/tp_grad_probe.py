#!/usr/bin/env python3
"""Where a tensor-parallel fp32 step departs from one process's on one
NVIDIA GPU: the first gradient of ``chip_smoke.py``'s ladder agreement
models (``train_tp_ladder_agree``) at tp 2 against one process.

    python3 tools/tp_grad_probe.py [--kinds opt,bert,...] [--seed S]

For each kind it runs one forward and backward of the agreement model on
its batch in this process, then in two gloo ranks on card 0 at tp 2 (the
split leaves joined from the ranks), and prints one JSON line: the loss
and the global grad norm of both, their relative difference, the leaves
with the largest relative gradient difference (with each leaf's share of
the squared norm), and which leaves the rank pair holds differently from
each other.  Needs a CUDA device; ends with the card's name and power
limit.

For OPT (a ReLU MLP) it also records each layer's ``fc_in``
pre-activations in both runs and counts those whose sign differs between
tp 2 and one process (``relu_sign_flips``, with the largest magnitude
among them), then runs the one process again with the tp-2 run's ReLU
mask in place of its own (``same_mask``): if the departure is the ReLU
taking the other branch at those elements, the second comparison closes
to rounding.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class ReluTap:
    """Stands in for ``torch.nn.functional`` inside ``models/opt.py``: its
    ``relu`` records each layer's first pre-activation (fp32, on the host;
    a remat recompute is not recorded again) and, given ``masks`` (layer
    -> bool array), multiplies by the layer's mask instead of taking the
    ReLU's own branch."""

    def __init__(self, masks=None):
        self.masks, self.pre, self.layer = masks, {}, None

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x):
        self.pre.setdefault(self.layer, x.detach().float().cpu().numpy())
        if self.masks is None:
            return torch.nn.functional.relu(x)
        return x * torch.as_tensor(self.masks[self.layer], device=x.device,
                                   dtype=x.dtype)


def tapped(masks=None):
    """A :class:`ReluTap` put in ``models/opt.py``'s ``F``, with
    ``OPTModel.post_attn`` wrapped to name the layer it runs."""
    from deepspeed_tpu_torch.models import opt

    tap = ReluTap(masks)
    post_attn = getattr(opt.OPTModel.post_attn, "untapped",
                        opt.OPTModel.post_attn)

    def named(self, layer, x, attn):
        tap.layer = next(i for i, m in enumerate(self.layers) if m is layer)
        return post_attn(self, layer, x, attn)

    named.untapped = post_attn
    opt.F, opt.OPTModel.post_attn = tap, named
    return tap


def first_grads(kind: str, seed: int, dev, mesh=None, masks=None) -> dict:
    """The loss and every leaf's first gradient (this rank's block of a
    split one) of the agreement model, fp32, TF32 off; for OPT, each
    layer's ``fc_in`` pre-activations (this rank's columns), the ReLU
    taking ``masks`` where given."""
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tap = tapped(masks) if kind == "opt" else None
    model = cs.ladder_agree_model(kind, seed, dev, mesh)
    loss = model.loss(cs.ladder_agree_batch(kind, seed, dev))
    loss.backward()
    return {"loss": float(loss.detach()),
            "grads": {n: p.grad.detach().cpu().numpy()
                      for n, p in model.named_parameters()},
            "dims": {n: (p.ds_tensor.dim if hasattr(p, "ds_tensor")
                         else None) for n, p in model.named_parameters()},
            "pre": tap.pre if tap is not None else {}}


def rank_body(rank: int, kind: str, seed: int) -> dict:
    import chip_smoke as cs
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups

    dev = cs.zero_rank_setup()
    mesh = groups.initialize_mesh(MeshLayout.infer(tp=2))
    return first_grads(kind, seed, dev, mesh)


def sign_flips(one: dict, ranks: list) -> tuple:
    """(per layer: the pre-activations whose sign differs between one
    process and the tp-2 ranks' columns joined, with the largest
    magnitude among them; the tp-2 run's masks)."""
    flips, masks = {}, {}
    for i, pre in one["pre"].items():
        tp = np.concatenate([r["pre"][i] for r in ranks], -1)
        masks[i] = tp > 0
        bad = (pre > 0) != masks[i]
        flips[str(i)] = {"count": int(bad.sum()), "of": int(bad.size),
                         "max_abs": float(np.abs(pre[bad]).max())
                         if bad.any() else 0.0}
    return flips, masks


def compare(kind: str, one: dict, ranks: list, top: int) -> dict:
    joined, unequal = {}, []
    for n, g in ranks[0]["grads"].items():
        d = ranks[0]["dims"][n]
        if d is None:
            if not np.array_equal(g, ranks[1]["grads"][n]):
                unequal.append(n)
            joined[n] = g
        else:
            joined[n] = np.concatenate([r["grads"][n] for r in ranks], d)
    sq = {n: float((g.astype(np.float64) ** 2).sum())
          for n, g in one["grads"].items()}
    total = sum(sq.values())
    total_tp = sum(float((g.astype(np.float64) ** 2).sum())
                   for g in joined.values())
    rel = sorted(((float(np.linalg.norm(joined[n] - g)
                         / max(np.linalg.norm(g), 1e-30)), n)
                  for n, g in one["grads"].items()), reverse=True)
    return {"kind": kind, "loss": one["loss"], "loss_tp2": ranks[0]["loss"],
            "grad_norm": total ** 0.5, "grad_norm_tp2": total_tp ** 0.5,
            "grad_norm_rel": abs(total ** 0.5 - total_tp ** 0.5)
            / total ** 0.5,
            "worst_leaves": [{"leaf": n, "rel": r,
                              "share_of_sq_norm": sq[n] / total}
                             for r, n in rel[:top]],
            "whole_leaves_unequal_across_ranks": unequal}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", default="opt,bert,client,resnet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_grad_probe: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build()
    dev = torch.device("cuda", 0)
    for kind in args.kinds.split(","):
        one = first_grads(kind, args.seed, dev)
        torch.cuda.empty_cache()
        ranks = launch(rank_body, 2, (kind, args.seed), timeout=600)
        out = compare(kind, one, ranks, args.top)
        if kind == "opt":
            out["relu_sign_flips"], masks = sign_flips(one, ranks)
            same = first_grads(kind, args.seed, dev, masks=masks)
            out["same_mask"] = compare(kind, same, ranks, args.top)
        print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
