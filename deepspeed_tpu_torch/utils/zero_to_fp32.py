"""zero_to_fp32: consolidate a checkpoint's per-rank slices into whole fp32
tensors, with no process group.

Counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py`` (the reference's
script, which every save copies into its save directory).  The JAX
package restores an orbax tree without a mesh; here every rank file of
the tag is read memory-mapped and each leaf's master is assembled from
the slices (``runtime/checkpointing.py`` owns the layout), whatever stage
and rank count saved it:

    python zero_to_fp32.py <checkpoint_dir> <output_file> [--tag TAG]

writes ``{parameter name: fp32 tensor}`` with ``torch.save``.  The copy in
a save directory imports ``deepspeed_tpu_torch``, as the reference's
imports ``deepspeed``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.runtime import checkpointing


def resolve_tag(checkpoint_dir: str, tag: Optional[str]) -> str:
    """``tag``, else ``latest``, else the newest ``global_step*``
    directory; raises when there is none."""
    found = checkpointing.resolve_tag(checkpoint_dir, tag)
    if found is None:
        raise FileNotFoundError(
            f"no global_step* checkpoint under {checkpoint_dir}")
    return found


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None
) -> Dict[str, torch.Tensor]:
    """The port's parameter names to whole fp32 master tensors (host)."""
    tag_dir = f"{checkpoint_dir}/{resolve_tag(checkpoint_dir, tag)}"
    return dict(checkpointing.full_tensors(tag_dir, "master"))


def convert_zero_checkpoint_to_fp32_state_dict(
        checkpoint_dir: str, output_file: str,
        tag: Optional[str] = None) -> Dict[str, torch.Tensor]:
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    torch.save(sd, output_file)
    total = sum(v.numel() for v in sd.values())
    print(f"saved {len(sd)} tensors / {total:,} params to {output_file}")
    return sd


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    a = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(a.checkpoint_dir,
                                               a.output_file, tag=a.tag)


if __name__ == "__main__":
    main()
