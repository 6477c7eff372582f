"""The one place an entry point turns its ``device`` argument into a
``torch.device``.

Every entry point defaults to ``"cuda"``.  Without a CUDA device that
default raises: the port never falls back to the CPU on its own.  The CPU
is used only when the caller names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested (the default) but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def check_module_device(module: torch.nn.Module, device: torch.device) -> None:
    """Raise unless every parameter of ``module`` lives on ``device``."""
    for name, p in module.named_parameters():
        if p.device.type != device.type or (
                device.index is not None and p.device.index != device.index):
            raise ValueError(f"parameter {name} is on {p.device}, the engine "
                             f"was asked to run on {device}")
