"""Attention mask construction: the one home for window/causal semantics.

Counterpart of ``deepspeed_tpu/ops/masks.py``.  Causal means
``iq >= ik``; a window W limits reach to ``|iq - ik| < W``, one-sided (past
only) under causality and symmetric for bidirectional use.
"""

from __future__ import annotations

from typing import Optional

import torch


def local_attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """``[..., Sq, Sk]`` boolean mask from position vectors ``[..., Sq]`` and
    ``[Sk]`` (leading dims of ``q_pos`` broadcast)."""
    dq = q_pos[..., :, None]
    dk = k_pos[None, :]
    if causal:
        mask = dq >= dk
    else:
        mask = torch.ones(q_pos.shape + k_pos.shape, dtype=torch.bool,
                          device=q_pos.device)
    if window is not None:
        if causal:
            mask = mask & (dq - dk < window)
        else:
            mask = mask & ((dq - dk).abs() < window)
    return mask
