"""Legacy Ulysses ``DistributedAttention``.

Counterpart of ``deepspeed_tpu/sequence/layer.py`` (the reference's
``deepspeed/sequence/layer.py``: ``_SeqAllToAll`` + ``DistributedAttention``,
the Megatron-DeepSpeed sequence-parallel path): the call shape
``DistributedAttention(local_attn, sp_group)(q, k, v, *args)`` over
:func:`~deepspeed_tpu_torch.runtime.sequence_parallel.ulysses_attention`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..runtime.sequence_parallel.ulysses_sp import ulysses_attention


class DistributedAttention:
    """Seq-scatter → local attention over the full sequence → seq-gather.

    ``local_attn(q, k, v, *args)`` computes attention on ``[B, S, h/sp,
    d]`` blocks; the call takes this rank's ``[B, S/sp, h, d]`` chunks.
    ``sp_group`` defaults to the active mesh's ``seq`` group; at sp 1 this
    is a passthrough."""

    def __init__(self, local_attn: Callable[..., torch.Tensor],
                 sp_group: Any = None,
                 scatter_idx: int = 2, gather_idx: int = 1):
        if (scatter_idx, gather_idx) != (2, 1):
            raise NotImplementedError(
                "only the [B, S, h, d] layout (scatter heads, gather seq) "
                "is supported")
        self.local_attn = local_attn
        self.sp_group = sp_group

    def __call__(self, query: torch.Tensor, key: torch.Tensor,
                 value: torch.Tensor, *args: Any,
                 **kwargs: Any) -> torch.Tensor:
        def attn(q, k, v):
            return self.local_attn(q, k, v, *args, **kwargs)

        return ulysses_attention(attn, query, key, value,
                                 group=self.sp_group)
