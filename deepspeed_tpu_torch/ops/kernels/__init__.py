"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain,
                              flash_attention_fwd_plain, flash_bwd_dkv,
                              flash_bwd_dq, flash_fwd)
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_plain)

__all__ = ["decode_attention", "decode_attention_plain", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd_plain", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_fwd", "paged_decode_attention",
           "paged_decode_attention_plain"]
