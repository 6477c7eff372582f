"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .decode_attention import decode_attention, decode_attention_plain
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_plain)

__all__ = ["decode_attention", "decode_attention_plain",
           "paged_decode_attention", "paged_decode_attention_plain"]
