"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain,
                              flash_attention_fwd_plain, flash_bwd_dkv,
                              flash_bwd_dq, flash_fwd)
from .fused_adam import (FusedAdamConfig, MultiTensorPlan, fused_adam,
                         reference_adam, reference_sqsum, tree_sqsum)
from .moe_dispatch import (combine_reference, dispatch_reference,
                           moe_combine, moe_combine_fwd, moe_dispatch,
                           moe_dispatch_fwd)
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_plain)

__all__ = ["FusedAdamConfig", "MultiTensorPlan", "combine_reference",
           "decode_attention", "decode_attention_plain",
           "dispatch_reference", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_fwd_plain",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "fused_adam",
           "moe_combine", "moe_combine_fwd", "moe_dispatch",
           "moe_dispatch_fwd", "paged_decode_attention",
           "paged_decode_attention_plain", "reference_adam",
           "reference_sqsum", "tree_sqsum"]
