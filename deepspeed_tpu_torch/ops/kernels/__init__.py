"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .block_sparse_attention import (block_sparse_attention,
                                     block_sparse_bwd_dkv,
                                     block_sparse_bwd_dq,
                                     block_sparse_bwd_plain, block_sparse_fwd,
                                     block_sparse_fwd_plain,
                                     block_sparse_kernel_attention)
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
                              paged_decode_attention_plain,
                              paged_decode_attention_tp)
from .quantizer import dequantize_int8, quantize_int8, quantize_int8_plain

__all__ = ["FusedAdamConfig", "MultiTensorPlan", "block_sparse_attention",
           "block_sparse_bwd_dkv", "block_sparse_bwd_dq",
           "block_sparse_bwd_plain", "block_sparse_fwd",
           "block_sparse_fwd_plain", "block_sparse_kernel_attention",
           "combine_reference",
           "decode_attention", "decode_attention_plain", "dequantize_int8",
           "dispatch_reference", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_fwd_plain",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "fused_adam",
           "moe_combine", "moe_combine_fwd", "moe_dispatch",
           "moe_dispatch_fwd", "paged_decode_attention",
           "paged_decode_attention_plain", "paged_decode_attention_tp",
           "quantize_int8", "quantize_int8_plain", "reference_adam",
           "reference_sqsum", "tree_sqsum"]
