"""Operators of the PyTorch port: masks, block-sparse attention, the CUDA
kernels and their build."""

from .sparse_attention import (BigBirdSparsityConfig,
                               BSLongformerSparsityConfig,
                               FixedSparsityConfig, SparsityConfig,
                               VariableSparsityConfig,
                               block_layout_to_token_mask, sparse_attention)

__all__ = ["BSLongformerSparsityConfig", "BigBirdSparsityConfig",
           "FixedSparsityConfig", "SparsityConfig", "VariableSparsityConfig",
           "block_layout_to_token_mask", "sparse_attention"]
