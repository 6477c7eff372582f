"""Operators of the PyTorch port: masks, block-sparse attention, the CUDA
kernels and their build, and the host ops of offload and ZeRO-Infinity
(:mod:`.adam`: the C++ optimizers; :mod:`.aio`: the file I/O engine)."""

from . import adam, aio, op_builder
from .sparse_attention import (BigBirdSparsityConfig,
                               BSLongformerSparsityConfig,
                               FixedSparsityConfig, SparsityConfig,
                               VariableSparsityConfig,
                               block_layout_to_token_mask, sparse_attention)

__all__ = ["BSLongformerSparsityConfig", "adam", "aio", "op_builder", "BigBirdSparsityConfig",
           "FixedSparsityConfig", "SparsityConfig", "VariableSparsityConfig",
           "block_layout_to_token_mask", "sparse_attention"]
