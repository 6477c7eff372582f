"""Models of the PyTorch port."""

from .convert import (llama_grads_to_jax_layout, llama_params_from_jax,
                      llama_tree_to_jax_layout)
from .llama import LlamaConfig, LlamaModel

__all__ = ["LlamaConfig", "LlamaModel", "llama_grads_to_jax_layout",
           "llama_params_from_jax", "llama_tree_to_jax_layout"]
