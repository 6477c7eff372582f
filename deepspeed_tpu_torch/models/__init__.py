"""Models of the PyTorch port."""

from .convert import (llama_grads_to_jax_layout, llama_params_from_jax,
                      llama_tree_to_jax_layout, mixtral_params_from_jax)
from .llama import LlamaConfig, LlamaModel
from .mixtral import MixtralConfig, MixtralModel

__all__ = ["LlamaConfig", "LlamaModel", "MixtralConfig", "MixtralModel",
           "llama_grads_to_jax_layout", "llama_params_from_jax",
           "llama_tree_to_jax_layout", "mixtral_params_from_jax"]
