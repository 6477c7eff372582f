"""Models of the PyTorch port."""

from .convert import llama_params_from_jax
from .llama import LlamaConfig, LlamaModel

__all__ = ["LlamaConfig", "LlamaModel", "llama_params_from_jax"]
