"""Models of the PyTorch port."""

from .bert import BertConfig, BertModel
from .convert import (bert_grads_to_jax_layout, bert_params_from_jax,
                      bert_tree_to_jax_layout, llama_grads_to_jax_layout,
                      llama_params_from_jax, llama_tree_to_jax_layout,
                      mixtral_params_from_jax, opt_params_from_jax,
                      resnet_grads_to_jax_layout, resnet_params_from_jax,
                      resnet_tree_to_jax_layout, shard_llama_params,
                      shard_mixtral_params)
from .hf_import import (load_hf_bert, load_hf_llama, load_hf_mistral,
                        load_hf_mixtral, load_hf_opt)
from .llama import LlamaConfig, LlamaModel
from .mixtral import MixtralConfig, MixtralModel
from .opt import OPTConfig, OPTModel
from .resnet import ResNetConfig, ResNetModel

__all__ = ["BertConfig", "BertModel", "LlamaConfig", "LlamaModel",
           "MixtralConfig", "MixtralModel", "OPTConfig", "OPTModel",
           "ResNetConfig", "ResNetModel", "bert_grads_to_jax_layout",
           "bert_params_from_jax", "bert_tree_to_jax_layout",
           "llama_grads_to_jax_layout", "llama_params_from_jax",
           "llama_tree_to_jax_layout", "load_hf_bert", "load_hf_llama",
           "load_hf_mistral", "load_hf_mixtral", "load_hf_opt",
           "mixtral_params_from_jax", "opt_params_from_jax",
           "resnet_grads_to_jax_layout", "resnet_params_from_jax",
           "resnet_tree_to_jax_layout", "shard_llama_params",
           "shard_mixtral_params"]
