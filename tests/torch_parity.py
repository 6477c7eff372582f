"""Shared helpers of the ``test_torch_*`` parity tests: build the JAX
reference model and the PyTorch port with the same weights.

The JAX model draws its weights; ``llama_params_from_jax`` carries them into
the port, which runs on the CPU (``device="cpu"``) in the same dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import LlamaModel as JaxLlamaModel
from deepspeed_tpu_torch.models import (LlamaConfig, LlamaModel,
                                        llama_params_from_jax)

_SHARED_FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "max_seq_len", "rope_theta", "rms_norm_eps",
                  "tie_embeddings", "sliding_window")

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                jnp.float16: torch.float16}


def jax_tiny(seed: int = 0, dtype=jnp.float32, **kw):
    """(JAX tiny Llama computing in ``dtype``, default fp32; its params)."""
    cfg = JaxLlamaConfig.tiny(dtype=dtype, **kw)
    model = JaxLlamaModel(cfg)
    return model, model.init_params(jax.random.PRNGKey(seed))


def port_config(jax_cfg) -> LlamaConfig:
    fields = {f: getattr(jax_cfg, f) for f in _SHARED_FIELDS}
    return LlamaConfig(dtype=TORCH_DTYPES[jax_cfg.dtype], **fields)


def port_model(jax_model, params) -> LlamaModel:
    """The port's model on the CPU, holding the JAX model's weights."""
    model = LlamaModel(port_config(jax_model.config), device="cpu")
    host = jax.tree.map(np.asarray, jax.device_get(params))
    model.load_state_dict(llama_params_from_jax(host), strict=True)
    return model
