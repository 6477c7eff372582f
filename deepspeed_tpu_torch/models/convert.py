"""Carry a JAX Llama parameter tree across to the PyTorch port.

The JAX model (``deepspeed_tpu/models/llama.py``, ``init_params``) keeps
stacked ``[L, ...]`` layers with einsum layouts: ``wq [H, nh, hd]``,
``wo [nh, hd, H]``, ``w_gate [H, I]``, ``lm_head [H, V]``.  The port keeps
one module per layer with ``nn.Linear`` weights ``[out, in]``.  The input is
the JAX tree with every leaf already a numpy array (``jax.device_get``), so
this module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a))  # a copy: JAX host arrays are read-only


def llama_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Llama pytree of numpy arrays → the port's ``state_dict`` (fp32;
    ``load_state_dict`` casts into the model's dtype)."""
    layers = params["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    L, H, nh, hd = np.shape(attn["wq"])
    nkv = np.shape(attn["wk"])[2]
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]),
        "final_norm": _t(params["final_norm"]),
    }
    for i in range(L):
        p = f"layers.{i}."
        sd[p + "attn_norm"] = _t(layers["attn_norm"][i])
        sd[p + "mlp_norm"] = _t(layers["mlp_norm"][i])
        sd[p + "q_proj.weight"] = _t(np.reshape(attn["wq"][i], (H, nh * hd)).T)
        sd[p + "k_proj.weight"] = _t(np.reshape(attn["wk"][i],
                                                (H, nkv * hd)).T)
        sd[p + "v_proj.weight"] = _t(np.reshape(attn["wv"][i],
                                                (H, nkv * hd)).T)
        sd[p + "o_proj.weight"] = _t(np.reshape(attn["wo"][i], (nh * hd, H)).T)
        sd[p + "gate_proj.weight"] = _t(np.asarray(mlp["w_gate"][i]).T)
        sd[p + "up_proj.weight"] = _t(np.asarray(mlp["w_up"][i]).T)
        sd[p + "down_proj.weight"] = _t(np.asarray(mlp["w_down"][i]).T)
    if "lm_head" in params:
        sd["lm_head.weight"] = _t(np.asarray(params["lm_head"]).T)
    return sd
