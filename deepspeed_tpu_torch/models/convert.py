"""Carry a JAX Llama or Mixtral parameter tree across to the PyTorch port,
and the port's parameters or gradients back into the JAX tree's layout.

The JAX models (``deepspeed_tpu/models/llama.py`` and ``mixtral.py``,
``init_params``) keep stacked ``[L, ...]`` layers with einsum layouts:
``wq [H, nh, hd]``, ``wo [nh, hd, H]``, ``w_gate [H, I]``, ``lm_head [H,
V]``; Mixtral replaces ``layers.mlp`` with ``layers.moe``: ``wg [L, H, E]``,
``w_gate / w_up [L, E, H, I]``, ``w_down [L, E, I, H]``.  The port keeps one
module per layer with ``nn.Linear`` weights ``[out, in]`` and the expert
stacks in the JAX orientation.  The input is the JAX tree with every leaf
already a numpy array (``jax.device_get``), so this module needs neither JAX
nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a))  # a copy: JAX host arrays are read-only


#: the expert-stacked FFN leaves of a Mixtral layer, in both layouts
MOE_LEAVES = ("wg", "w_gate", "w_up", "w_down")


def llama_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Llama (or Mixtral) pytree of numpy arrays → the port's
    ``state_dict`` (fp32; ``load_state_dict`` casts into the model's
    dtype)."""
    layers = params["layers"]
    attn = layers["attn"]
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
        if "moe" in layers:
            for name in MOE_LEAVES:
                sd[p + name] = _t(layers["moe"][name][i])
        else:
            mlp = layers["mlp"]
            sd[p + "gate_proj.weight"] = _t(np.asarray(mlp["w_gate"][i]).T)
            sd[p + "up_proj.weight"] = _t(np.asarray(mlp["w_up"][i]).T)
            sd[p + "down_proj.weight"] = _t(np.asarray(mlp["w_down"][i]).T)
    if "lm_head" in params:
        sd["lm_head.weight"] = _t(np.asarray(params["lm_head"]).T)
    return sd


def mixtral_params_from_jax(params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """JAX Mixtral pytree → the port's ``state_dict``: the backbone as
    Llama's, ``layers.moe`` split into each layer's ``wg``, ``w_gate``,
    ``w_up`` and ``w_down``."""
    if "moe" not in params["layers"]:
        raise ValueError("not a Mixtral tree: layers has no 'moe'")
    return llama_params_from_jax(params)


def llama_tree_to_jax_layout(tensors: Dict[str, torch.Tensor],
                             num_heads: int, num_kv_heads: int
                             ) -> Dict[str, Any]:
    """The inverse of :func:`llama_params_from_jax`: a ``state_dict``-keyed
    map (parameters, or their gradients) → the JAX tree's nested dict of
    fp32 numpy arrays with stacked ``[L, ...]`` layers (``layers.moe`` for
    a Mixtral map), so the port's per-leaf gradients compare with
    ``jax.grad`` leaf by leaf."""
    def a(name: str) -> np.ndarray:
        return tensors[name].detach().float().cpu().numpy()

    L = 1 + max(int(k.split(".")[1]) for k in tensors
                if k.startswith("layers."))
    H = a("final_norm").shape[0]

    def stack(fn) -> np.ndarray:
        return np.stack([fn(f"layers.{i}.") for i in range(L)])

    def heads(name: str, n: int) -> np.ndarray:  # [n*hd, H] -> [H, n, hd]
        w = a(name).T
        return w.reshape(H, n, w.shape[1] // n)

    tree: Dict[str, Any] = {
        "embed": a("embed.weight"),
        "final_norm": a("final_norm"),
        "layers": {
            "attn_norm": stack(lambda p: a(p + "attn_norm")),
            "mlp_norm": stack(lambda p: a(p + "mlp_norm")),
            "attn": {
                "wq": stack(lambda p: heads(p + "q_proj.weight", num_heads)),
                "wk": stack(lambda p: heads(p + "k_proj.weight",
                                            num_kv_heads)),
                "wv": stack(lambda p: heads(p + "v_proj.weight",
                                            num_kv_heads)),
                # [H, nh*hd] -> [nh, hd, H]
                "wo": stack(lambda p: a(p + "o_proj.weight").T.reshape(
                    num_heads, -1, H)),
            },
        },
    }
    if "layers.0.wg" in tensors:
        tree["layers"]["moe"] = {name: stack(lambda p, n=name: a(p + n))
                                 for name in MOE_LEAVES}
    else:
        tree["layers"]["mlp"] = {
            "w_gate": stack(lambda p: a(p + "gate_proj.weight").T),
            "w_up": stack(lambda p: a(p + "up_proj.weight").T),
            "w_down": stack(lambda p: a(p + "down_proj.weight").T),
        }
    if "lm_head.weight" in tensors:
        tree["lm_head"] = a("lm_head.weight").T
    return tree


def llama_grads_to_jax_layout(model: torch.nn.Module) -> Dict[str, Any]:
    """The gradients in ``model``'s ``.grad`` fields, in the JAX tree's
    layout (a parameter without a gradient reads as zeros)."""
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in model.named_parameters()}
    c = model.config
    return llama_tree_to_jax_layout(grads, c.num_heads, c.num_kv_heads)
