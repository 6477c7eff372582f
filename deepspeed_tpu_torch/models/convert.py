"""Carry a JAX Llama, Mixtral, BERT, ResNet or OPT parameter tree across to
the PyTorch port, and the port's parameters or gradients back into the JAX
tree's layout.

The JAX models (``deepspeed_tpu/models/llama.py`` and ``mixtral.py``,
``init_params``) keep stacked ``[L, ...]`` layers with einsum layouts:
``wq [H, nh, hd]``, ``wo [nh, hd, H]``, ``w_gate [H, I]``, ``lm_head [H,
V]``; Mixtral replaces ``layers.mlp`` with ``layers.moe``: ``wg [L, H, E]``,
``w_gate / w_up [L, E, H, I]``, ``w_down [L, E, I, H]``.  The port keeps one
module per layer with ``nn.Linear`` weights ``[out, in]`` and the expert
stacks in the JAX orientation.  The input is the JAX tree with every leaf
already a numpy array (``jax.device_get``), so this module needs neither JAX
nor the JAX package.  :func:`shard_llama_params` cuts a whole ``state_dict``
into one tensor-parallel rank's, :func:`shard_mixtral_params` a whole
Mixtral's into one rank's of a tensor and an expert axis.  BERT and OPT
keep JAX's stacked einsum layouts with biases (``bq [L, nh, hd]``, ``w_in
[L, H, I]``); ResNet's convolutions are ``[kh, kw, in, out]`` in JAX and
``[out, in, kh, kw]`` here, each stage's ``first`` block and stacked
``rest`` becoming blocks ``0..n-1``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .llama import is_expert_leaf, split_block, tp_shard


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


def shard_llama_params(state_dict: Dict[str, torch.Tensor], tp: int,
                       rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s ``state_dict`` of a Llama split over ``tp`` ranks:
    every weight that tensor parallelism splits keeps its ``rank``-th
    contiguous block along the split dim (``llama.tp_split_dim``, the JAX
    ``param_specs``: ``P(pipe, None, "tensor", None)`` on ``wq [L, H, nh,
    hd]`` is the heads, dim 0 of ``q_proj.weight``; ``P(pipe, "tensor",
    None, None)`` on ``wo`` is dim 1 of ``o_proj.weight``; ``P(None,
    "tensor")`` on ``lm_head [H, V]`` is dim 0 of ``lm_head.weight``), the
    rest is whole."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} out of range for tp={tp}")
    return {name: tp_shard(name, t, tp, rank)
            for name, t in state_dict.items()}


def shard_mixtral_params(state_dict: Dict[str, torch.Tensor], tp: int,
                         ep: int, tp_rank: int, ep_rank: int
                         ) -> Dict[str, torch.Tensor]:
    """The rank at ``(tp_rank, ep_rank)``'s ``state_dict`` of a Mixtral
    split over ``tp`` tensor and ``ep`` expert ranks (JAX ``param_specs``):
    the backbone as :func:`shard_llama_params`, the expert stacks
    ``ep_rank``'s block of experts (dim 0, ``P(pipe, "expert", ...)``) and
    ``tp_rank``'s block of the FFN dim (``w_gate`` / ``w_up`` dim 2,
    ``w_down`` dim 1); the router is whole."""
    if not (0 <= tp_rank < tp and 0 <= ep_rank < ep):
        raise ValueError(f"rank ({tp_rank}, {ep_rank}) out of range for "
                         f"tp={tp}, ep={ep}")
    out = shard_llama_params(state_dict, tp, tp_rank)
    for name, t in out.items():
        if is_expert_leaf(name):
            out[name] = split_block(t, 0, ep, ep_rank, name)
    return out


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


# -- BERT, ResNet and OPT -----------------------------------------------------

def _heads_t(w: Any) -> torch.Tensor:
    """JAX ``[H, nh, hd]`` → the ``nn.Linear`` weight ``[nh*hd, H]``."""
    a = np.asarray(w)
    return _t(a.reshape(a.shape[0], -1).T)


def _attn_from_jax(sd: Dict[str, torch.Tensor], p: str, attn: Dict[str, Any],
                   i: int) -> None:
    """A layer's biased q/k/v/o projections (BERT and OPT share them)."""
    for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v")):
        sd[p + name + ".weight"] = _heads_t(attn["w" + key][i])
        sd[p + name + ".bias"] = _t(np.asarray(attn["b" + key][i]).reshape(-1))
    wo = np.asarray(attn["wo"][i])
    sd[p + "o_proj.weight"] = _t(wo.reshape(-1, wo.shape[-1]).T)
    sd[p + "o_proj.bias"] = _t(attn["bo"][i])


def _block_from_jax(sd: Dict[str, torch.Tensor], p: str,
                    layers: Dict[str, Any], i: int) -> None:
    """A BERT or OPT layer: attention, the two-matrix MLP, both norms."""
    _attn_from_jax(sd, p, layers["attn"], i)
    mlp = layers["mlp"]
    sd[p + "fc_in.weight"] = _t(np.asarray(mlp["w_in"][i]).T)
    sd[p + "fc_in.bias"] = _t(mlp["b_in"][i])
    sd[p + "fc_out.weight"] = _t(np.asarray(mlp["w_out"][i]).T)
    sd[p + "fc_out.bias"] = _t(mlp["b_out"][i])
    for name in ("attn_ln_w", "attn_ln_b", "mlp_ln_w", "mlp_ln_b"):
        sd[p + name] = _t(layers[name][i])


def bert_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX BERT pytree of numpy arrays → the port's ``state_dict``."""
    e, m, layers = params["embed"], params["mlm"], params["layers"]
    sd: Dict[str, torch.Tensor] = {
        "word_embed.weight": _t(e["word"]),
        "pos_embed.weight": _t(e["position"]),
        "type_embed.weight": _t(e["token_type"]),
        "embed_ln_w": _t(e["ln_w"]), "embed_ln_b": _t(e["ln_b"]),
        "mlm_dense.weight": _t(np.asarray(m["w"]).T),
        "mlm_dense.bias": _t(m["b"]),
        "mlm_ln_w": _t(m["ln_w"]), "mlm_ln_b": _t(m["ln_b"]),
        "mlm_bias": _t(m["bias"]),
    }
    for i in range(np.shape(layers["attn"]["wq"])[0]):
        _block_from_jax(sd, f"layers.{i}.", layers, i)
    return sd


def opt_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX OPT pytree of numpy arrays → the port's ``state_dict``."""
    layers = params["layers"]
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]),
        "pos_embed.weight": _t(params["pos_embed"]),
        "final_ln_w": _t(params["final_ln_w"]),
        "final_ln_b": _t(params["final_ln_b"]),
    }
    for i in range(np.shape(layers["attn"]["wq"])[0]):
        _block_from_jax(sd, f"layers.{i}.", layers, i)
    return sd


#: a ResNet block's leaves in both layouts (the convs change orientation)
RESNET_CONVS = ("conv1", "conv2", "proj")
RESNET_NORMS = ("bn1_s", "bn1_b", "bn2_s", "bn2_b")


def _hwio_to_oihw(w: Any) -> torch.Tensor:
    return _t(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1))))


def resnet_params_from_jax(params: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX ResNet pytree → the port's ``state_dict``: conv weights ``[kh,
    kw, in, out]`` → ``[out, in, kh, kw]``, each stage's ``first`` block
    and its stacked ``rest`` → blocks ``0..n-1``."""
    st = params["stem"]
    sd: Dict[str, torch.Tensor] = {
        "stem_conv": _hwio_to_oihw(st["conv"]),
        "stem_bn_s": _t(st["bn_s"]), "stem_bn_b": _t(st["bn_b"]),
        "head.weight": _t(np.asarray(params["head"]["w"]).T),
        "head.bias": _t(params["head"]["b"]),
    }
    for s in range(3):
        stage = params[f"stage{s + 1}"]
        blocks = [stage["first"]] + [
            {k: v[j] for k, v in stage["rest"].items()}
            for j in range(np.shape(stage["rest"]["conv1"])[0])]
        for j, bp in enumerate(blocks):
            p = f"stages.{s}.{j}."
            for name in RESNET_CONVS:
                if name in bp:
                    sd[p + name] = _hwio_to_oihw(bp[name])
            for name in RESNET_NORMS:
                sd[p + name] = _t(bp[name])
    return sd


def _np_map(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def _grads(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s gradients by parameter name (zeros where none)."""
    return {name: (p.grad if p.grad is not None else torch.zeros_like(p))
            for name, p in model.named_parameters()}


def _block_to_jax(a: Dict[str, np.ndarray], L: int, nh: int
                  ) -> Dict[str, Any]:
    """The inverse of :func:`_block_from_jax`, stacked over ``L`` layers."""
    def stack(fn) -> np.ndarray:
        return np.stack([fn(f"layers.{i}.") for i in range(L)])

    def heads(name: str) -> Any:  # [nh*hd, H] -> [H, nh, hd]
        return lambda p: a[p + name].T.reshape(a[p + name].shape[1], nh, -1)

    attn = {"w" + k: stack(heads(k + "_proj.weight")) for k in "qkv"}
    attn.update({"b" + k: stack(lambda p, k=k: a[p + k + "_proj.bias"]
                                .reshape(nh, -1)) for k in "qkv"})
    attn["wo"] = stack(lambda p: a[p + "o_proj.weight"].T.reshape(
        nh, -1, a[p + "o_proj.weight"].shape[0]))
    attn["bo"] = stack(lambda p: a[p + "o_proj.bias"])
    tree = {"attn": attn, "mlp": {
        "w_in": stack(lambda p: a[p + "fc_in.weight"].T),
        "b_in": stack(lambda p: a[p + "fc_in.bias"]),
        "w_out": stack(lambda p: a[p + "fc_out.weight"].T),
        "b_out": stack(lambda p: a[p + "fc_out.bias"])}}
    for name in ("attn_ln_w", "attn_ln_b", "mlp_ln_w", "mlp_ln_b"):
        tree[name] = stack(lambda p, n=name: a[p + n])
    return tree


def bert_tree_to_jax_layout(tensors: Dict[str, torch.Tensor],
                            num_heads: int) -> Dict[str, Any]:
    """The inverse of :func:`bert_params_from_jax` (parameters or their
    gradients) → the JAX tree of fp32 numpy arrays."""
    a = _np_map(tensors)
    L = 1 + max(int(k.split(".")[1]) for k in a if k.startswith("layers."))
    return {
        "embed": {"word": a["word_embed.weight"],
                  "position": a["pos_embed.weight"],
                  "token_type": a["type_embed.weight"],
                  "ln_w": a["embed_ln_w"], "ln_b": a["embed_ln_b"]},
        "layers": _block_to_jax(a, L, num_heads),
        "mlm": {"w": a["mlm_dense.weight"].T, "b": a["mlm_dense.bias"],
                "ln_w": a["mlm_ln_w"], "ln_b": a["mlm_ln_b"],
                "bias": a["mlm_bias"]},
    }


def bert_grads_to_jax_layout(model: torch.nn.Module) -> Dict[str, Any]:
    """A BERT's ``.grad`` fields in the JAX tree's layout."""
    return bert_tree_to_jax_layout(_grads(model), model.config.num_heads)


def resnet_tree_to_jax_layout(tensors: Dict[str, torch.Tensor]
                              ) -> Dict[str, Any]:
    """The inverse of :func:`resnet_params_from_jax`."""
    a = _np_map(tensors)

    def hwio(w: np.ndarray) -> np.ndarray:
        return np.transpose(w, (2, 3, 1, 0))

    tree: Dict[str, Any] = {
        "stem": {"conv": hwio(a["stem_conv"]), "bn_s": a["stem_bn_s"],
                 "bn_b": a["stem_bn_b"]},
        "head": {"w": a["head.weight"].T, "b": a["head.bias"]},
    }
    for s in range(3):
        n = 1 + max(int(k.split(".")[2]) for k in a
                    if k.startswith(f"stages.{s}."))
        p = f"stages.{s}."
        first = {name: hwio(a[p + "0." + name]) for name in RESNET_CONVS
                 if p + "0." + name in a}
        first.update({name: a[p + "0." + name] for name in RESNET_NORMS})
        # the rest blocks stacked (a leading dim of 0 when there are none)
        shapes = {name: np.shape(first["conv2"]) for name in ("conv1",
                                                              "conv2")}
        shapes.update({name: np.shape(first[name]) for name in RESNET_NORMS})
        rest = {name: np.zeros((n - 1,) + shape, np.float32)
                for name, shape in shapes.items()}
        for j in range(1, n):
            for name in rest:
                w = a[f"{p}{j}.{name}"]
                rest[name][j - 1] = w if name in RESNET_NORMS else hwio(w)
        tree[f"stage{s + 1}"] = {"first": first, "rest": rest}
    return tree


def resnet_grads_to_jax_layout(model: torch.nn.Module) -> Dict[str, Any]:
    """A ResNet's ``.grad`` fields in the JAX tree's layout."""
    return resnet_tree_to_jax_layout(_grads(model))
