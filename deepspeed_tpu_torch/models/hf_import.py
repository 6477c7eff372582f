"""Hugging Face checkpoint import: an HF model directory → ``(config,
state_dict)`` of the port's Llama, Mistral, Mixtral, OPT or BERT.

Counterpart of ``deepspeed_tpu/models/hf_import.py``.  The JAX loaders go
through ``transformers.from_pretrained``; this module needs neither
``transformers`` nor ``safetensors``.  It reads ``config.json`` with
:mod:`json` and the weights from

* ``model.safetensors`` or the shards of ``model.safetensors.index.json``,
  with :func:`read_safetensors`: an 8-byte little-endian header length, a
  JSON header naming each tensor's dtype, shape and byte range, then the
  raw buffers, read through ``torch.frombuffer`` (numpy has no bf16);
* else ``pytorch_model.bin`` or the shards of
  ``pytorch_model.bin.index.json``, through ``torch.load(weights_only=
  True)``.

HF keeps ``nn.Linear`` weights ``[out, in]`` per layer, as the port does,
so most entries only change their names.  The tensors keep the
checkpoint's dtype (``load_state_dict`` casts them into the model's);
tied weights that a checkpoint stores once are read from the one it has.
``config_overrides`` are fields of the port's config (``dtype=...``,
``param_dtype=...``, ``attn_impl=...``).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from .bert import BertConfig
from .llama import LlamaConfig
from .mixtral import MixtralConfig
from .opt import OPTConfig

StateDict = Dict[str, torch.Tensor]

#: safetensors dtype names → torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of one ``.safetensors`` file, as CPU tensors that own
    their memory."""
    out: StateDict = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        base = 8 + header_len
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name} has dtype "
                                 f"{info['dtype']}, which is not read")
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
            t = (torch.frombuffer(buf, dtype=dtype) if buf
                 else torch.empty(0, dtype=dtype))
            out[name] = t.reshape(info["shape"])
    return out


def _shards(directory: str, index: str) -> Iterable[str]:
    with open(os.path.join(directory, index)) as f:
        weight_map = json.load(f)["weight_map"]
    return [os.path.join(directory, shard)
            for shard in sorted(set(weight_map.values()))]


def read_hf_state_dict(directory: str) -> StateDict:
    """An HF model directory's weights by HF name: safetensors (one file or
    an index of shards), else ``pytorch_model.bin`` (one file or shards)."""
    def has(name: str) -> bool:
        return os.path.isfile(os.path.join(directory, name))

    if has("model.safetensors"):
        files, read = [os.path.join(directory, "model.safetensors")], \
            read_safetensors
    elif has("model.safetensors.index.json"):
        files, read = _shards(directory, "model.safetensors.index.json"), \
            read_safetensors
    elif has("pytorch_model.bin") or has("pytorch_model.bin.index.json"):
        files = ([os.path.join(directory, "pytorch_model.bin")]
                 if has("pytorch_model.bin")
                 else _shards(directory, "pytorch_model.bin.index.json"))

        def read(path: str) -> StateDict:
            return torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{directory}: no model.safetensors, "
                                "safetensors index or pytorch_model.bin")
    sd: StateDict = {}
    for path in files:
        sd.update(read(path))
    return sd


def read_hf_config(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, "config.json")) as f:
        return json.load(f)


def _getter(hf_config: Any) -> Callable[..., Any]:
    """Uniform key access over an HF config object or a config.json dict."""
    return (hf_config.get if isinstance(hf_config, dict)
            else lambda k, d=None: getattr(hf_config, k, d))


def _first(sd: StateDict, *names: str) -> torch.Tensor:
    """The first of ``names`` that ``sd`` holds (a tied weight may be
    stored under either)."""
    for name in names:
        if name in sd:
            return sd[name]
    raise KeyError(f"none of {names} in the checkpoint")


# -- Llama and Mistral --------------------------------------------------------

def _llama_fields(get: Callable[..., Any]) -> Dict[str, Any]:
    return dict(
        vocab_size=int(get("vocab_size")),
        hidden_size=int(get("hidden_size")),
        intermediate_size=int(get("intermediate_size")),
        num_layers=int(get("num_hidden_layers")),
        num_heads=int(get("num_attention_heads")),
        num_kv_heads=int(get("num_key_value_heads",
                             get("num_attention_heads"))),
        max_seq_len=int(get("max_position_embeddings", 4096)),
        rope_theta=float(get("rope_theta", 10000.0)),
        rms_norm_eps=float(get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(get("tie_word_embeddings", False)))


def config_from_hf(hf_config: Any, **overrides) -> LlamaConfig:
    """A :class:`LlamaConfig` from an HF Llama / Mistral config (object or
    ``config.json`` dict)."""
    get = _getter(hf_config)
    d = _llama_fields(get)
    hd = get("head_dim")
    if hd is not None and int(hd) != d["hidden_size"] // d["num_heads"]:
        d["head_dim"] = int(hd)
    sw = get("sliding_window")
    if sw is not None:
        d["sliding_window"] = int(sw)
    d.update(overrides)
    return LlamaConfig(**d)


def _llama_backbone(sd: StateDict, L: int, tie: bool) -> StateDict:
    """Embedding, attention, norms and head of an HF Llama-family model."""
    out: StateDict = {"embed.weight": sd["model.embed_tokens.weight"],
                      "final_norm": sd["model.norm.weight"]}
    for i in range(L):
        src, dst = f"model.layers.{i}.", f"layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[dst + name + ".weight"] = sd[src + f"self_attn.{name}.weight"]
        out[dst + "attn_norm"] = sd[src + "input_layernorm.weight"]
        out[dst + "mlp_norm"] = sd[src + "post_attention_layernorm.weight"]
    if not tie:
        out["lm_head.weight"] = _first(sd, "lm_head.weight",
                                       "model.embed_tokens.weight")
    return out


def params_from_hf_state_dict(state_dict: StateDict,
                              config: LlamaConfig) -> StateDict:
    """HF ``LlamaForCausalLM`` / ``MistralForCausalLM`` state dict → the
    port's ``LlamaModel`` state dict."""
    out = _llama_backbone(state_dict, config.num_layers,
                          config.tie_embeddings)
    for i in range(config.num_layers):
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[f"layers.{i}.{name}.weight"] = \
                state_dict[f"model.layers.{i}.mlp.{name}.weight"]
    return out


def _load(directory: str, config_fn, params_fn, **overrides
          ) -> Tuple[Any, StateDict]:
    config = config_fn(read_hf_config(directory), **overrides)
    return config, params_fn(read_hf_state_dict(directory), config)


def load_hf_llama(directory: str, **config_overrides
                  ) -> Tuple[LlamaConfig, StateDict]:
    """An HF Llama checkpoint directory → ``(LlamaConfig, state_dict)``."""
    return _load(directory, config_from_hf, params_from_hf_state_dict,
                 **config_overrides)


def load_hf_mistral(directory: str, **config_overrides
                    ) -> Tuple[LlamaConfig, StateDict]:
    """An HF Mistral checkpoint → ``(LlamaConfig with its sliding window,
    state_dict)``; Mistral is served by :class:`LlamaModel`."""
    return _load(directory, config_from_hf, params_from_hf_state_dict,
                 **config_overrides)


# -- Mixtral ------------------------------------------------------------------

def config_from_hf_mixtral(hf_config: Any, **overrides) -> MixtralConfig:
    get = _getter(hf_config)
    d = _llama_fields(get)
    d.update(num_experts=int(get("num_local_experts", 8)),
             top_k=int(get("num_experts_per_tok", 2)))
    d.update(overrides)
    return MixtralConfig(**d)


def params_from_hf_mixtral_state_dict(state_dict: StateDict,
                                      config: MixtralConfig) -> StateDict:
    """HF ``MixtralForCausalLM`` state dict → the port's: the Llama
    backbone, the router ``wg [H, E]`` and the expert stacks in the JAX
    orientation (HF's per-expert ``w1`` / ``w3`` ``[I, H]`` and ``w2``
    ``[H, I]`` are gate / up / down)."""
    c = config
    out = _llama_backbone(state_dict, c.num_layers, c.tie_embeddings)
    for i in range(c.num_layers):
        moe = f"model.layers.{i}.block_sparse_moe."
        out[f"layers.{i}.wg"] = state_dict[moe + "gate.weight"].t()

        def experts(proj: str) -> torch.Tensor:
            return torch.stack([
                state_dict[f"{moe}experts.{e}.{proj}.weight"].t()
                for e in range(c.num_experts)])

        out[f"layers.{i}.w_gate"] = experts("w1")  # [E, H, I]
        out[f"layers.{i}.w_up"] = experts("w3")    # [E, H, I]
        out[f"layers.{i}.w_down"] = experts("w2")  # [E, I, H]
    return out


def load_hf_mixtral(directory: str, **config_overrides
                    ) -> Tuple[MixtralConfig, StateDict]:
    """An HF Mixtral checkpoint → ``(MixtralConfig, state_dict)``."""
    return _load(directory, config_from_hf_mixtral,
                 params_from_hf_mixtral_state_dict, **config_overrides)


# -- OPT ----------------------------------------------------------------------

def config_from_hf_opt(hf_config: Any, **overrides) -> OPTConfig:
    get = _getter(hf_config)
    if get("do_layer_norm_before", True) is False:
        raise NotImplementedError(
            "this OPT implementation is pre-LN; post-LN variants "
            "(do_layer_norm_before=false, e.g. opt-350m) are not supported")
    proj = get("word_embed_proj_dim")
    if proj is not None and int(proj) != int(get("hidden_size")):
        raise NotImplementedError(
            f"word_embed_proj_dim {proj} != hidden_size "
            f"{get('hidden_size')} (project_in/out variants like opt-350m "
            "are not supported)")
    d = dict(vocab_size=int(get("vocab_size")),
             hidden_size=int(get("hidden_size")),
             ffn_dim=int(get("ffn_dim")),
             num_layers=int(get("num_hidden_layers")),
             num_heads=int(get("num_attention_heads")),
             max_seq_len=int(get("max_position_embeddings", 2048)))
    d.update(overrides)
    return OPTConfig(**d)


#: HF OPT layer module → the port's (weights and biases alike)
_OPT_LAYER = {"self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
              "self_attn.v_proj": "v_proj", "self_attn.out_proj": "o_proj",
              "fc1": "fc_in", "fc2": "fc_out"}
#: HF OPT layer norm → the port's weight and bias names
_OPT_NORMS = {"self_attn_layer_norm": ("attn_ln_w", "attn_ln_b"),
              "final_layer_norm": ("mlp_ln_w", "mlp_ln_b")}


def _strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    """``sd`` with ``prefix`` removed where a key has it (``OPTModel`` and
    ``BertModel`` checkpoints lack the task head's wrapper prefix)."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


def params_from_hf_opt_state_dict(state_dict: StateDict,
                                  config: OPTConfig) -> StateDict:
    """HF ``OPTForCausalLM`` state dict → the port's.  HF's position table
    already holds the two legacy rows, as the port's ``pos_embed``."""
    sd = _strip_prefix(_strip_prefix(state_dict, "model."), "decoder.")
    out: StateDict = {
        "embed.weight": _first(sd, "embed_tokens.weight", "lm_head.weight"),
        "pos_embed.weight": sd["embed_positions.weight"],
        "final_ln_w": sd["final_layer_norm.weight"],
        "final_ln_b": sd["final_layer_norm.bias"]}
    for i in range(config.num_layers):
        src, dst = f"layers.{i}.", f"layers.{i}."
        for hf, name in _OPT_LAYER.items():
            for kind in ("weight", "bias"):
                out[f"{dst}{name}.{kind}"] = sd[f"{src}{hf}.{kind}"]
        for hf, (w, b) in _OPT_NORMS.items():
            out[dst + w] = sd[f"{src}{hf}.weight"]
            out[dst + b] = sd[f"{src}{hf}.bias"]
    return out


def load_hf_opt(directory: str, **config_overrides
                ) -> Tuple[OPTConfig, StateDict]:
    """An HF OPT checkpoint → ``(OPTConfig, state_dict)``."""
    return _load(directory, config_from_hf_opt,
                 params_from_hf_opt_state_dict, **config_overrides)


# -- BERT ---------------------------------------------------------------------

def config_from_hf_bert(hf_config: Any, **overrides) -> BertConfig:
    get = _getter(hf_config)
    d = dict(vocab_size=int(get("vocab_size")),
             hidden_size=int(get("hidden_size")),
             intermediate_size=int(get("intermediate_size")),
             num_layers=int(get("num_hidden_layers")),
             num_heads=int(get("num_attention_heads")),
             max_seq_len=int(get("max_position_embeddings", 512)),
             type_vocab_size=int(get("type_vocab_size", 2)),
             layer_norm_eps=float(get("layer_norm_eps", 1e-12)))
    d.update(overrides)
    return BertConfig(**d)


#: HF BERT encoder-layer module → the port's Linear (weight and bias)
_BERT_LAYER = {"attention.self.query": "q_proj",
               "attention.self.key": "k_proj",
               "attention.self.value": "v_proj",
               "attention.output.dense": "o_proj",
               "intermediate.dense": "fc_in", "output.dense": "fc_out"}
#: HF BERT layer norm → the port's post-residual norm names
_BERT_NORMS = {"attention.output.LayerNorm": ("attn_ln_w", "attn_ln_b"),
               "output.LayerNorm": ("mlp_ln_w", "mlp_ln_b")}


def params_from_hf_bert_state_dict(state_dict: StateDict,
                                   config: BertConfig) -> StateDict:
    """HF ``BertForMaskedLM`` state dict → the port's (post-LN: the
    attention output's and the layer output's LayerNorms are the two
    post-residual norms; the MLM decoder is tied to the word embedding and
    keeps its own bias)."""
    sd = _strip_prefix(state_dict, "bert.")
    emb, head = "embeddings.", "cls.predictions."
    out: StateDict = {
        "word_embed.weight": sd[emb + "word_embeddings.weight"],
        "pos_embed.weight": sd[emb + "position_embeddings.weight"],
        "type_embed.weight": sd[emb + "token_type_embeddings.weight"],
        "embed_ln_w": sd[emb + "LayerNorm.weight"],
        "embed_ln_b": sd[emb + "LayerNorm.bias"],
        "mlm_dense.weight": sd[head + "transform.dense.weight"],
        "mlm_dense.bias": sd[head + "transform.dense.bias"],
        "mlm_ln_w": sd[head + "transform.LayerNorm.weight"],
        "mlm_ln_b": sd[head + "transform.LayerNorm.bias"],
        "mlm_bias": _first(sd, head + "bias", head + "decoder.bias")}
    for i in range(config.num_layers):
        src, dst = f"encoder.layer.{i}.", f"layers.{i}."
        for hf, name in _BERT_LAYER.items():
            for kind in ("weight", "bias"):
                out[f"{dst}{name}.{kind}"] = sd[f"{src}{hf}.{kind}"]
        for hf, (w, b) in _BERT_NORMS.items():
            out[dst + w] = sd[f"{src}{hf}.weight"]
            out[dst + b] = sd[f"{src}{hf}.bias"]
    return out


def load_hf_bert(directory: str, **config_overrides
                 ) -> Tuple[BertConfig, StateDict]:
    """An HF BERT masked-LM checkpoint → ``(BertConfig, state_dict)``."""
    return _load(directory, config_from_hf_bert,
                 params_from_hf_bert_state_dict, **config_overrides)

