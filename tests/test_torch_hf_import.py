"""The port's Hugging Face importers against the JAX package's.

Tiny random HF models (Llama, Mistral, Mixtral, OPT, BERT) are written with
the installed ``transformers`` into a temporary directory, in each format
the port reads: safetensors in fp32 (Llama, BERT) and in bf16 (Mistral), a
sharded safetensors index (Mixtral) and a ``pytorch_model.bin`` (OPT).
Each is loaded by JAX's ``load_hf_*`` (through ``transformers``) and by the
port's (``json`` and its own safetensors reader, no ``transformers``): the
port's state dict equals the JAX tree carried across by
``models/convert.py`` exactly (both are copies of the same stored values),
and the port's model on that state dict gives the HF model's logits within
2e-4 (fp32, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from deepspeed_tpu.models import hf_import as jax_hf
from deepspeed_tpu_torch import models
from deepspeed_tpu_torch.models import hf_import
from torch_parity import free_jax_cycles  # noqa: F401

TOL = 2e-4


def _save(model, path, **kw):
    model.save_pretrained(path, **kw)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name → (directory, HF model class) of five tiny checkpoints."""
    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    small = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64)
    llama = dict(small, intermediate_size=96, num_key_value_heads=2,
                 rms_norm_eps=1e-5, tie_word_embeddings=False)
    out = {}
    m = transformers.LlamaForCausalLM(transformers.LlamaConfig(**llama))
    out["llama"] = (_save(m, root / "llama"), transformers.LlamaForCausalLM)
    m = transformers.MistralForCausalLM(transformers.MistralConfig(
        **llama, sliding_window=16)).to(torch.bfloat16)
    out["mistral"] = (_save(m, root / "mistral"),
                      transformers.MistralForCausalLM)
    m = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **llama, num_local_experts=4, num_experts_per_tok=2))
    out["mixtral"] = (_save(m, root / "mixtral", max_shard_size="200KB"),
                      transformers.MixtralForCausalLM)
    m = transformers.OPTForCausalLM(transformers.OPTConfig(
        **small, ffn_dim=128, word_embed_proj_dim=64,
        do_layer_norm_before=True))
    out["opt"] = (_save(m, root / "opt", safe_serialization=False),
                  transformers.OPTForCausalLM)
    m = transformers.BertForMaskedLM(transformers.BertConfig(
        **small, intermediate_size=128, type_vocab_size=2))
    out["bert"] = (_save(m, root / "bert"), transformers.BertForMaskedLM)
    return out


#: name → (JAX loader, port loader, JAX tree → port state dict, port model)
LOADERS = {
    "llama": (jax_hf.load_hf_llama, hf_import.load_hf_llama,
              models.llama_params_from_jax, models.LlamaModel),
    "mistral": (jax_hf.load_hf_mistral, hf_import.load_hf_mistral,
                models.llama_params_from_jax, models.LlamaModel),
    "mixtral": (jax_hf.load_hf_mixtral, hf_import.load_hf_mixtral,
                models.mixtral_params_from_jax, models.MixtralModel),
    "opt": (jax_hf.load_hf_opt, hf_import.load_hf_opt,
            models.opt_params_from_jax, models.OPTModel),
    "bert": (jax_hf.load_hf_bert, hf_import.load_hf_bert,
             models.bert_params_from_jax, models.BertModel),
}


def test_the_fixture_writes_every_format(checkpoints):
    import os
    files = {name: sorted(os.listdir(path))
             for name, (path, _) in checkpoints.items()}
    assert "model.safetensors" in files["llama"]
    assert "model.safetensors.index.json" in files["mixtral"]
    assert sum(f.endswith(".safetensors") for f in files["mixtral"]) > 1
    assert "pytorch_model.bin" in files["opt"]
    mistral = hf_import.read_safetensors(
        os.path.join(checkpoints["mistral"][0], "model.safetensors"))
    assert {t.dtype for t in mistral.values()} == {torch.bfloat16}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_port_loader_matches_jax_and_hf(checkpoints, name):
    path, hf_cls = checkpoints[name]
    jax_load, port_load, from_jax, model_cls = LOADERS[name]
    jcfg, jparams = jax_load(path, dtype=jnp.float32)
    cfg, sd = port_load(path, dtype=torch.float32)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "max_seq_len"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    want = from_jax(jax.tree.map(np.asarray, jax.device_get(jparams)))
    assert set(sd) == set(want)
    for key, t in want.items():
        np.testing.assert_array_equal(sd[key].float().numpy(), t.numpy(),
                                      err_msg=key)

    model = model_cls(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    ids = np.random.RandomState(5).randint(0, 128, (2, 10))
    hf = hf_cls.from_pretrained(path, torch_dtype=torch.float32,
                                attn_implementation="eager").eval()
    with torch.no_grad():
        want_logits = hf(torch.from_numpy(ids)).logits
        got = model(torch.from_numpy(ids))
    torch.testing.assert_close(got, want_logits, rtol=TOL, atol=TOL)


def test_configs_read_from_config_json(checkpoints):
    cfg, _ = hf_import.load_hf_mistral(checkpoints["mistral"][0])
    assert cfg.sliding_window == 16 and cfg.num_kv_heads == 2
    cfg, _ = hf_import.load_hf_mixtral(checkpoints["mixtral"][0])
    assert (cfg.num_experts, cfg.top_k) == (4, 2)
    cfg, _ = hf_import.load_hf_bert(checkpoints["bert"][0],
                                    attn_impl="flash")
    assert cfg.attn_impl == "flash" and cfg.type_vocab_size == 2
    with pytest.raises(NotImplementedError, match="pre-LN"):
        hf_import.config_from_hf_opt({"do_layer_norm_before": False})
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        hf_import.read_hf_state_dict(str(checkpoints["llama"][0]) + "/..")
