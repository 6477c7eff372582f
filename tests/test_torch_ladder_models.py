"""The port's BERT, ResNet and OPT against the JAX package, from one init.

* BERT: MLM logits under ``attn_impl`` "xla" and "flash" (JAX's flash runs
  its reference path off the TPU; the port's its plain versions on the
  CPU), the loss and every gradient with pad tails and -100 labels, three
  engine steps against the JAX engine (with gradient accumulation, so
  ``attention_mask`` and ``token_type_ids`` are split with the ids), and
  the port's non-causal flash with pad segments against JAX's Pallas kernel
  in interpret mode;
* ResNet: logits, loss and gradients at ``tiny()`` and at a depth with a
  stacked block, a stride-2 convolution that symmetric padding gets wrong,
  and three engine steps on 4-D images with gradient accumulation;
* OPT: ``forward``, ``prefill`` + ``decode_step`` logits and greedy tokens
  of ``init_inference(...).generate`` against JAX's, and the v2 engine's
  greedy tokens against v1's.

The JAX model draws the weights; ``models/convert.py`` carries them into the
port.  Tolerances: fp32 logits and losses 1e-5 relative (another summation
order), gradients 1e-4 relative with a small absolute floor; bf16 BERT loss
2e-2 relative (the frameworks round activations at other points).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import BertConfig as JaxBertConfig
from deepspeed_tpu.models import BertModel as JaxBertModel
from deepspeed_tpu.models import OPTConfig as JaxOPTConfig
from deepspeed_tpu.models import OPTModel as JaxOPTModel
from deepspeed_tpu.models import ResNetConfig as JaxResNetConfig
from deepspeed_tpu.models import ResNetModel as JaxResNetModel
from deepspeed_tpu.parallel import MeshLayout
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch import KVCacheConfig
from deepspeed_tpu_torch.models import (BertConfig, BertModel, OPTConfig,
                                        OPTModel, ResNetConfig, ResNetModel,
                                        bert_grads_to_jax_layout,
                                        bert_params_from_jax,
                                        bert_tree_to_jax_layout,
                                        opt_params_from_jax,
                                        resnet_grads_to_jax_layout,
                                        resnet_params_from_jax,
                                        resnet_tree_to_jax_layout)
from deepspeed_tpu_torch.models.resnet import same_padding
from torch_parity import free_jax_cycles  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _host(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


def _assert_tree_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=path)


def _jax_engine(jm, params, config):
    mesh = groups.initialize_mesh(MeshLayout.infer(1, dp=1))
    engine, *_ = jdst.initialize(model=jm, model_parameters=params,
                                 config=dict(config), mesh=mesh)
    return engine


# -- BERT ---------------------------------------------------------------------

_BERT_SHARED = ("vocab_size", "hidden_size", "intermediate_size",
                "num_layers", "num_heads", "max_seq_len", "type_vocab_size",
                "layer_norm_eps", "remat", "attn_impl")


def bert_pair(dtype=torch.float32, seed=0, **kw):
    """(JAX BERT, its params, the port's BERT on the CPU with the same
    weights as fp32 masters, computing in ``dtype``)."""
    jcfg = JaxBertConfig.tiny(dtype=JNP[dtype], num_layers=2, **kw)
    jm = JaxBertModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    cfg = BertConfig(dtype=dtype, param_dtype=torch.float32,
                     **{f: getattr(jcfg, f) for f in _BERT_SHARED})
    tm = BertModel(cfg, device="cpu", seed=seed + 1)
    tm.load_state_dict(bert_params_from_jax(_host(params)), strict=True)
    return jm, params, tm


def bert_batch(B, S, seed, pads=(0, 5, 11, 3)):
    """Ids, a per-row pad tail (``pads[b]`` pads; a row without pads
    first), token types 0 then 1, and ~15 % MLM labels (-100 elsewhere and
    on pads)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(B):
        n = pads[b % len(pads)]
        if n:
            mask[b, S - n:] = 0
    types = (np.arange(S)[None, :] >= S // 2).astype(np.int32).repeat(B, 0)
    labels = np.where((rng.rand(B, S) < 0.15) & (mask == 1),
                      rng.randint(0, 512, (B, S)), -100).astype(np.int32)
    labels[:, 0] = np.where(mask[:, 0] == 1, ids[:, 0], -100)  # one a row
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types, "labels": labels}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_bert_logits_match_jax(attn_impl):
    jm, params, tm = bert_pair(attn_impl=attn_impl)
    b = bert_batch(4, 40, 1)
    want = jax.jit(jm.forward)(params, jnp.asarray(b["input_ids"]),
                               jnp.asarray(b["attention_mask"]),
                               jnp.asarray(b["token_type_ids"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(b["input_ids"]),
                 torch.from_numpy(b["attention_mask"]),
                 torch.from_numpy(b["token_type_ids"]))
    assert got.dtype == torch.float32 and got.shape == (4, 40, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bert_impls_differ_only_on_pad_queries():
    """Flash keeps a pad query on the pads, the masked softmax lets it see
    the real keys: the real rows agree, the pad rows do not."""
    _, _, flash = bert_pair(attn_impl="flash")
    _, _, xla = bert_pair(attn_impl="xla")
    b = _port_batch(bert_batch(4, 40, 2))
    with torch.no_grad():
        lf = flash(b["input_ids"], b["attention_mask"], b["token_type_ids"])
        lx = xla(b["input_ids"], b["attention_mask"], b["token_type_ids"])
    real = b["attention_mask"].bool()
    torch.testing.assert_close(lf[real], lx[real], rtol=1e-5, atol=1e-5)
    assert (lf[~real] - lx[~real]).abs().max() > 1e-3


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_bert_loss_and_grads_match_jax(attn_impl, remat):
    jm, params, tm = bert_pair(attn_impl=attn_impl, remat=remat)
    b = bert_batch(3, 32, 3)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, _jax_batch(b))
    loss = tm.loss(_port_batch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_tree_close(bert_grads_to_jax_layout(tm),
                       jax.device_get(want_grads), rtol=1e-4, atol=2e-6)


def test_bert_bf16_flash_loss_matches_jax():
    jm, params, tm = bert_pair(torch.bfloat16, attn_impl="flash")
    b = bert_batch(2, 32, 4)
    want = jm.loss(params, _jax_batch(b))
    got = tm.loss(_port_batch(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


def test_bert_tree_layout_round_trip():
    _, params, tm = bert_pair()
    _assert_tree_close(bert_tree_to_jax_layout(dict(tm.state_dict()), 8),
                       jax.device_get(params), 0, 0)


BERT_ENGINE = {"train_micro_batch_size_per_gpu": 2,
               "gradient_accumulation_steps": 2, "steps_per_print": 0,
               "gradient_clipping": 1.0,
               "optimizer": {"type": "AdamW",
                             "params": {"lr": 2e-3, "weight_decay": 0.01}}}


def test_bert_engine_steps_match_jax():
    """Three steps of 4 rows in two microbatches, under flash: each
    microbatch's ``attention_mask``, ``token_type_ids`` and labels are its
    own rows."""
    jm, params, tm = bert_pair(attn_impl="flash")
    batches = [bert_batch(4, 24, 10 + i) for i in range(3)]
    je = _jax_engine(jm, params, BERT_ENGINE)
    want = [je.train_step(_jax_batch(b)) for b in batches]
    engine, *_ = dst.initialize(model=tm, config=BERT_ENGINE, device="cpu")
    got = [engine.train_step(_port_batch(b)) for b in batches]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([float(m[key]) for m in got],
                                   [float(m[key]) for m in want], rtol=1e-5,
                                   err_msg=key)


def test_bert_flash_pad_segments_match_jax_interpret():
    """The port's flash (plain on the CPU), non-causal with pad segments,
    against JAX's Pallas kernel in interpret mode (out) and JAX's flash
    backward (the gradient)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention

    jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

    rng = np.random.RandomState(5)
    B, S, h, d = 2, 128, 2, 64
    q, k, v, do = (rng.randn(B, S, h, d).astype(np.float32)
                   for _ in range(4))
    seg = np.ones((B, S), np.int32)
    seg[1, S - 37:] = 0  # row 0 has no pads
    want = jfa.flash_attention_interpret(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, 64, 64,
        segment_ids=jnp.asarray(seg))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = flash_attention(*leaves, causal=False,
                          segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # the gradient against jax.vjp of the public function (the Pallas
    # backward does not trace under the interpreter's vjp)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, False, segment_ids=jnp.asarray(seg)),
        *map(jnp.asarray, (q, k, v)))
    got.backward(torch.from_numpy(do))
    for g, w in zip(leaves, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_bert_refuses_random_ltd_and_act_quant():
    _, _, tm = bert_pair()
    ids = torch.zeros(1, 8, dtype=torch.int32)
    tm.ltd_keep = 4
    with pytest.raises(NotImplementedError, match="item 10"):
        tm(ids)
    tm.ltd_keep, tm.act_quant_bits = None, 8
    with pytest.raises(NotImplementedError, match="item 10"):
        tm(ids)


# -- ResNet -------------------------------------------------------------------

def resnet_pair(depth=8, seed=0):
    jcfg = JaxResNetConfig.tiny(depth=depth, dtype=jnp.float32)
    jm = JaxResNetModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = ResNetModel(ResNetConfig.tiny(depth=depth, dtype=torch.float32,
                                       param_dtype=torch.float32),
                     device="cpu", seed=seed + 1)
    tm.load_state_dict(resnet_params_from_jax(_host(params)), strict=True)
    return jm, params, tm


def resnet_batch(B, seed, size=8):
    rng = np.random.RandomState(seed)
    return {"images": rng.randn(B, size, size, 3).astype(np.float32),
            "labels": rng.randint(0, 10, (B,)).astype(np.int32)}


@pytest.mark.parametrize("depth", [8, 14], ids=["tiny", "two_blocks"])
def test_resnet_logits_loss_and_grads_match_jax(depth):
    jm, params, tm = resnet_pair(depth)
    b = resnet_batch(4, depth)
    want = jax.jit(jm.forward)(params, jnp.asarray(b["images"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(b["images"]))
    assert got.shape == (4, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, _jax_batch(b))
    loss = tm.loss(_port_batch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_tree_close(resnet_grads_to_jax_layout(tm),
                       jax.device_get(want_grads), rtol=1e-4, atol=1e-5)
    _assert_tree_close(resnet_tree_to_jax_layout(dict(tm.state_dict())),
                       jax.device_get(params), 0, 0)


def test_stride_two_convolution_pads_as_xla():
    """A 3 x 3 stride-2 convolution of an 8 x 8 input: XLA's "SAME" pads 0
    before and 1 after; padding 1 on each side keeps the shape and moves
    every window by a pixel."""
    from deepspeed_tpu_torch.models.resnet import _conv

    assert same_padding(8, 3, 2) == (0, 1) and same_padding(8, 1, 2) == (0, 0)
    assert same_padding(8, 3, 1) == (1, 1) and same_padding(7, 3, 2) == (1, 1)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 5).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got = _conv(xt, wt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    symmetric = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1)
    assert symmetric.shape == want.shape
    assert np.abs(symmetric.numpy() - want).max() > 1.0


def test_resnet_engine_steps_match_jax():
    """Three Adam steps on 4-D images split into two microbatches."""
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "steps_per_print": 0,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    jm, params, tm = resnet_pair(14)
    batches = [resnet_batch(4, 20 + i) for i in range(3)]
    je = _jax_engine(jm, params, config)
    want = [float(je.train_step(_jax_batch(b))["loss"]) for b in batches]
    engine, *_ = dst.initialize(model=tm, config=config, device="cpu")
    got = [float(engine.train_step(_port_batch(b))["loss"])
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- OPT ----------------------------------------------------------------------

def opt_pair(seed=0, **kw):
    jcfg = JaxOPTConfig.tiny(dtype=jnp.float32, num_layers=2, **kw)
    jm = JaxOPTModel(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    cfg = OPTConfig.tiny(dtype=torch.float32, num_layers=2, **kw)
    tm = OPTModel(cfg, device="cpu", seed=seed + 1)
    tm.load_state_dict(opt_params_from_jax(_host(params)), strict=True)
    return jm, params, tm


def _opt_ids(B, S, seed):
    return np.random.RandomState(seed).randint(0, 512, (B, S)).astype(
        np.int32)


def test_opt_forward_and_loss_match_jax():
    jm, params, tm = opt_pair()
    ids = _opt_ids(2, 20, 1)
    want = jm.forward(params, jnp.asarray(ids))
    got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tm.loss({"input_ids": torch.from_numpy(ids)}).item(),
        float(jm.loss(params, {"input_ids": jnp.asarray(ids)})), rtol=1e-5)
    with pytest.raises(ValueError, match="max_seq_len"):
        tm(torch.zeros(1, 129, dtype=torch.int32))


def test_opt_prefill_decode_and_greedy_tokens_match_jax():
    jm, params, tm = opt_pair()
    ids = _opt_ids(2, 9, 2)
    jcache = jm.init_cache(2, 16)
    jlogits, jcache = jm.prefill(params, jnp.asarray(ids), jcache)
    tcache = tm.init_cache(2, 16)
    tlogits, tcache = tm.prefill(torch.from_numpy(ids), tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for _ in range(4):
        jlogits, jcache = jm.decode_step(params, jcache, jnp.asarray(tok))
        tlogits, tcache = tm.decode_step(tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)

    want = jdst.init_inference(jm, model_params=params,
                               dtype=jnp.float32).generate(
        jnp.asarray(ids), max_new_tokens=6)
    v1 = dst.init_inference(tm, device="cpu").generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(v1.numpy(), np.asarray(want))


def test_opt_v2_tokens_equal_v1():
    """The v2 engine (paged pool, chunked prefill, decode bursts through
    the paged kernel's plain version) gives v1's greedy tokens."""
    _, _, tm = opt_pair()
    prompts = [_opt_ids(1, n, 30 + n)[0] for n in (5, 17, 9)]
    engine = dst.build_engine_v2(
        tm, cache_config=KVCacheConfig(num_blocks=32, block_size=4,
                                       max_seq_len=64),
        max_batch_slots=4, prefill_chunk=8, decode_burst=3, device="cpu")
    assert type(engine.adapter).__name__ == "OPTV2Adapter"
    out = engine.generate([p.tolist() for p in prompts], max_new_tokens=7)
    v1 = dst.init_inference(tm, device="cpu")
    for p, toks in zip(prompts, out):
        want = v1.generate(p[None], max_new_tokens=7)[0, len(p):]
        assert list(toks) == want.tolist()


def test_opt_tensor_parallel_is_refused():
    _, _, tm = opt_pair()
    with pytest.raises(NotImplementedError, match="item 6b"):
        dst.init_inference(tm, tensor_parallel={"tp_size": 2}, device="cpu")
