"""Port ops against the JAX package: the attention mask and the plain
versions of the two decode-attention kernels, fed the same numpy inputs.

Off the TPU the JAX ``decode_attention`` and ``paged_decode_attention``
return their jnp references, which is what the port's plain versions
transcribe; in fp16 the plain versions are also held against the Pallas
kernels in interpret mode.  Tolerances: fp32 1e-5 (same arithmetic, another
summation order); bf16 and fp16 2e-2 (both round q·k and p to the inputs'
dtype, at different places).
The CUDA kernels themselves are held against these plain versions on a card,
by ``test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.masks import local_attention_mask as jax_mask
from deepspeed_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_decode_attention as jax_paged
from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                             decode_attention_plain,
                                             paged_decode_attention,
                                             paged_decode_attention_plain)
from deepspeed_tpu_torch.ops.masks import local_attention_mask
from torch_parity import free_jax_cycles  # noqa: F401

BS, MAX_BLOCKS, H, D = 8, 4, 8, 16
FULL = BS * MAX_BLOCKS
LENGTHS = np.array([1, BS - 1, BS, BS + 1, FULL], np.int32)
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}


def _cast(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _inputs(n_rep: int, seed: int = 0):
    """q [B, h, d]; a dense cache [B, FULL, kv_h, d]; the same keys
    scattered into a pool through a shuffled page table."""
    rng = np.random.RandomState(seed)
    B, kv_h = len(LENGTHS), H // n_rep
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, FULL, kv_h, D).astype(np.float32)
    v = rng.randn(B, FULL, kv_h, D).astype(np.float32)
    n_pages = 1 + B * MAX_BLOCKS
    tables = rng.permutation(np.arange(1, n_pages)).reshape(
        B, MAX_BLOCKS).astype(np.int32)
    k_pool = rng.randn(n_pages, BS, kv_h, D).astype(np.float32)
    v_pool = rng.randn(n_pages, BS, kv_h, D).astype(np.float32)
    for b in range(B):
        for i in range(MAX_BLOCKS):
            k_pool[tables[b, i]] = k[b, i * BS:(i + 1) * BS]
            v_pool[tables[b, i]] = v[b, i * BS:(i + 1) * BS]
    return q, k, v, k_pool, v_pool, tables


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 3])
def test_local_attention_mask_matches_jax(causal, window):
    qp, kp = np.arange(4, 12), np.arange(16)
    want = np.asarray(jax_mask(jnp.asarray(qp), jnp.asarray(kp), causal,
                               window))
    got = local_attention_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                               causal, window).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_decode_attention_plain_matches_jax(n_rep, window, dtype):
    q, k, v, *_ = _inputs(n_rep)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, k, v))
    want = jax_decode(jq, jk, jv, jnp.asarray(LENGTHS), window=window)
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(LENGTHS),
                                 window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_paged_decode_attention_plain_matches_jax(n_rep, window, dtype):
    q, _, _, k_pool, v_pool, tables = _inputs(n_rep, seed=1)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype)
                                    for a in (q, k_pool, v_pool))
    want = jax_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(LENGTHS),
                     window=window)
    got = paged_decode_attention_plain(tq, tk, tv, torch.from_numpy(tables),
                                       torch.from_numpy(LENGTHS), window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("n_rep", [1, 4])
def test_fp16_plain_versions_match_jax_kernels_interpreted(n_rep):
    """fp16 through the Pallas kernels themselves (interpret mode): the
    padded-cache kernel without a window (a window routes JAX to its
    reference) and the paged kernel with and without one."""
    q, k, v, k_pool, v_pool, tables = _inputs(n_rep, seed=5)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, "float16") for a in (q, k, v))
    (jkp, tkp), (jvp, tvp) = (_cast(a, "float16") for a in (k_pool, v_pool))
    lens = torch.from_numpy(LENGTHS)
    tol = TOL["float16"]
    cases = [("decode", decode_attention_plain(tq, tk, tv, lens),
              jax_decode(jq, jk, jv, jnp.asarray(LENGTHS), block_k=BS,
                         interpret=True))]
    for window in (None, 5):
        cases.append((f"paged window={window}",
                      paged_decode_attention_plain(
                          tq, tkp, tvp, torch.from_numpy(tables), lens,
                          window),
                      jax_paged(jq, jkp, jvp, jnp.asarray(tables),
                                jnp.asarray(LENGTHS), interpret=True,
                                window=window)))
    for what, got, want in cases:
        assert got.dtype == torch.float16 and want.dtype == jnp.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=what)


def test_paged_equals_padded_over_the_same_keys():
    """The two plain versions agree when the pool holds the dense cache."""
    q, k, v, k_pool, v_pool, tables = _inputs(4, seed=2)
    t = torch.from_numpy
    lens = t(LENGTHS)
    np.testing.assert_allclose(
        paged_decode_attention_plain(t(q), t(k_pool), t(v_pool), t(tables),
                                     lens, 5).numpy(),
        decode_attention_plain(t(q), t(k), t(v), lens, 5).numpy(),
        rtol=1e-6, atol=1e-6)


def test_wrappers_take_the_plain_path_on_cpu_without_counting():
    q, k, v, k_pool, v_pool, tables = (torch.from_numpy(a)
                                       for a in _inputs(4, seed=3))
    lens = torch.from_numpy(LENGTHS)
    before = (decode_attention.launches, paged_decode_attention.launches)
    torch.testing.assert_close(decode_attention(q, k, v, lens, window=5),
                               decode_attention_plain(q, k, v, lens, 5),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        paged_decode_attention(q, k_pool, v_pool, tables, lens),
        paged_decode_attention_plain(q, k_pool, v_pool, tables, lens),
        rtol=0, atol=0)
    assert (decode_attention.launches,
            paged_decode_attention.launches) == before


def _bad_calls():
    q, k, v, k_pool, v_pool, tables = (torch.from_numpy(a)
                                       for a in _inputs(4, seed=4))
    lens = torch.from_numpy(LENGTHS)
    dec = decode_attention
    pag = paged_decode_attention
    return {
        "fp64": (TypeError, lambda: dec(q.double(), k.double(), v.double(),
                                        lens)),
        "mixed_dtype": (TypeError, lambda: dec(q, k.bfloat16(), v, lens)),
        "q_rank": (ValueError, lambda: dec(q[0], k, v, lens)),
        "kv_shape": (ValueError, lambda: dec(q, k, v[:, :4], lens)),
        "head_dim": (ValueError, lambda: dec(q, k[..., :8], v[..., :8],
                                             lens)),
        "gqa": (ValueError, lambda: dec(q, k[:, :, :1].expand(-1, -1, 3, -1),
                                        v[:, :, :1].expand(-1, -1, 3, -1),
                                        lens)),
        "lengths_dtype": (ValueError, lambda: dec(q, k, v, lens.long())),
        "lengths_shape": (ValueError, lambda: dec(q, k, v, lens[:2])),
        "window": (ValueError, lambda: dec(q, k, v, lens, window=0)),
        "tables_dtype": (ValueError, lambda: pag(q, k_pool, v_pool,
                                                 tables.long(), lens)),
        "tables_rows": (ValueError, lambda: pag(q, k_pool, v_pool,
                                               tables[:2], lens)),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_raise_on_bad_arguments(case):
    exc, call = _bad_calls()[case]
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("seq_cap", [1, 127, 128, 129, 2048, 2049])
def test_decode_split_count_depends_on_the_cache_length_alone(seq_cap):
    """The decode kernels' split-K partition: chunks of ``SPLIT_CHUNK``
    keys at absolute positions, as many as cover the cache.  The count
    must not move with the batch or the heads (a tensor-parallel rank sees
    ``h / tp`` heads and must split as the unsharded call does); those only
    size the workspace."""
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        SPLIT_CHUNK, split_layout)
    want = -(-seq_cap // SPLIT_CHUNK)
    layouts = {(B, h, d): split_layout(B, h, d, seq_cap)
               for B in (1, 4, 8) for h in (4, 16, 32) for d in (64, 128)}
    assert {lay.splits for lay in layouts.values()} == {want}
    assert {lay.chunk for lay in layouts.values()} == {SPLIT_CHUNK}
    for (B, h, d), lay in layouts.items():
        assert lay.partial_floats == B * h * want * (d + 4)
        assert lay.counters == B * h
