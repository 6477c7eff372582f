"""The port's flash attention and its tile plan against the JAX package.

* ``ops/kernels/lattice.py`` against ``ops/pallas/lattice.py``: the live
  tile lattice, the k-tile bounds of a q tile, the q-tile bounds of a k
  tile and the in-tile mask, over a grid of (S, tiles, causal, window);
* the forward's ``out`` and ``lse`` against the Pallas kernels in interpret
  mode (the resident ``_flash_call`` and the streamed one) and against
  ``_reference_fwd_with_lse``, with windows and segment ids;
* dq, dk, dv against ``_flash_bwd_pallas`` and ``_flash_bwd_stream`` in
  interpret mode and against ``jax.vjp`` of the public ``flash_attention``.

On the CPU the port's wrappers run the plain versions (the CUDA kernels are
held against those on the card: ``tests/test_torch_kernels.py -m cuda``).
Inputs are numpy draws from a seed.  Tolerances: fp32 2e-5 (the same
arithmetic in another order; the JAX package's own tier), bf16 and fp16
2e-2 (input rounding and p in the inputs' dtype before p·V; every path
accumulates in fp32).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import (flash_attention,
                                             flash_attention_bwd,
                                             flash_attention_bwd_plain,
                                             flash_attention_fwd_plain,
                                             flash_fwd)
from deepspeed_tpu_torch.ops.kernels import lattice as port_lattice

fa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")
jax_lattice = importlib.import_module("deepspeed_tpu.ops.pallas.lattice")

TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


# -- the tile plan ----------------------------------------------------------

LATTICE_GRID = [(S, bq, bk) for S in (128, 256, 512)
                for bq, bk in ((64, 64), (64, 128), (128, 64), (32, 64))
                if S % bq == 0 and S % bk == 0]
WINDOWS = [None, 1, 50, 64, 100, 300]


@pytest.mark.parametrize("S,bq,bk", LATTICE_GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_lattice_and_bounds_match_jax(S, bq, bk, causal):
    nq, nk = S // bq, S // bk
    for window in WINDOWS:
        want = jax_lattice.live_lattice(S, bq, bk, causal, window)
        got = port_lattice.live_lattice(S, bq, bk, causal, window)
        np.testing.assert_array_equal(got, want, err_msg=f"window={window}")
        for qi in range(nq):
            k0, k1 = jax_lattice.kv_block_bounds(qi, bq, bk, nk, causal,
                                                 window)
            assert port_lattice.kv_block_bounds(qi, bq, bk, nk, causal,
                                                window) == (int(k0), int(k1))
        for ki in range(nk):
            q0, q1 = jax_lattice.q_block_bounds(ki, bq, bk, nq, causal,
                                                window)
            assert port_lattice.q_block_bounds(ki, bq, bk, nq, causal,
                                               window) == (int(q0), int(q1))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 5, 70])
def test_tile_keep_matches_jax(causal, window):
    rng = np.random.RandomState(3)
    bq, bk = 64, 32
    for qi, kj in ((0, 0), (1, 2), (3, 1), (2, 5)):
        q_seg = rng.randint(0, 2, bq).astype(np.int32)
        k_seg = rng.randint(0, 2, bk).astype(np.int32)
        for segs in ((None, None), (q_seg, k_seg)):
            want = jax_lattice.tile_keep(
                qi, kj, bq, bk, causal, window,
                *(None if s is None else jnp.asarray(s) for s in segs))
            got = port_lattice.tile_keep(
                qi, kj, bq, bk, causal, window,
                *(None if s is None else torch.from_numpy(s) for s in segs))
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _token_keep(S, causal, window):
    q, k = np.arange(S)[:, None], np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if causal:
        keep &= q >= k
    if window is not None:
        keep &= (q - k < window) if causal else (np.abs(q - k) < window)
    return keep


@pytest.mark.parametrize("S", [1, 63, 65, 200, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lattice_walks_exactly_the_live_tiles(S, causal):
    """Past the JAX lattice (S a multiple of the tile): the kernels' tile
    count rounds up, and their contiguous walks cover exactly the tiles that
    hold a live pair below S."""
    T = port_lattice.TILE
    n = port_lattice.num_tiles(S)
    for window in (None, 1, 40, 129):
        keep = _token_keep(S, causal, window)
        padded = np.zeros((n * T, n * T), bool)
        padded[:S, :S] = keep
        want = padded.reshape(n, T, n, T).any(axis=(1, 3))
        lat = port_lattice.live_lattice(S, T, T, causal, window)
        np.testing.assert_array_equal(lat, want)
        for i in range(n):
            k0, k1 = port_lattice.kv_block_bounds(i, T, T, n, causal, window)
            np.testing.assert_array_equal(np.nonzero(lat[i])[0],
                                          np.arange(k0, k1))
            q0, q1 = port_lattice.q_block_bounds(i, T, T, n, causal, window)
            np.testing.assert_array_equal(np.nonzero(lat[:, i])[0],
                                          np.arange(q0, q1))
        seq_keep = torch.cat([torch.cat([
            port_lattice.tile_keep(i, j, T, T, causal, window, seq_len=S)
            if port_lattice.tile_keep(i, j, T, T, causal, window,
                                      seq_len=S) is not None
            else torch.ones(T, T, dtype=torch.bool)
            for j in range(n)], 1) for i in range(n)], 0)
        np.testing.assert_array_equal(seq_keep.numpy(), padded)
        assert port_lattice.live_pairs(S, causal, window) == keep.sum()


# -- forward and backward against the JAX kernels ----------------------------

def _inputs(B, S, h, d, dtype, seed, with_seg):
    rng = np.random.RandomState(seed)
    arrs = [(rng.randn(B, S, h, d) * 0.5).astype(np.float32)
            for _ in range(4)]
    seg = None
    if with_seg:  # two packed sequences per row, cut at a ragged point
        cut = rng.randint(1, S, size=(B, 1))
        seg = (np.arange(S)[None, :] >= cut).astype(np.int32)
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return (jx, None if seg is None else jnp.asarray(seg),
            tx, None if seg is None else torch.from_numpy(seg))


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol, err_msg=what)


#: (causal, window, segments): the masks the training path and the tests
#: of the JAX package give the kernels
MASKS = {"causal": (True, None, False), "window": (True, 48, False),
         "bidir_window": (False, 70, False), "segments": (True, None, True),
         "bidir": (False, None, False)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_forward_matches_jax_kernels(mask, dtype):
    causal, window, with_seg = MASKS[mask]
    (jq, jk, jv, _), jseg, (q, k, v, _), seg = _inputs(2, 128, 2, 64, dtype,
                                                       11, with_seg)
    out, lse = flash_fwd(q, k, v, causal, window, seg)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    tol = TOL[dtype]
    ref_out, ref_lse = fa._reference_fwd_with_lse(jq, jk, jv, causal, window,
                                                  jseg)
    _close(out, ref_out, tol, "out vs _reference_fwd_with_lse")
    _close(lse, ref_lse, tol, "lse vs _reference_fwd_with_lse")
    paths = [False] if with_seg else [False, True]  # segments: resident only
    for stream in paths:
        k_out, k_lse = fa._flash_call(jq, jk, jv, causal, 64, 64,
                                      interpret=True, with_lse=True,
                                      window=window, segment_ids=jseg,
                                      force_stream=stream)
        _close(out, k_out, tol, f"out vs Pallas (stream={stream})")
        _close(lse, k_lse, tol, f"lse vs Pallas (stream={stream})")
    public = fa.flash_attention_interpret(jq, jk, jv, causal, 64, 64,
                                          window=window, segment_ids=jseg)
    _close(out, public, tol, "out vs flash_attention_interpret")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_backward_matches_jax_kernels(mask, dtype):
    causal, window, with_seg = MASKS[mask]
    (jq, jk, jv, jdo), jseg, (q, k, v, do), seg = _inputs(
        2, 128, 2, 64, dtype, 12, with_seg)
    # both sides start from the same fp32 forward residuals
    j_out, j_lse = fa._reference_fwd_with_lse(jq, jk, jv, causal, window,
                                              jseg)
    out = torch.from_numpy(np.array(j_out.astype(jnp.float32))).to(q.dtype)
    lse = torch.from_numpy(np.array(j_lse))
    got = flash_attention_bwd(q, k, v, out, lse, do, causal, window, seg)
    tol = TOL[dtype]
    wants = {"_flash_bwd_pallas": fa._flash_bwd_pallas(
        jq, jk, jv, j_out, j_lse, jdo, causal, 64, 64, window,
        interpret=True, segment_ids=jseg)}
    if not with_seg:  # the streamed backward takes no segments
        wants["_flash_bwd_stream"] = fa._flash_bwd_stream(
            jq, jk, jv, j_out, j_lse, jdo, causal, 64, 64, window,
            interpret=True)
    for src, want in wants.items():
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == q.dtype
            _close(g, w, tol, f"{name} vs {src}")


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_autograd_matches_jax_vjp(mask):
    """The autograd Function (forward, saved lse, both backward passes)
    against ``jax.vjp`` of the public JAX ``flash_attention``, at an S that
    is not a multiple of the tile."""
    causal, window, with_seg = MASKS[mask]
    (jq, jk, jv, jdo), jseg, (q, k, v, do), seg = _inputs(
        1, 100, 3, 64, "float32", 13, with_seg)
    j_out, vjp = jax.vjp(lambda a, b, c: fa.flash_attention(
        a, b, c, causal, window=window, segment_ids=jseg), jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window,
                          segment_ids=seg)
    out.backward(do)
    _close(out, j_out, 2e-5, "out")
    for name, t, w in zip(("dq", "dk", "dv"), leaves, vjp(jdo)):
        _close(t.grad, w, 2e-5, name)


def test_plain_backward_chunking_is_exact():
    """The chunked plain backward equals one unchunked pass."""
    _, _, (q, k, v, do), seg = _inputs(1, 200, 2, 64, "float32", 14, True)
    out, lse = flash_attention_fwd_plain(q, k, v, True, 90, seg)
    a = flash_attention_bwd_plain(q, k, v, out, lse, do, True, 90, seg,
                                  block_k=64)
    b = flash_attention_bwd_plain(q, k, v, out, lse, do, True, 90, seg,
                                  block_k=200)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_cpu_wrappers_refuse_bad_arguments():
    _, _, (q, k, v, do), _ = _inputs(1, 64, 2, 64, "float32", 15, False)
    with pytest.raises(ValueError, match="one shape"):
        flash_fwd(q, k[:, :32], v)
    with pytest.raises(TypeError, match="dtype"):
        flash_fwd(q, k.double(), v)
    with pytest.raises(ValueError, match="window"):
        flash_fwd(q, k, v, True, 0)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_fwd(q, k, v, True, None, torch.zeros(1, 64, dtype=torch.int64))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 64, 2), do)
