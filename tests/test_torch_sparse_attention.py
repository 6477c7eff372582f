"""The port's block-sparse attention against the JAX package.

* the five sparsity configs' layouts and ``block_layout_to_token_mask``, bit
  for bit (BigBird's random cells come from numpy in both);
* the host planning at the JAX function's blocks (``_plan``,
  ``_live_fraction``, ``dense_live_threshold``, the block choice and the
  route) on the shapes ``bench.py`` measures the kernels at;
* the kernels' tile plan: walked row by row and column by column, as the
  CUDA kernels walk it, it gives exactly the token mask;
* the forward's ``out`` and ``lse`` against the Pallas kernels in interpret
  mode (the resident ``_bs_fwd`` and the gather ``_bs_fwd_gather``) and the
  dense path, and dq, dk, dv through the autograd Function against
  ``_sparse_bwd_pallas`` in interpret mode and ``jax.vjp`` of the dense path;
* ``key_padding_mask`` with its gradient.

On the CPU the wrappers run the kernels' plain versions (the CUDA kernels
are held against those on the card: ``tests/test_torch_kernels.py -m
cuda``).  Inputs are numpy draws from a seed.  Tolerances: fp32 2e-5 (the
same arithmetic in another order; the JAX package's own tier), bf16 2e-2.
"""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import (block_sparse_attention,
                                             block_sparse_kernel_attention)

# the packages bind these names to functions, which shadow the modules
jax_sa = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
port_sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
jax_bsa = importlib.import_module(
    "deepspeed_tpu.ops.pallas.block_sparse_attention")
port_bsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.block_sparse_attention")

TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
CONFIGS = ["SparsityConfig", "FixedSparsityConfig", "FixedUnidirectional",
           "BSLongformerSparsityConfig", "BigBirdSparsityConfig",
           "VariableSparsityConfig"]


def _config(module, name, **kw):
    if name == "FixedUnidirectional":
        return module.FixedSparsityConfig(attention="unidirectional", **kw)
    return getattr(module, name)(**kw)


def _both(name, **kw):
    return _config(jax_sa, name, **kw), _config(port_sa, name, **kw)


# -- layouts -----------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("per_head", [False, True])
def test_layouts_and_token_masks_match_jax(name, per_head):
    for S in (256, 1024, 4096):
        for cb in (16, 32, 64, 128):
            want_cfg, got_cfg = _both(name, num_heads=3, block=cb,
                                      different_layout_per_head=per_head)
            want, got = want_cfg.make_layout(S), got_cfg.make_layout(S)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"S {S} cb {cb}")
            if S > 1024:
                continue
            for causal in (False, True):
                np.testing.assert_array_equal(
                    port_sa.block_layout_to_token_mask(got, cb, causal)
                    .numpy(),
                    np.asarray(jax_sa.block_layout_to_token_mask(want, cb,
                                                                 causal)),
                    err_msg=f"S {S} cb {cb} causal {causal}")


# -- host planning and the route ---------------------------------------------

class _Shape:
    """Stands in for q, k, v: the JAX entry reads only their shape before
    it routes."""

    def __init__(self, *shape):
        self.shape = shape


def _bigbird(h, cb, **kw):
    return dict(name="BigBirdSparsityConfig", num_heads=h, block=cb, **kw)


#: (case, (B, S, h, d), config, causal, route): the JAX function's shapes in
#: bench.py, one at Llama-3-8B's attention width, two past the dense limit,
#: and the Fixed layout that is dense at block granularity
ROUTE_CASES = [
    ("train_s4096", (2, 4096, 16, 64), _bigbird(16, 128), True, "kernel"),
    ("cb16_s4096", (1, 4096, 8, 64),
     _bigbird(8, 16, num_random_blocks=2, num_sliding_window_blocks=5),
     False, "kernel"),
    ("cb64_s8192", (1, 8192, 8, 64), _bigbird(8, 64), True, "kernel"),
    ("win3_s8192", (1, 8192, 16, 64),
     _bigbird(16, 128, num_sliding_window_blocks=3), True, "kernel"),
    ("win7_s8192", (1, 8192, 16, 64),
     _bigbird(16, 128, num_sliding_window_blocks=7), True, "kernel"),
    ("win15_s8192", (1, 8192, 16, 64),
     _bigbird(16, 128, num_sliding_window_blocks=15), True, "kernel"),
    ("8b_width_per_head", (1, 8192, 32, 128),
     _bigbird(32, 64, different_layout_per_head=True), True, "kernel"),
    ("bigbird_s32768", (1, 32768, 16, 64), _bigbird(16, 128), True,
     "kernel"),
    ("longformer_s32768", (1, 32768, 16, 64),
     dict(name="BSLongformerSparsityConfig", num_heads=16, block=128), True,
     "kernel"),
    ("fixed_s4096", (1, 4096, 8, 64),
     dict(name="FixedSparsityConfig", num_heads=8, block=16,
          num_local_blocks=4, num_global_blocks=1), False, "dense"),
]


def _jax_route(cfg, shape, causal):
    """What the JAX ``block_sparse_attention`` decides off interpret mode:
    ("dense", None) or ("kernel", (block_q, block_k))."""
    seen = {}
    with mock.patch.object(jax_bsa, "_dense_reference",
                           lambda *a: seen.setdefault("route", "dense")), \
            mock.patch.object(jax_bsa, "_bs_attention",
                              lambda *a: seen.update(route="kernel",
                                                     blocks=a[5:7])):
        jax_bsa.block_sparse_attention(_Shape(*shape), None, None, cfg,
                                       causal, interpret=False)
    return seen["route"], seen.get("blocks")


@pytest.mark.parametrize("case,shape,config,causal,want", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_route_and_plan_match_jax(case, shape, config, causal, want):
    config = dict(config)
    jax_cfg, port_cfg = _both(config.pop("name"), **config)
    B, S, h, d = shape
    cb = jax_cfg.block
    route, blocks = _jax_route(jax_cfg, shape, causal)
    got = port_bsa.config_entry(port_cfg, S, h, causal).route
    assert (got.impl, route) == (want, want)
    layout = jax_bsa._norm_layout(jax_cfg.make_layout(S), h)
    bq, bk = port_bsa.fit_blocks(S, cb)
    if blocks is not None:
        assert (bq, bk) == tuple(blocks)
    assert (got.block_q, got.block_k) == (bq, bk)
    for a, b in zip(port_bsa._plan(layout, S, bq, bk, cb, causal),
                    jax_bsa._plan(layout, S, bq, bk, cb, causal)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _, counts, _ = jax_bsa._plan(layout, S, bq, bk, cb, causal)
    live = jax_bsa._live_fraction(counts, S, bq, bk, causal)
    assert got.live_fraction == live
    assert port_bsa.dense_live_threshold(S) == \
        jax_bsa.dense_live_threshold(S)


# -- the kernels' tile plan ----------------------------------------------------

def _walk(plan, column_major):
    """The token mask the CUDA kernels see: each (head, tile) list walked as
    the kernels walk it, each tile's bits decoded as ``cell_bit`` does, S and
    causality applied as ``keep`` does."""
    T, nt, S, s = 64, plan.nt, plan.S, plan.mask_shift
    ptr, idx, masks = ((plan.col_ptr, plan.row_idx, plan.masks_t)
                       if column_major else
                       (plan.row_ptr, plan.col_idx, plan.masks))
    r = np.arange(T)[:, None]
    c = np.arange(T)[None, :]
    bit = ((r >> s) * (T >> s) + (c >> s)).astype(np.uint64)
    mask = np.zeros((plan.heads, nt * T, nt * T), bool)
    walked = np.zeros((plan.heads, nt, nt), int)
    for hh in range(plan.heads):
        for i in range(nt):
            for e in range(ptr[hh * nt + i], ptr[hh * nt + i + 1]):
                qi, kj = (idx[e], i) if column_major else (i, idx[e])
                words = masks[e].view(np.uint64)
                tile = ((words[(bit >> np.uint64(6)).astype(int)]
                         >> (bit & np.uint64(63))) & np.uint64(1)) == 1
                q_pos, k_pos = qi * T + r, kj * T + c
                tile &= (q_pos < S) & (k_pos < S)
                if plan.causal:
                    tile &= q_pos >= k_pos
                mask[hh, qi * T:(qi + 1) * T, kj * T:(kj + 1) * T] = tile
                walked[hh, qi, kj] += 1
    assert walked.max() <= 1, "a tile is walked twice"
    return mask[:, :S, :S], walked


#: (S, cb): cells from 1 token to 256, the tile exactly, ragged S (272 with
#: cells of 16, 200 of 8) and cells of 200 tokens that straddle tiles
PLAN_GRID = [(256, 1), (256, 2), (256, 4), (256, 8), (272, 16), (512, 32),
             (512, 64), (1024, 128), (1024, 256), (200, 8), (400, 200)]


@pytest.mark.parametrize("S,cb", PLAN_GRID)
@pytest.mark.parametrize("causal", [False, True])
def test_tile_plan_walks_exactly_the_token_mask(S, cb, causal):
    rng = np.random.RandomState(S + cb)
    nb = S // cb
    for heads in (1, 2):
        layout = (rng.rand(heads, nb, nb) < 0.3).astype(np.int32)
        layout[:, -1, :] = 0                      # a row with no live key
        plan = port_bsa.TilePlan(layout, cb, S, causal)
        want = np.asarray(jax_sa.block_layout_to_token_mask(layout, cb,
                                                            causal))
        rows, walked = _walk(plan, column_major=False)
        cols, walked_t = _walk(plan, column_major=True)
        np.testing.assert_array_equal(rows, want)
        np.testing.assert_array_equal(cols, want)
        np.testing.assert_array_equal(walked, walked_t)
        assert plan.live_tiles == walked.sum()
        for order, ptr in ((plan.row_order, plan.row_ptr),
                           (plan.col_order, plan.col_ptr)):
            lengths = np.diff(ptr).reshape(heads, -1)
            for hh, o in enumerate(order.reshape(heads, -1)):
                assert sorted(o) == list(range(plan.nt))  # every tile once
                assert (np.diff(lengths[hh][o]) <= 0).all()  # longest first
        assert list(plan.token_pairs()) == [int(m.sum()) for m in want]


def test_tile_plan_is_compact_where_cells_are_coarse():
    """Cells of 8 tokens or more: one 64-bit word a live tile; cells coarser
    than the tile: every mask whole (the causal diagonal is the kernel's)."""
    cfg = port_sa.BigBirdSparsityConfig(num_heads=2, block=128,
                                        different_layout_per_head=True)
    layout = port_bsa._norm_layout(cfg.make_layout(2048), 2)
    plan = port_bsa.TilePlan(layout, 128, 2048, True)
    assert plan.words == 1 and plan.masks.shape == (plan.live_tiles, 1)
    assert (plan.masks == -1).all()
    fine = port_bsa.TilePlan(port_bsa._norm_layout(
        port_sa.BigBirdSparsityConfig(block=16).make_layout(1024), 1), 16,
        1024, False)
    assert fine.words == 1 and not (fine.masks == -1).all()


# -- forward and backward ------------------------------------------------------

class EmptyTail(jax_sa.FixedSparsityConfig):
    """The JAX test's layout whose last 4 cell rows attend nothing (and
    whose last 4 cell columns nothing attends)."""

    def _head_layout(self, seq_len, head):
        lay = super()._head_layout(seq_len, head)
        lay[-4:, :] = 0
        return lay


#: the JAX package's kernel cases (tests/unit/ops/test_block_sparse.py) and
#: its fully-masked-rows layout; cells of 16, S 256
FWD_CASES = {
    "fixed": (lambda h: jax_sa.FixedSparsityConfig(
        num_heads=h, block=16, num_local_blocks=4), False),
    "fixed_causal": (lambda h: jax_sa.FixedSparsityConfig(
        num_heads=h, block=16, num_local_blocks=4,
        attention="unidirectional"), True),
    "longformer": (lambda h: jax_sa.BSLongformerSparsityConfig(
        num_heads=h, block=16), False),
    "bigbird_perhead": (lambda h: jax_sa.BigBirdSparsityConfig(
        num_heads=h, block=16, different_layout_per_head=True), False),
    "empty_tail": (lambda h: EmptyTail(
        num_heads=h, block=16, num_local_blocks=2, num_global_blocks=0),
        False),
}


def _inputs(B=2, S=256, h=2, d=64, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, d)).astype(np.float32)
            for _ in range(n)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_and_backward_match_pallas_kernels(case):
    make, causal = FWD_CASES[case]
    q, k, v, do = _inputs(B=1, seed=len(case))
    B, S, h, d = q.shape
    cfg = make(h)
    layout = jax_bsa._norm_layout(cfg.make_layout(S), h)
    key = (layout.tobytes(), layout.shape, layout.dtype.str)
    jax_bsa._LAYOUTS[key] = layout
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    j_out, res = jax_bsa._bs_fwd(jq, jk, jv, key, causal, 128, 128, 16, True)
    j_lse = np.asarray(res[4]).reshape(B, h, S)
    j_gather, _ = jax_bsa._bs_fwd_gather(jq, jk, jv, key, causal, 128, 128,
                                         16, True)
    dense = jax_sa.sparse_attention(jq, jk, jv, cfg, causal=causal,
                                    impl="dense")

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    plan = port_bsa.tile_plan(layout, 16, S, causal)
    out, lse = port_bsa.block_sparse_fwd(tq, tk, tv, plan)
    for want, what in ((j_out, "resident"), (j_gather, "gather"),
                       (dense, "dense")):
        _close(out, want, TOL["float32"], f"out vs {what}")
    _close(lse, j_lse, TOL["float32"], "lse")

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = block_sparse_kernel_attention(*leaves, layout, 16, causal)
    _close(got.detach(), j_out, TOL["float32"], "autograd out")
    got.backward(tdo)
    want = jax_bsa._sparse_bwd_pallas(jq, jk, jv, res[3], res[4], jdo,
                                      layout, 16, causal, 128, 128,
                                      interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_sa.sparse_attention(
        a, b, c, cfg, causal=causal, impl="dense"), jq, jk, jv)
    for leaf, w, dw, name in zip(leaves, want, vjp(jdo), "qkv"):
        _close(leaf.grad, w, TOL["float32"], f"d{name} vs _sparse_bwd_pallas")
        _close(leaf.grad, dw, TOL["float32"], f"d{name} vs dense vjp")

    if case == "empty_tail":  # the last 4 cells: no key, and unattended
        assert (out[:, -64:] == 0).all() and (lse[..., -64:] == 1e30).all()
        for leaf in leaves:
            assert (leaf.grad[:, -64:] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_public_entry_matches_jax(causal):
    """``block_sparse_attention`` and ``sparse_attention`` (every impl) on
    the CPU against JAX's, on a layout whose route is the kernels'."""
    q, k, v, do = _inputs(B=1, S=1024, h=2, seed=7)
    mk = dict(num_heads=2, block=64, num_sliding_window_blocks=3,
              global_block_indices=())
    jax_cfg = jax_sa.BSLongformerSparsityConfig(**mk)
    port_cfg = port_sa.BSLongformerSparsityConfig(**mk)
    assert port_bsa.config_entry(port_cfg, 1024, 2, causal).route.impl == \
        "kernel"
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax_bsa.block_sparse_attention(jq, jk, jv, jax_cfg, causal,
                                          interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _close(block_sparse_attention(tq, tk, tv, port_cfg, causal), want,
           TOL["float32"], "block_sparse_attention")
    for impl in ("auto", "dense"):
        _close(port_sa.sparse_attention(tq, tk, tv, port_cfg, causal,
                                        impl=impl), want, TOL["float32"],
               impl)


def _half_forward_and_backward_match_jax_dense(dtype: str) -> None:
    """A per-head BigBird layout, causal, in a 16-bit dtype: the kernel
    Function (its plain versions on the CPU) against JAX's dense path."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v, do = _inputs(B=1, h=4, seed=3)
    cfg_args = dict(num_heads=4, block=32, different_layout_per_head=True)
    jax_cfg = jax_sa.BigBirdSparsityConfig(**cfg_args)
    layout = jax_bsa._norm_layout(jax_cfg.make_layout(256), 4)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    want, vjp = jax.vjp(lambda a, b, c: jax_sa.sparse_attention(
        a, b, c, jax_cfg, causal=True, impl="dense"), jq, jk, jv)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_()
              for x in (q, k, v)]
    got = block_sparse_kernel_attention(*leaves, layout, 32, True)
    assert got.dtype == tdt
    _close(got.detach().float(), want, TOL[dtype], "out")
    got.backward(torch.from_numpy(do).to(tdt))
    for leaf, w, name in zip(leaves, vjp(jdo), "qkv"):
        _close(leaf.grad.float(), w, TOL[dtype], f"d{name}")


def test_bf16_forward_and_backward_match_jax_dense():
    _half_forward_and_backward_match_jax_dense("bfloat16")


def test_fp16_forward_and_backward_match_jax_dense():
    _half_forward_and_backward_match_jax_dense("float16")


def test_key_padding_mask_with_gradient_matches_jax():
    q, k, v, do = _inputs(B=2, h=2, seed=11)
    cfg_args = dict(num_heads=2, block=16, different_layout_per_head=True)
    jax_cfg = jax_sa.BigBirdSparsityConfig(**cfg_args)
    port_cfg = port_sa.BigBirdSparsityConfig(**cfg_args)
    pad = np.ones((2, 256), bool)
    pad[1, 100:] = False                         # batch 1 keeps 100 keys
    pad[0, :] = False                            # batch 0: every row empty
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    want, vjp = jax.vjp(lambda a, b, c: jax_sa.sparse_attention(
        a, b, c, jax_cfg, key_padding_mask=jnp.asarray(pad)), *jargs)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = port_sa.sparse_attention(*leaves, port_cfg,
                                   key_padding_mask=torch.from_numpy(pad))
    _close(got.detach(), want, TOL["float32"], "out")
    assert (got[0] == 0).all()
    got.backward(torch.from_numpy(do))
    for leaf, w, name in zip(leaves, vjp(jnp.asarray(do)), "qkv"):
        _close(leaf.grad, w, TOL["float32"], f"d{name}")
