"""The CUDA kernels (decode attention, flash attention, MoE dispatch and
combine, the multi-tensor gradient norm and fused Adam, block-sparse
attention) against their plain PyTorch versions.

These tests need an NVIDIA GPU (``-m cuda``) and skip without one: a CUDA
kernel has no CPU mode.  They import no JAX, so they run on a machine that
has only PyTorch and the CUDA toolkit::

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerances: fp32 1e-4 (fp32 arithmetic, another summation order); bf16
and fp16 2e-2 (the plain version rounds q·k and p to the inputs' dtype, the
kernel keeps fp32 or, in the tensor-core attention kernels, rounds p at
other places; dS goes into their products as two 16-bit parts).
Lengths cover 1, bs-1, bs, bs+1, full and past full; n_rep covers the
kernel's head-group splits (1, 2, 3, 4, 8, 12).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import LlamaConfig
from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                             decode_attention_plain,
                                             paged_decode_attention,
                                             paged_decode_attention_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_case(n_rep, d, dtype, seed, device):
    """Ragged lengths (1, bs-1, bs, bs+1, full, past full) over a shuffled
    pool of bs=16 pages, and the dense cache holding the same keys."""
    g = torch.Generator().manual_seed(seed)
    bs, mb, kv_h = 16, 8, 2
    h = kv_h * n_rep
    lens = torch.tensor([1, 15, 16, 17, mb * bs, mb * bs + 5],
                        dtype=torch.int32)
    B = len(lens)
    q = torch.randn(B, h, d, generator=g)
    k = torch.randn(B, mb * bs, kv_h, d, generator=g)
    v = torch.randn(B, mb * bs, kv_h, d, generator=g)
    tables = (torch.randperm(B * mb, generator=g) + 1).reshape(B, mb)
    pool_k = torch.randn(B * mb + 1, bs, kv_h, d, generator=g)
    pool_v = torch.randn(B * mb + 1, bs, kv_h, d, generator=g)
    pool_k[tables.reshape(-1)] = k.reshape(B * mb, bs, kv_h, d)
    pool_v[tables.reshape(-1)] = v.reshape(B * mb, bs, kv_h, d)
    to = dict(device=device, dtype=dtype)
    return (q.to(**to), k.to(**to), v.to(**to), pool_k.to(**to),
            pool_v.to(**to), tables.int().to(device), lens.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("window", [None, 20])
def test_cuda_kernels_match_plain(cuda, n_rep, d, dtype, window):
    q, k, v, pk, pv, tables, lens = _cuda_case(n_rep, d, dtype, n_rep + d,
                                               cuda)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = (decode_attention.launches, paged_decode_attention.launches)
    got = decode_attention(q, k, v, lens, window=window)
    want = decode_attention_plain(q, k, v, lens, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    got = paged_decode_attention(q, pk, pv, tables, lens, window=window)
    want = paged_decode_attention_plain(q, pk, pv, tables, lens, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert (decode_attention.launches - before[0],
            paged_decode_attention.launches - before[1]) == (1, 1)


def _split_case(n_rep, d, dtype, lengths, seed, device, kv_h=2):
    """Sequences of ``lengths`` over a 2048-key cache and the shuffled pool
    (pages of 16) holding the same keys: lengths around the split chunk C
    cross one, two and many splits."""
    g = torch.Generator().manual_seed(seed)
    bs, smax = 16, 2048
    mb, B, h = smax // bs, len(lengths), kv_h * n_rep
    q = torch.randn(B, h, d, generator=g)
    k = torch.randn(B, smax, kv_h, d, generator=g)
    v = torch.randn(B, smax, kv_h, d, generator=g)
    tables = (torch.randperm(B * mb, generator=g) + 1).reshape(B, mb)
    pool_k = torch.randn(B * mb + 1, bs, kv_h, d, generator=g)
    pool_v = torch.randn(B * mb + 1, bs, kv_h, d, generator=g)
    pool_k[tables.reshape(-1)] = k.reshape(B * mb, bs, kv_h, d)
    pool_v[tables.reshape(-1)] = v.reshape(B * mb, bs, kv_h, d)
    to = dict(device=device, dtype=dtype)
    return (q.to(**to), k.to(**to), v.to(**to), pool_k.to(**to),
            pool_v.to(**to), tables.int().to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def _split_lengths():
    from deepspeed_tpu_torch.ops.kernels.decode_attention import SPLIT_CHUNK
    C = SPLIT_CHUNK
    return C, [1, C - 1, C, C + 1, 3 * C + 5, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("window", ["none", "C-3", "C+7"])
def test_cuda_split_k_kernels_match_plain(cuda, n_rep, d, dtype, window):
    """Both decode kernels at lengths that cross 0, 1 and many chunk
    boundaries of the split-K partition, with windows that start inside a
    chunk, against their plain versions; then each sequence alone (B 1,
    where its splits are most of the grid) equals its row of the batch."""
    C, lengths = _split_lengths()
    w = {"none": None, "C-3": C - 3, "C+7": C + 7}[window]
    q, k, v, pk, pv, tables, lens = _split_case(n_rep, d, dtype, lengths,
                                                n_rep * d + C, cuda)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    got = decode_attention(q, k, v, lens, window=w)
    torch.testing.assert_close(
        got.float(), decode_attention_plain(q, k, v, lens, w).float(),
        rtol=tol, atol=tol)
    paged = paged_decode_attention(q, pk, pv, tables, lens, window=w)
    torch.testing.assert_close(
        paged.float(),
        paged_decode_attention_plain(q, pk, pv, tables, lens, w).float(),
        rtol=tol, atol=tol)
    for b in range(len(lengths)):
        one = slice(b, b + 1)
        assert torch.equal(
            decode_attention(q[one], k[one], v[one], lens[one], window=w),
            got[one])
        assert torch.equal(
            paged_decode_attention(q[one], pk, pv, tables[one], lens[one],
                                   window=w), paged[one])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[1, 15, 16, 17, 1000, 2048, 640, 1999],
                                     [257, 270, 287, 288]],
                         ids=["serve", "generate"])
def test_cuda_decode_kernels_at_opt_mha_shape(cuda, dtype, lengths):
    """OPT-1.3B's decode: 32 query heads over 32 kv heads (n_rep 1), head
    dim 64, ragged lengths over a 2048-key cache (served) and generate's B
    4 over 257-288 keys."""
    q, k, v, pk, pv, tables, lens = _split_case(1, 64, dtype, lengths, 64,
                                                cuda, kv_h=32)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        decode_attention(q, k, v, lens).float(),
        decode_attention_plain(q, k, v, lens).float(), rtol=tol, atol=tol)
    torch.testing.assert_close(
        paged_decode_attention(q, pk, pv, tables, lens).float(),
        paged_decode_attention_plain(q, pk, pv, tables, lens).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_unsupported_head_dim(cuda):
    q, k, v, *_, lens = _cuda_case(2, 64, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                         v[..., :32].contiguous(), lens)


# -- flash attention (training): forward, dq pass, dk/dv pass ---------------
#
# Tolerances: fp32 1e-4; bf16 and fp16 2e-2 (16-bit inputs run the
# tensor-core kernels, which round p to the inputs' dtype as an mma operand
# and split dS into two 16-bit parts; the plain forward rounds p, the plain
# backward keeps fp32).
# S 200 leaves a tail tile of 8 rows; the masks cover causal, causal with a
# window, a bidirectional window and packed segments.  S 1000 with a window
# of 130 and segments walks diagonal, window-edge and tail tiles in one
# call.

FLASH_MASKS = {"causal": (True, None, False), "window": (True, 48, False),
               "bidir_window": (False, 70, False),
               "segments": (True, None, True), "bidir": (False, None, False)}


def _flash_case(B, S, h, d, dtype, seed, device, with_seg):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, h, d, generator=g) for _ in range(4))
    seg = None
    if with_seg:  # two packed sequences per row, split at a ragged point
        cut = torch.randint(1, S, (B, 1), generator=g)
        seg = (torch.arange(S)[None, :] >= cut).to(torch.int32).to(device)
    to = dict(device=device, dtype=dtype)
    return q.to(**to), k.to(**to), v.to(**to), do.to(**to), seg


def _flash_check(q, k, v, do, seg, causal, window, tol):
    """The three kernels against their plain versions on one input."""
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain,
                                                 flash_bwd_dkv, flash_bwd_dq,
                                                 flash_fwd)
    out, lse = flash_fwd(q, k, v, causal, window, seg)
    want_out, want_lse = flash_attention_fwd_plain(q, k, v, causal, window,
                                                   seg)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    dq = flash_bwd_dq(q, k, v, want_out, want_lse, do, causal, window, seg)
    dk, dv = flash_bwd_dkv(q, k, v, want_out, want_lse, do, causal, window,
                           seg)
    want = flash_attention_bwd_plain(q, k, v, want_out, want_lse, do, causal,
                                     window, seg)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("S", [128, 200])
@pytest.mark.parametrize("mask", sorted(FLASH_MASKS))
def test_cuda_flash_kernels_match_plain(cuda, dtype, d, S, mask):
    from deepspeed_tpu_torch.ops.kernels import (flash_bwd_dkv, flash_bwd_dq,
                                                 flash_fwd)
    causal, window, with_seg = FLASH_MASKS[mask]
    q, k, v, do, seg = _flash_case(2, S, 3, d, dtype, S + d, cuda, with_seg)
    before = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    _flash_check(q, k, v, do, seg, causal, window,
                 1e-4 if dtype == torch.float32 else 2e-2)
    torch.cuda.synchronize()
    assert (flash_fwd.launches - before[0], flash_bwd_dq.launches - before[1],
            flash_bwd_dkv.launches - before[2]) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_diagonal_window_edge_and_tail_tiles(cuda, dtype, d):
    """S 1000 (a tail tile of 40 rows), a window of 130 (two window-edge
    tiles a row of tiles) and three packed segments (every tile masked)."""
    q, k, v, do, _ = _flash_case(2, 1000, 2, d, dtype, 1000 + d, cuda, False)
    seg = torch.zeros(2, 1000, dtype=torch.int32)
    seg[0, 311:] += 1
    seg[0, 650:] += 1
    seg[1, 77:] += 1
    seg[1, 900:] += 1
    _flash_check(q, k, v, do, seg.to(cuda), True, 130,
                 1e-4 if dtype == torch.float32 else 2e-2)


def _pad_tails(B, S, seed, max_pad=200):
    """BERT's padding as segment ids: 1 on real tokens, 0 on a pad tail of
    0 to ``max_pad`` tokens a row (row 0 has none)."""
    g = torch.Generator().manual_seed(seed)
    pads = torch.randint(0, max_pad + 1, (B,), generator=g)
    pads[0] = 0
    return (torch.arange(S)[None, :] < S - pads[:, None]).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_flash_bert_pad_tails(cuda, dtype):
    """BERT-large's attention (S 512, d 64; B 4 and 4 heads here),
    non-causal with a pad tail a row as segments."""
    q, k, v, do, _ = _flash_case(4, 512, 4, 64, dtype, 512, cuda, False)
    seg = _pad_tails(4, 512, 3).to(cuda)
    _flash_check(q, k, v, do, seg, False, None,
                 1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_flash_bert_random_out(cuda, dtype, seed):
    """The backward passes at BERT-large's full attention shape (B 8, h
    16, S 512, d 64, pad tails) on a random ``out`` and lse = |N(0, 1)| +
    3: P = exp(s - lse) reaches ~15 there, and one 16-bit rounding of P in
    dV += Pᵀ·dO put dv past 2e-2 of the fp32 backward (ROADMAP Queue 3)."""
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                 flash_bwd_dkv, flash_bwd_dq)
    q, k, v, do, _ = _flash_case(8, 512, 16, 64, dtype, 100 + seed, cuda,
                                 False)
    seg = _pad_tails(8, 512, seed).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    lse = torch.randn(8, 16, 512, generator=gen, device=cuda).abs() + 3.0
    dq = flash_bwd_dq(q, k, v, out, lse, do, False, None, seg)
    dk, dv = flash_bwd_dkv(q, k, v, out, lse, do, False, None, seg)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, False, None, seg)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        print(f"{name}: share of the bound {_of_bound(got, ref, 2e-2):.3f}")
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2, msg=name)


# The backward passes on saved statistics that no forward of these inputs
# gives: a random ``out`` (so delta = rowsum(dO∘out) is as large as dP, and
# dS = P (dP − delta) is large where it does not cancel), lse = |N(0, 1)|
# + 3 and five dead rows at lse 1e30.  Every tensor is drawn from a seeded
# generator on the card, so a seed gives the same inputs in every run.
REGIME_SEEDS = list(range(12))
REGIME_S, REGIME_H = 640, 2


def _regime_case(d, dtype, seed, device):
    """q, k, v, do, out ``[1, S, 2, d]``, lse ``[1, 2, S]`` and the dead
    rows, all from ``torch.Generator(device).manual_seed(seed)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    S, h = REGIME_S, REGIME_H
    q, k, v, do, out = (torch.randn(1, S, h, d, generator=gen,
                                    device=device).to(dtype)
                        for _ in range(5))
    lse = torch.randn(1, h, S, generator=gen, device=device).abs() + 3.0
    dead = torch.zeros(S, dtype=torch.bool, device=device)
    dead[[0, 63, 64, 300, S - 1]] = True
    lse[..., dead] = 1e30
    return q, k, v, do, out, lse, dead


def _bwd_ds_rounded(q, k, v, out, lse, do, mask):
    """The plain backward (fp32; ``p = exp(s·scale − lse)`` on the live
    pairs of the bool ``mask [B|1, h|1, S, S]``, ``ds = p (dp − delta)``)
    with ds rounded to q's dtype before ``ds·K`` and ``dsᵀ·Q``, as a 16-bit
    mma operand rounds it: the emulation of a kernel that does so."""
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    delta = torch.einsum("bqhd,bqhd->bhq", do32, out.float())
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype)


def _of_bound(got, ref, tol) -> float:
    """The largest ``|got − ref| / (tol (1 + |ref|))``: above 1 fails."""
    ref = ref.float()
    return ((got.float() - ref).abs() / (tol * (1 + ref.abs()))).max().item()


def _hold_regime(what, got, want, emulated, tol):
    """Each of dq, dk, dv within ``tol`` of the plain backward's; prints
    each one's share of its bound beside that of the ds-rounded emulation
    (dq, dk), which names the rounding point when the kernel follows it."""
    shares = {}
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want,
                             (*emulated, None)):
        shares[name] = (_of_bound(g, w, tol),
                        None if e is None else _of_bound(e, w, tol))
    print(f"{what}: share of the bound (kernel, ds-rounded plain) "
          f"{shares}")
    for (name, (kernel, emulation)), g, w in zip(shares.items(), got, want):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=tol, atol=tol,
            msg=f"{what}: {name} at {kernel:.3f} of its bound {tol} x (1 + "
                f"|plain|); the plain backward with ds rounded to the "
                f"inputs' dtype is at {emulation}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seed", REGIME_SEEDS)
def test_cuda_flash_rows_without_live_keys(cuda, dtype, d, seed):
    """Every query sees itself, so no row of the forward is without a live
    key in all; but under causal segments a row meets no live key in its
    first walked tiles (the running max stays -inf there), and the forward
    gives a row that has none out 0 and lse 1e30, which the backward passes
    must read as a row that contributes nothing.  Then the backward passes
    on the random-``out`` regime above."""
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                 flash_bwd_dkv, flash_bwd_dq)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    S = REGIME_S
    q, k, v, do, out, lse, dead = _regime_case(d, dtype, seed, cuda)
    seg = torch.zeros(1, S, dtype=torch.int32, device=cuda)
    seg[0, 520:] = 1  # rows 520.. walk 8 tiles with no key of their segment
    _flash_check(q, k, v, do, seg, True, None, tol)
    dq = flash_bwd_dq(q, k, v, out, lse, do, True)
    dk, dv = flash_bwd_dkv(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert (dq[:, dead] == 0).all()
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    causal = torch.ones(S, S, dtype=torch.bool, device=cuda).tril()
    _hold_regime(f"flash {dtype} d {d} seed {seed}", (dq, dk, dv), want,
                 _bwd_ds_rounded(q, k, v, out, lse, do, causal), tol)


@pytest.mark.cuda
def test_cuda_flash_autograd_matches_plain(cuda):
    """The autograd Function on the card against plain autograd."""
    from deepspeed_tpu_torch.ops.kernels import (flash_attention,
                                                 flash_attention_fwd_plain)
    q, k, v, do, _ = _flash_case(2, 96, 2, 64, torch.float32, 7, cuda, False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, causal=True, window=40).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_fwd_plain(*ref, True, 40)[0].backward(do)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_refuses_unsupported_head_dim(cuda):
    from deepspeed_tpu_torch.ops.kernels import flash_fwd
    q, k, v, *_ = _flash_case(1, 64, 1, 32, torch.float32, 0, cuda, False)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd(q, k, v)


# -- MoE dispatch and combine -----------------------------------------------
#
# Dispatch is a copy: exact in every dtype.  Combine accumulates in fp32 in
# the kernel; the plain version rounds the gate-weighted rows to the
# expert output's dtype first: fp32 1e-4, bf16 2e-2.  The routing is
# capacity-stressed, so empty slots and dropped assignments are present.

def _moe_case(T, E, C, H, k, dtype, seed, device):
    from deepspeed_tpu_torch.moe import top_k_gating_indices
    from deepspeed_tpu_torch.ops.kernels.moe_dispatch import \
        routing_to_indices
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(T, E, generator=g)
    logits[:, 0] += 1.5  # expert 0 overflows, the others leave slots empty
    gi, _, _ = top_k_gating_indices(logits, k, C)
    src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep, E, C)
    tokens = torch.randn(T, H, generator=g).to(device=device, dtype=dtype)
    eo = torch.randn(E, C, H, generator=g).to(device=device, dtype=dtype)
    return (tokens, eo, src.to(device), flat.to(device),
            gi.gate.t().contiguous().to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(64, 8, 20, 128, 2), (200, 8, 40, 256, 2),
                                   (37, 4, 12, 64, 1)],
                         ids=["k2", "k2_wide", "k1_odd_T"])
def test_cuda_moe_kernels_match_plain(cuda, dtype, shape):
    from deepspeed_tpu_torch.ops.kernels import (combine_reference,
                                                 dispatch_reference,
                                                 moe_combine_fwd,
                                                 moe_dispatch_fwd)
    T, E, C, H, k = shape
    tokens, eo, src, flat, gates = _moe_case(T, E, C, H, k, dtype, T + C,
                                             cuda)
    assert (src < 0).any() and (flat == E * C).any()
    before = (moe_dispatch_fwd.launches, moe_combine_fwd.launches)
    got = moe_dispatch_fwd(tokens, src)
    assert got.dtype == dtype and torch.equal(got,
                                              dispatch_reference(tokens, src))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    y = moe_combine_fwd(eo, flat, gates)
    want = combine_reference(eo, flat, gates)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert (moe_dispatch_fwd.launches - before[0],
            moe_combine_fwd.launches - before[1]) == (1, 1)


#: (case, T, E, C, H, fill): the dispatch kernel's edges.  fill: "empty"
#: (every slot -1), "past_T" (indices T .. T + 9 clamp to the last token),
#: "mixed" (a third empty, the rest random tokens).  "grid" has more rows
#: (E·C = 16384) than the kernel's persistent grid of blocks.
DISPATCH_EDGES = [("all_empty", 64, 8, 20, 256, "empty"),
                  ("index_past_T", 40, 4, 16, 128, "past_T"),
                  ("rows_of_16_bytes", 50, 4, 32, 0, "mixed"),
                  ("more_rows_than_grid", 300, 64, 256, 64, "mixed"),
                  ("wide_rows", 96, 2, 48, 8192, "mixed")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DISPATCH_EDGES,
                         ids=[c[0] for c in DISPATCH_EDGES])
def test_cuda_moe_dispatch_edges_equal_plain(cuda, dtype, case):
    """Dispatch is a byte copy: ``torch.equal`` with its plain version.
    H 0 stands for one 16-byte vector a row (4 fp32 or 8 bf16 values)."""
    from deepspeed_tpu_torch.ops.kernels import (dispatch_reference,
                                                 moe_dispatch_fwd)
    _, T, E, C, H, fill = case
    H = H or 16 // torch.empty(0, dtype=dtype).element_size()
    g = torch.Generator().manual_seed(T + E + C)
    tokens = torch.randn(T, H, generator=g).to(device=cuda, dtype=dtype)
    if fill == "empty":
        src = torch.full((E, C), -1, dtype=torch.int32)
    elif fill == "past_T":
        src = torch.randint(-1, T + 10, (E, C), generator=g,
                            dtype=torch.int32)
        src[0, :10] = torch.arange(T, T + 10, dtype=torch.int32)
    else:
        src = torch.randint(0, T, (E, C), generator=g, dtype=torch.int32)
        src[torch.rand(E, C, generator=g) < 1 / 3] = -1
    src = src.to(cuda)
    before = moe_dispatch_fwd.launches
    got = moe_dispatch_fwd(tokens, src)
    want = dispatch_reference(tokens, src)
    torch.cuda.synchronize()
    assert moe_dispatch_fwd.launches - before == 1
    assert got.dtype == dtype and torch.equal(got, want)
    if fill == "past_T":
        assert torch.equal(got[0, :10], tokens[-1].expand(10, H))


@pytest.mark.cuda
def test_cuda_moe_autograd_matches_plain(cuda):
    """The autograd Functions on the card against plain autograd."""
    from deepspeed_tpu_torch.ops.kernels import (combine_reference,
                                                 dispatch_reference,
                                                 moe_combine, moe_dispatch)
    tokens, eo, src, flat, gates = _moe_case(64, 8, 20, 128, 2,
                                             torch.float32, 3, cuda)
    runs = []
    for disp, comb in ((moe_dispatch, moe_combine),
                       (dispatch_reference, combine_reference)):
        t = tokens.clone().requires_grad_()
        g = gates.clone().requires_grad_()
        buf = disp(t, src)
        comb(buf * 1.5, flat, g).square().sum().backward()
        runs.append((t.grad, g.grad))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank", [0, 3])
def test_cuda_moe_kernels_at_one_ranks_view_of_global_routing(cuda, dtype,
                                                              rank):
    """Expert parallelism's pattern: the routing of 4 ranks' 96 tokens
    each, seen from one rank (``sharded_moe.local_routing``): most of
    ``src_idx`` is ``EMPTY_SLOT`` and ``flat_idx`` indexes the global
    ``[E, C]``; dispatch exact and combine within its tolerance."""
    from deepspeed_tpu_torch.moe.sharded_moe import local_routing
    from deepspeed_tpu_torch.ops.kernels import (combine_reference,
                                                 dispatch_reference,
                                                 moe_combine_fwd,
                                                 moe_dispatch_fwd)
    world, T, E, C, H, k = 4, 96, 8, 64, 256, 2
    _, eo, src, flat, gates = _moe_case(world * T, E, C, H, k, dtype, 17,
                                        cuda)
    src, flat, gates = local_routing(src, flat, gates, rank * T, T)
    tokens = torch.randn(T, H, generator=torch.Generator().manual_seed(
        rank)).to(device=cuda, dtype=dtype)
    assert (src < 0).float().mean() > 0.6 and (src >= 0).any()
    assert (flat == E * C).any() and int(flat.max()) < E * C + 1
    before = (moe_dispatch_fwd.launches, moe_combine_fwd.launches)
    got = moe_dispatch_fwd(tokens, src)
    assert torch.equal(got, dispatch_reference(tokens, src))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    y = moe_combine_fwd(eo, flat, gates)
    torch.testing.assert_close(y.float(), combine_reference(
        eo, flat, gates).float(), rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert (moe_dispatch_fwd.launches - before[0],
            moe_combine_fwd.launches - before[1]) == (1, 1)


@pytest.mark.cuda
def test_cuda_moe_kernels_refuse_unaligned_rows(cuda):
    from deepspeed_tpu_torch.ops.kernels import moe_dispatch_fwd
    tokens, _, src, *_ = _moe_case(16, 4, 8, 64, 1, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        moe_dispatch_fwd(tokens[:, :3].contiguous(), src)


# -- multi-tensor gradient norm and fused Adam -------------------------------
#
# The Adam kernel rounds where the plain version rounds (no FMA
# contraction), so the moments and the parameters are bit-equal, from a
# fresh state and from random moments alike.  The norm sums in another
# order: 1e-5.

ADAM_SHAPES = [(300, 7), (13,), (1,), (16384 + 5,), (2, 3, 4), (4096, 33)]


def _adam_lists(seed, device, fresh):
    g = torch.Generator().manual_seed(seed)
    p = [torch.randn(s, generator=g) for s in ADAM_SHAPES]
    gr = [torch.randn(s, generator=g) for s in ADAM_SHAPES]
    if fresh:
        m = [torch.zeros(s) for s in ADAM_SHAPES]
        v = [torch.zeros(s) for s in ADAM_SHAPES]
    else:
        m = [0.1 * torch.randn(s, generator=g) for s in ADAM_SHAPES]
        v = [(0.1 * torch.randn(s, generator=g)).abs() for s in ADAM_SHAPES]
    return [[t.to(device) for t in xs] for xs in (p, gr, m, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("wd,decoupled", [(0.0, True), (0.01, True),
                                          (0.02, False)],
                         ids=["adam", "adamw", "adam_l2"])
@pytest.mark.parametrize("step", [1, 7])
def test_cuda_fused_adam_matches_plain(cuda, wd, decoupled, step):
    from deepspeed_tpu_torch.ops.kernels import (FusedAdamConfig,
                                                 MultiTensorPlan, fused_adam,
                                                 reference_adam)
    cfg = FusedAdamConfig(weight_decay=wd, decoupled_wd=decoupled)
    kern = _adam_lists(step, cuda, fresh=step == 1)
    plain = [[t.clone() for t in xs] for xs in kern]
    mult = torch.tensor(0.37, device=cuda)
    before = fused_adam.launches
    fused_adam(*kern, step, 1e-3, mult, cfg, MultiTensorPlan(kern[0]))
    reference_adam(*plain, step, 1e-3, mult, cfg)
    torch.cuda.synchronize()
    assert fused_adam.launches - before == 1
    for i in range(len(ADAM_SHAPES)):
        for j in (0, 2, 3):  # p, m, v
            assert torch.equal(kern[j][i], plain[j][i]), (i, j)


@pytest.mark.cuda
def test_cuda_sqsum_matches_plain_and_repeats(cuda):
    from deepspeed_tpu_torch.ops.kernels import (MultiTensorPlan,
                                                 reference_sqsum, tree_sqsum)
    _, grads, _, _ = _adam_lists(3, cuda, fresh=True)
    plan = MultiTensorPlan(grads)
    before = tree_sqsum.launches
    a = tree_sqsum(grads, plan)
    b = tree_sqsum(grads)  # a plan built on the spot
    want = reference_sqsum(grads)
    torch.cuda.synchronize()
    assert tree_sqsum.launches - before == 2
    assert torch.equal(a, b)  # two fixed-order stages: no atomics
    torch.testing.assert_close(a, want, rtol=1e-5, atol=0)
    for bad in (float("inf"), float("nan")):
        poisoned = [g.clone() for g in grads]
        poisoned[3][7] = bad
        assert not torch.isfinite(tree_sqsum(poisoned, plan))


@pytest.mark.cuda
def test_cuda_fused_adam_refuses_what_the_kernel_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels import MultiTensorPlan, fused_adam
    p, g, m, v = _adam_lists(0, cuda, fresh=True)
    plan = MultiTensorPlan(p)
    with pytest.raises(TypeError, match="fp32"):
        fused_adam(p, [x.half() for x in g], m, v, 1, 1e-3, plan=plan)
    with pytest.raises(ValueError, match="shapes"):
        fused_adam(p[:-1], g[:-1], m[:-1], v[:-1], 1, 1e-3, plan=plan)
    with pytest.raises(ValueError, match="contiguous"):
        fused_adam([p[5].t()], [g[5].t()], [m[5].t()], [v[5].t()], 1, 1e-3)


# -- block-sparse attention: forward, dq pass, dk/dv pass --------------------
#
# Tolerances as for flash attention: fp32 1e-4; bf16 2e-2 (the plain forward
# rounds q·k and p to bf16, the kernel keeps fp32).  The cases cover the
# layout families, cells of 1 to 256 tokens (sub-tile masks, whole tiles,
# cells spanning tiles), shared and per-head layouts, causal and not, rows
# with no live key (EmptyTail) and S that is not a multiple of the 64-row
# tile (272 with cells of 16, 200 with cells of 8 and of 2).

def _bs_config(family, h, cb, per_head):
    import importlib
    sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
    kw = dict(num_heads=h, block=cb, different_layout_per_head=per_head)
    if family == "empty_tail":
        class EmptyTail(sa.FixedSparsityConfig):
            def _head_layout(self, seq_len, head):
                lay = super()._head_layout(seq_len, head)
                lay[-4:, :] = 0
                return lay
        return EmptyTail(num_local_blocks=2, num_global_blocks=0, **kw)
    if family == "late_keys":
        class LateKeys(sa.SparsityConfig):
            """Each cell row attends its diagonal cell; the first cell row
            of each 64-row tile also attends cell 0, so the other rows of
            the tile walk k tile 0 first and find no live key there."""
            def _head_layout(self, seq_len, head):
                lay = np.eye(self._blocks(seq_len), dtype=np.int32)
                lay[::max(64 // self.block, 1), 0] = 1
                return lay
        return LateKeys(**kw)
    if family == "fixed_unidirectional":
        return sa.FixedSparsityConfig(attention="unidirectional", **kw)
    return getattr(sa, family)(**kw)


#: (case, config family, S, cells, per-head layout, causal)
BS_CASES = [
    ("bigbird_cb16_perhead", "BigBirdSparsityConfig", 512, 16, True, True),
    ("bigbird_cb32", "BigBirdSparsityConfig", 512, 32, False, False),
    ("fixed_cb64", "FixedSparsityConfig", 1024, 64, False, False),
    ("fixed_uni_cb16", "fixed_unidirectional", 512, 16, False, True),
    ("longformer_cb128", "BSLongformerSparsityConfig", 1024, 128, False,
     True),
    ("variable_cb256", "VariableSparsityConfig", 1024, 256, False, True),
    ("dense_cb64", "SparsityConfig", 256, 64, False, True),
    ("empty_tail", "empty_tail", 256, 16, False, False),
    ("ragged_272", "BigBirdSparsityConfig", 272, 16, True, True),
    ("ragged_cb8", "BigBirdSparsityConfig", 200, 8, True, False),
    ("cb4_perhead", "BigBirdSparsityConfig", 256, 4, True, True),
    ("cb2_ragged", "BigBirdSparsityConfig", 200, 2, False, True),
    ("cb1", "BSLongformerSparsityConfig", 128, 1, False, False),
    ("late_keys_cb16", "late_keys", 320, 16, False, True),
    ("bigbird_cb128_s4096", "BigBirdSparsityConfig", 4096, 128, False, True),
]


def _bs_case(case, d, dtype, device):
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
        _norm_layout, tile_plan)
    _, family, S, cb, per_head, causal = case
    h = 3
    layout = _norm_layout(_bs_config(family, h, cb, per_head).make_layout(S),
                          h)
    q, k, v, do, _ = _flash_case(2, S, h, d, dtype, S + cb + d, device,
                                 False)
    return q, k, v, do, layout, cb, causal, tile_plan(layout, cb, S, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", BS_CASES, ids=[c[0] for c in BS_CASES])
def test_cuda_block_sparse_kernels_match_plain(cuda, dtype, d, case):
    from deepspeed_tpu_torch.ops.kernels import (block_sparse_bwd_dkv,
                                                 block_sparse_bwd_dq,
                                                 block_sparse_bwd_plain,
                                                 block_sparse_fwd,
                                                 block_sparse_fwd_plain)
    q, k, v, do, layout, cb, causal, plan = _bs_case(case, d, dtype, cuda)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = (block_sparse_fwd.launches, block_sparse_bwd_dq.launches,
              block_sparse_bwd_dkv.launches)
    out, lse = block_sparse_fwd(q, k, v, plan)
    want_out, want_lse = block_sparse_fwd_plain(q, k, v, layout, cb, causal)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    dq = block_sparse_bwd_dq(q, k, v, want_out, want_lse, do, plan)
    dk, dv = block_sparse_bwd_dkv(q, k, v, want_out, want_lse, do, plan)
    want = block_sparse_bwd_plain(q, k, v, want_out, want_lse, do, layout,
                                  cb, causal)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    torch.cuda.synchronize()
    assert (block_sparse_fwd.launches - before[0],
            block_sparse_bwd_dq.launches - before[1],
            block_sparse_bwd_dkv.launches - before[2]) == (1, 1, 1)
    if case[0] == "empty_tail":  # no key for the last 64 rows; keys unread
        assert (out[:, -64:] == 0).all() and (lse[..., -64:] == 1e30).all()
        assert (dq[:, -64:] == 0).all()
        assert (dk[:, -64:] == 0).all() and (dv[:, -64:] == 0).all()


#: the random-``out`` regime's layouts: cells smaller than a tile (every
#: walked tile masked) and cells of a tile (wholly live tiles, no mask)
BS_REGIME = {"bigbird_cb16_perhead": ("BigBirdSparsityConfig", 16, True),
             "fixed_cb64": ("FixedSparsityConfig", 64, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seed", REGIME_SEEDS)
@pytest.mark.parametrize("layout", sorted(BS_REGIME))
def test_cuda_block_sparse_bwd_random_out_regime(cuda, dtype, d, seed,
                                                 layout):
    """The block-sparse dq and dk/dv passes on the random-``out`` regime of
    the flash test above (dead rows give dq 0), causal."""
    from deepspeed_tpu_torch.ops.kernels import (block_sparse_bwd_dkv,
                                                 block_sparse_bwd_dq,
                                                 block_sparse_bwd_plain)
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
        _norm_layout, tile_plan, token_mask)
    family, cb, per_head = BS_REGIME[layout]
    S, h = REGIME_S, REGIME_H
    lay = _norm_layout(_bs_config(family, h, cb, per_head).make_layout(S), h)
    plan = tile_plan(lay, cb, S, True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q, k, v, do, out, lse, dead = _regime_case(d, dtype, seed, cuda)
    dq = block_sparse_bwd_dq(q, k, v, out, lse, do, plan)
    dk, dv = block_sparse_bwd_dkv(q, k, v, out, lse, do, plan)
    torch.cuda.synchronize()
    assert (dq[:, dead] == 0).all()
    want = block_sparse_bwd_plain(q, k, v, out, lse, do, lay, cb, True)
    mask = token_mask(lay, cb, True, S, device=cuda)[None]
    _hold_regime(f"block-sparse {layout} {dtype} d {d} seed {seed}",
                 (dq, dk, dv), want,
                 _bwd_ds_rounded(q, k, v, out, lse, do, mask), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_block_sparse_bwd_random_out_wide(cuda, dtype, seed):
    """The block-sparse backward passes on a random ``out`` and lse =
    |N(0, 1)| + 3 at a wide shape (B 4, h 16, S 1024, d 64, a shared
    BigBird layout of 64-token cells, non-causal): many live queries a
    key, so P reaches well above 1, as at BERT's flash shape."""
    from deepspeed_tpu_torch.ops.kernels import (block_sparse_bwd_dkv,
                                                 block_sparse_bwd_dq,
                                                 block_sparse_bwd_plain)
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
        _norm_layout, tile_plan)
    B, S, h, d, cb = 4, 1024, 16, 64, 64
    lay = _norm_layout(_bs_config("BigBirdSparsityConfig", h, cb, False)
                       .make_layout(S), h)
    plan = tile_plan(lay, cb, S, False)
    q, k, v, do, _ = _flash_case(B, S, h, d, dtype, 200 + seed, cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    lse = torch.randn(B, h, S, generator=gen, device=cuda).abs() + 3.0
    dq = block_sparse_bwd_dq(q, k, v, out, lse, do, plan)
    dk, dv = block_sparse_bwd_dkv(q, k, v, out, lse, do, plan)
    want = block_sparse_bwd_plain(q, k, v, out, lse, do, lay, cb, False)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        print(f"{name}: share of the bound {_of_bound(got, ref, 2e-2):.3f}")
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2, msg=name)


@pytest.mark.cuda
def test_cuda_block_sparse_autograd_matches_plain(cuda):
    """``sparse_attention`` on the card (the kernel route) against plain
    autograd of the dense path."""
    import importlib
    sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
    from deepspeed_tpu_torch.ops.kernels import block_sparse_fwd
    cfg = sa.BSLongformerSparsityConfig(num_heads=2, block=64,
                                        global_block_indices=())
    q, k, v, do, _ = _flash_case(1, 1024, 2, 64, torch.float32, 5, cuda,
                                 False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = block_sparse_fwd.launches
    sa.sparse_attention(*leaves, cfg, causal=True).backward(do)
    assert block_sparse_fwd.launches - before == 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    sa.sparse_attention(*ref, cfg, causal=True, impl="dense").backward(do)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_block_sparse_refuses_what_the_kernels_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels import block_sparse_fwd
    q, k, v, _, _, _, _, plan = _bs_case(BS_CASES[1], 64, torch.float32,
                                         cuda)
    with pytest.raises(ValueError, match="head dim"):
        block_sparse_fwd(*(t[..., :32].contiguous() for t in (q, k, v)),
                         plan)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        block_sparse_fwd(q.double(), k.double(), v.double(), plan)


# -- int8 quantizer and tensor-parallel paged decode --------------------------

#: (case, shape): bench.py's shape, a rank-3 input, a zero row, a row with
#: one value 1e4 times the rest, and rows whose bytes are no multiple of 16
#: (the kernel's scalar walk)
QUANT_CASES = [("bench", (512, 256)), ("rank3", (4, 256, 96)),
               ("zero_row", (512, 256)), ("outlier", (512, 256)),
               ("ragged", (4, 100, 96)), ("odd_width", (37, 99))]


def _quant_case(case, dtype, device):
    shape = dict(QUANT_CASES)[case]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(len(case)))
    if case == "zero_row":
        x[3] = 0.0
    if case == "outlier":
        x[5] = 1e-2
        x[5, 17] = 1e2
    return x.to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", [c for c, _ in QUANT_CASES])
def test_cuda_quantizer_matches_plain_exactly(cuda, case, dtype):
    from deepspeed_tpu_torch.ops.kernels import (quantize_int8,
                                                 quantize_int8_plain)
    x = _quant_case(case, dtype, cuda)
    before = quantize_int8.launches
    q, s = quantize_int8(x)
    torch.cuda.synchronize()
    assert quantize_int8.launches - before == 1
    want_q, want_s = quantize_int8_plain(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == x.shape[:-1]
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    if case == "zero_row":
        assert s[3].item() == 1.0 and not q[3].any()


@pytest.mark.cuda
def test_cuda_quantizer_refuses_what_the_kernel_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.kernels import quantize_int8
    with pytest.raises(TypeError, match="not supported"):
        quantize_int8(torch.ones(4, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        quantize_int8(torch.ones(8, 4, device=cuda).t())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("window", [None, 20])
def test_cuda_paged_tp_shards_equal_unsharded_heads(cuda, dtype, tp, window):
    """Each rank's contiguous head block through
    ``paged_decode_attention_tp`` gives, bit for bit, those heads of the
    unsharded kernel's result (one process plays every rank)."""
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention_tp
    from deepspeed_tpu_torch.parallel import MeshLayout, ProcessMesh
    _, lengths = _split_lengths()  # across several split-K chunks
    q, _, _, pk, pv, tables, lens = _split_case(4, 128, dtype, lengths, tp,
                                                cuda)
    q = torch.cat([q, q + 1], dim=1)  # 16 query heads
    pk, pv = (torch.cat([t, t.flip(0)], dim=2).contiguous() for t in (pk, pv))
    full = paged_decode_attention(q, pk, pv, tables, lens, window=window)
    h, kv = q.shape[1] // tp, pk.shape[2] // tp
    before = (paged_decode_attention.launches,
              paged_decode_attention_tp.launches)
    for r in range(tp):
        mesh = ProcessMesh(MeshLayout(tp=tp), rank=r)
        got = paged_decode_attention_tp(
            q[:, r * h:(r + 1) * h].contiguous(),
            pk[:, :, r * kv:(r + 1) * kv].contiguous(),
            pv[:, :, r * kv:(r + 1) * kv].contiguous(), tables, lens, mesh,
            window=window)
        assert torch.equal(got, full[:, r * h:(r + 1) * h])
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches - before[0],
            paged_decode_attention_tp.launches - before[1]) == (0, tp)


# -- tensor parallelism over NCCL ---------------------------------------------

def _nccl_serve_rank(rank, prompts):
    """One rank of a tensor-parallel v2 engine over NCCL (card
    ``LOCAL_RANK``), as many ranks as the launch started."""
    from deepspeed_tpu_torch import (KVCacheConfig, LlamaModel,
                                     build_engine_v2, init_distributed)
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups
    init_distributed()
    mesh = groups.initialize_mesh(MeshLayout.infer(
        tp=torch.distributed.get_world_size()))
    model = LlamaModel(_TP_CFG, device="cuda", seed=3, mesh=mesh)
    eng = build_engine_v2(model, cache_config=KVCacheConfig(**_TP_CACHE),
                          prefill_chunk=16, mesh=mesh)
    return eng.generate(prompts, max_new_tokens=8)


def _nccl_shared_card_rank(rank, same_local_rank):
    """Two NCCL ranks on one card: by local rank past the cards, or by two
    ranks that both claim card 0."""
    import os
    from deepspeed_tpu_torch import init_distributed
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    if same_local_rank:
        os.environ["LOCAL_RANK"] = "0"
    init_distributed()
    return None


_TP_CFG = LlamaConfig.tiny(num_layers=2, hidden_size=512, num_heads=8,
                          num_kv_heads=4, dtype=torch.float32)
_TP_CACHE = dict(num_blocks=64, block_size=16, max_seq_len=128)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_cuda_nccl_tp_serve_matches_one_rank(cuda, tp):
    """``tp`` ranks, one card each, over NCCL: the v2 engine's greedy
    tokens equal the one-rank engine's (fp32)."""
    if torch.cuda.device_count() < tp:
        pytest.skip(f"NCCL tensor parallelism needs one card per rank: "
                    f"fewer than {tp} cards")
    from deepspeed_tpu_torch import KVCacheConfig, LlamaModel, build_engine_v2
    from deepspeed_tpu_torch.launcher import launch
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 23, 40)]
    want = build_engine_v2(LlamaModel(_TP_CFG, device=cuda, seed=3),
                           cache_config=KVCacheConfig(**_TP_CACHE),
                           prefill_chunk=16).generate(prompts,
                                                      max_new_tokens=8)
    got = launch(_nccl_serve_rank, tp, (prompts,), timeout=300)
    assert all(g == want for g in got)


# -- data parallelism and ZeRO over NCCL -------------------------------------

_ZERO_CFG = LlamaConfig.tiny(num_layers=2, hidden_size=512, num_heads=8,
                             num_kv_heads=4, dtype=torch.float32,
                             param_dtype=torch.float32, attn_impl="flash")
_ZERO_STEPS = 3


def _zero_config(stage, rows):
    return {"train_micro_batch_size_per_gpu": rows, "steps_per_print": 0,
            "gradient_clipping": 0.5,
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": 1000},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def _zero_batches(world):
    g = torch.Generator().manual_seed(1)
    return [torch.randint(0, 512, (2 * world, 32), generator=g)
            for _ in range(_ZERO_STEPS)]


def _nccl_zero_rank(rank):
    """Stages 0-3 on one rank of a data-parallel world over NCCL (card
    ``LOCAL_RANK``): the losses of each stage on this rank's rows."""
    from deepspeed_tpu_torch import LlamaModel, init_distributed, initialize
    init_distributed()
    world = torch.distributed.get_world_size()
    out = {}
    for stage in range(4):
        model = LlamaModel(_ZERO_CFG, device="cuda", seed=rank)
        engine, *_ = initialize(model=model, config=_zero_config(stage, 2))
        out[stage] = [float(engine.train_step(
            {"input_ids": b[2 * rank:2 * rank + 2]})["loss"])
            for b in _zero_batches(world)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_cuda_nccl_zero_stages_match_one_rank(cuda, world):
    """``world`` ranks, one card each, over NCCL, at ZeRO stages 0-3: every
    rank's losses equal the one-process run on the global batch (fp32,
    1e-5 relative)."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"NCCL data parallelism needs one card per rank: "
                    f"fewer than {world} cards")
    from deepspeed_tpu_torch import LlamaModel, initialize
    from deepspeed_tpu_torch.launcher import launch
    engine, *_ = initialize(model=LlamaModel(_ZERO_CFG, device=cuda, seed=0),
                            config=_zero_config(0, 2 * world))
    want = [float(engine.train_step({"input_ids": b})["loss"])
            for b in _zero_batches(world)]
    got = launch(_nccl_zero_rank, world, (), timeout=600)
    for res in got:
        for stage in range(4):
            np.testing.assert_allclose(res[stage], want, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("same_local_rank", [False, True])
def test_cuda_nccl_refuses_two_ranks_on_one_card(cuda, same_local_rank):
    from deepspeed_tpu_torch.launcher import launch
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        launch(_nccl_shared_card_rank, 2, (same_local_rank,), timeout=120)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sync", "async"])
def test_cuda_checkpoint_round_trip(cuda, tmp_path, kind):
    """On the card: save after 2 steps (the async engine's snapshot is
    taken before ``save_checkpoint`` returns, so the next in-place step
    does not reach the file), load into a model from another seed: the
    masters, m, v and the next step's loss bit-equal to the unbroken
    run's."""
    from deepspeed_tpu_torch import LlamaModel, initialize
    config = dict(_zero_config(0, 2), checkpoint={
        "checkpoint_engine": {"type": kind}},
        kernels={"fused_adam": True})
    batches = _zero_batches(1) + _zero_batches(1)[:1]
    engine, *_ = initialize(model=LlamaModel(_ZERO_CFG, device=cuda, seed=0),
                            config=config)
    for b in batches[:2]:
        engine.train_step({"input_ids": b})
    saved = [t.clone() for t in list(engine.params) + engine.optimizer.m
             + engine.optimizer.v]
    engine.save_checkpoint(str(tmp_path))
    want = [float(engine.train_step({"input_ids": b})["loss"])
            for b in batches[2:]]  # in place, while an async save writes
    engine.checkpoint_engine.wait()
    again, *_ = initialize(model=LlamaModel(_ZERO_CFG, device=cuda, seed=9),
                           config=config)
    again.load_checkpoint(str(tmp_path))
    for a, b in zip(saved, list(again.params) + again.optimizer.m
                    + again.optimizer.v):
        assert torch.equal(a, b)
    assert [float(again.train_step({"input_ids": b})["loss"])
            for b in batches[2:]] == want
