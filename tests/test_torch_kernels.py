"""The CUDA kernels (decode attention, flash attention, MoE dispatch and
combine, the multi-tensor gradient norm and fused Adam) against their plain
PyTorch versions.

These tests need an NVIDIA GPU (``-m cuda``) and skip without one: a CUDA
kernel has no CPU mode.  They import no JAX, so they run on a machine that
has only PyTorch and the CUDA toolkit::

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerances: fp32 1e-4 (fp32 arithmetic, another summation order); bf16
2e-2 (the plain version rounds q·k and p to bf16, the kernel keeps fp32).
Lengths cover 1, bs-1, bs, bs+1, full and past full; n_rep covers the
kernel's head-group splits (1, 2, 3, 4, 8, 12).
"""

import pytest
import torch

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.cuda
def test_cuda_kernel_refuses_unsupported_head_dim(cuda):
    q, k, v, *_, lens = _cuda_case(2, 64, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                         v[..., :32].contiguous(), lens)


# -- flash attention (training): forward, dq pass, dk/dv pass ---------------
#
# Tolerances: fp32 1e-4; bf16 2e-2 (the plain forward rounds q·k and p to
# bf16, the kernel keeps fp32; the backward passes differ only in the final
# rounding).  S 200 leaves a tail tile of 8 rows; the masks cover causal,
# causal with a window, a bidirectional window and packed segments.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("S", [128, 200])
@pytest.mark.parametrize("mask", sorted(FLASH_MASKS))
def test_cuda_flash_kernels_match_plain(cuda, dtype, d, S, mask):
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain,
                                                 flash_bwd_dkv, flash_bwd_dq,
                                                 flash_fwd)
    causal, window, with_seg = FLASH_MASKS[mask]
    q, k, v, do, seg = _flash_case(2, S, 3, d, dtype, S + d, cuda, with_seg)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
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
    torch.cuda.synchronize()
    assert (flash_fwd.launches - before[0], flash_bwd_dq.launches - before[1],
            flash_bwd_dkv.launches - before[2]) == (1, 1, 1)


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
    torch.testing.assert_close(got, dispatch_reference(tokens, src),
                               rtol=0, atol=0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    y = moe_combine_fwd(eo, flat, gates)
    want = combine_reference(eo, flat, gates)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert (moe_dispatch_fwd.launches - before[0],
            moe_combine_fwd.launches - before[1]) == (1, 1)


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
