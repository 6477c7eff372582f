"""The CUDA kernels (decode attention, flash attention) against their plain
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
