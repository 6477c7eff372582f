"""The CUDA decode-attention kernels against their plain PyTorch versions.

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
