"""Symmetric per-row int8 quantization: a hand-written CUDA kernel for
Hopper beside its plain PyTorch version.

Replaces the Pallas TPU kernel ``quantize_int8`` (``_quant_kernel``) of
``deepspeed_tpu/ops/pallas/quantizer.py``, the building block of ZeRO++'s
compressed collectives; the CUDA source is
``deepspeed_tpu_torch/csrc/quantizer.cu`` (entry point
``ds_quantize_int8``).  Each row of the last dim gets one fp32 scale,
``amax / 127`` (1.0 for a zero row), and int8 codes ``clamp(round(x /
scale), -127, 127)``, rounding half to even.

The port follows the TPU kernel as XLA compiles it: ``amax`` of the fp32
values, and ``amax / 127.0`` as ``amax * float32(1 / 127)`` (XLA turns a
division by a constant into a product with its reciprocal), then ``x /
scale`` as a true division.  The JAX package's eager reference
``_ref_quantize`` differs from its kernel in both respects: it takes
``amax`` and divides in the input dtype (on bf16 input most scales differ
by up to 0.4 %), and its fp32 division by 127 is a true one (a few per
cent of the fp32 scales differ by one ulp, the codes not at all).  The JAX
wrapper sends rows that do not divide into its tiles to that reference;
the port computes every shape alike.  ``runtime/zero/qwz.py``'s grouped
``_quant`` is another format and is not this function.

Bound on the card: the bytes (each element read once, one byte written
per element and four per row).  On a CPU tensor the wrapper runs
:func:`quantize_int8_plain`; on a CUDA tensor it launches the kernel and
raises on any failure.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import op_builder
from .common import DTYPE_CODES

#: input dtypes the kernel is instantiated for
QUANT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: 1/127, rounded once to fp32 when it multiplies an fp32 tensor (the
#: kernel's 1.0f / 127.0f)
INV_127 = 1.0 / 127.0


def quantize_int8_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transcription of the TPU kernel's body (``_quant_kernel``) over the
    rows of the last dim."""
    x2d = x.reshape(-1, x.shape[-1]).float()
    amax = x2d.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(x2d / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[:, 0].reshape(x.shape[:-1])


def quantize_int8(x: torch.Tensor, block_rows: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., C]`` (fp32, bf16 or fp16) → ``(int8 [..., C], fp32 scales
    [...])``.  ``block_rows`` is the TPU kernel's tile height, kept for the
    JAX signature; the CUDA kernel takes one row a thread block."""
    if x.dtype not in QUANT_DTYPES:
        raise TypeError(f"quantize_int8: dtype {x.dtype} not supported "
                        "(fp32, bf16 or fp16)")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"quantize_int8: need rows of at least one value, "
                         f"got shape {tuple(x.shape)}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"quantize_int8: tensor of shape {tuple(x.shape)} "
                         "must be contiguous")
    lib = op_builder.load_library()
    cols = x.shape[-1]
    rows = x.numel() // cols
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    vector = (cols * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    status = lib.ds_quantize_int8(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, cols,
        DTYPE_CODES[x.dtype], int(vector),
        torch.cuda.current_stream(x.device).cuda_stream)
    op_builder.check(status, "quantize_int8")
    quantize_int8.launches += 1
    return q, scales


#: kernel launches since the last reset (CPU calls never count)
quantize_int8.launches = 0


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (plain PyTorch, as in JAX)."""
    return (q.float() * scales[..., None]).to(dtype)
