"""The port's int8 quantizer against the JAX package's.

The same inputs (numpy, seeded; bf16 made once with PyTorch and carried to
JAX exactly, since every bf16 value is an fp32 value) go through the
port's ``quantize_int8`` on the CPU (the kernel's plain version) and
through JAX's ``quantize_int8(interpret=True)``, which runs the Pallas
kernel in interpret mode when the rows divide into its 256-row tiles and
its jnp reference ``_ref_quantize`` otherwise.  Against the kernel, codes
and scales must be equal, not close.  The JAX reference and the JAX kernel
disagree: in bf16 the reference takes ``amax`` and divides by 127 in bf16;
in fp32 it divides by 127 where the compiled kernel multiplies by the fp32
reciprocal (XLA's rewrite of a division by a constant), so a few per cent
of its scales differ by one ulp.  The port follows the kernel; the tests
hold it to the reference's codes exactly and its fp32 scales to one ulp,
and pin both differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.quantizer import _ref_quantize
from deepspeed_tpu.ops.pallas.quantizer import \
    dequantize_int8 as jax_dequantize_int8
from deepspeed_tpu.ops.pallas.quantizer import \
    quantize_int8 as jax_quantize_int8
from deepspeed_tpu_torch.ops.kernels import (dequantize_int8, quantize_int8,
                                             quantize_int8_plain)
from torch_parity import free_jax_cycles  # noqa: F401

#: (case, shape): bench.py's shape, a rank-3 input, a zero row, and a row
#: holding one value 1e4 times the rest
CASES = [("bench", (512, 256)), ("rank3", (4, 256, 96)),
         ("zero_row", (512, 256)), ("outlier", (512, 256))]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(case, shape, dtype_name):
    """(torch tensor, jax array) holding the same values."""
    x = np.random.RandomState(len(case) + len(shape)).randn(*shape)
    x = x.astype(np.float32)
    if case == "zero_row":
        x[3] = 0.0
    if case == "outlier":
        x[5] = 1e-2
        x[5, 17] = 1e2
    tdt, jdt = DTYPES[dtype_name]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _equal(port, jax_out):
    q, s = port
    jq, js = (np.asarray(a) for a in jax_out)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case,shape", CASES, ids=[c for c, _ in CASES])
def test_quantize_equals_the_jax_kernel(case, shape, dtype):
    x, jx = _inputs(case, shape, dtype)
    _equal(quantize_int8(x), jax_quantize_int8(jx, interpret=True))
    if case == "zero_row":
        q, s = quantize_int8(x)
        assert s[3].item() == 1.0 and not q[3].any()


@pytest.mark.parametrize("case,shape", CASES + [("ragged", (4, 100, 96))],
                         ids=[c for c, _ in CASES] + ["ragged"])
def test_fp32_equals_the_jax_reference(case, shape):
    """In fp32 the port gives the JAX reference's codes, also at ``[4, 100,
    96]``, whose 400 rows the JAX wrapper sends to the reference; its
    scales are the reference's or one ulp from them (the reference divides
    by 127, the kernel multiplies by 1/127)."""
    x, jx = _inputs(case, shape, "float32")
    jq, js = (np.asarray(a) for a in _ref_quantize(jx.reshape(-1,
                                                              shape[-1])))
    q, s = quantize_int8(x)
    np.testing.assert_array_equal(q.numpy().reshape(jq.shape), jq)
    s = s.numpy().reshape(-1)
    assert (np.abs(s - js) <= np.spacing(js)).all()
    assert (s == js).mean() > 0.9


def test_the_port_follows_the_kernel_not_the_jax_reference():
    """bf16: the JAX reference rounds ``amax / 127`` to bf16, so its scales
    differ from the kernel's (and the port's) in most rows, by up to 0.4 %.
    fp32: the kernel's scale is ``amax * float32(1/127)``, which the
    reference's division misses by one ulp in a few rows."""
    x, jx = _inputs("bench", (512, 256), "bfloat16")
    q, s = quantize_int8(x)
    _equal((q, s), jax_quantize_int8(jx, interpret=True))
    ref_s = np.asarray(_ref_quantize(jx)[1])
    rel = np.abs(ref_s - s.numpy()) / s.numpy()
    assert (ref_s != s.numpy()).sum() > 256
    assert 0 < rel.max() < 5e-3
    x, jx = _inputs("bench", (512, 256), "float32")
    s = quantize_int8(x)[1].numpy()
    amax = np.abs(x.numpy()).max(axis=-1)
    np.testing.assert_array_equal(s, amax * np.float32(1.0 / 127.0))
    assert (s != np.asarray(_ref_quantize(jx)[1])).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequantize_round_trip(dtype):
    """bench.py's check: the error is at most ``max|x| / 127 · 1.01``, and
    the port's ``dequantize_int8`` is JAX's."""
    x, jx = _inputs("bench", (512, 256), dtype)
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s)
    bound = x.float().abs().max().item() / 127.0
    assert (back - x.float()).abs().max().item() <= bound * 1.01
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_dequantize_int8(jnp.asarray(q.numpy()),
                                                     jnp.asarray(s.numpy()))))
    assert dequantize_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


def test_plain_version_and_refusals():
    x, _ = _inputs("rank3", (4, 256, 96), "float32")
    for a, b in zip(quantize_int8(x), quantize_int8_plain(x)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="not supported"):
        quantize_int8(x.double())
    with pytest.raises(ValueError, match="at least one value"):
        quantize_int8(torch.ones(4, 0))
    assert quantize_int8.launches == 0  # the CPU never counts
