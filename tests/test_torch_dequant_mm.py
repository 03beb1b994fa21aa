"""B2 (dequant_gemv): the port's plain version against the JAX package's
``dequant_matmul`` for unpacked rowwise int8 / uint8 weights, through the
XLA fallback and the Pallas ``row_epi`` body in interpret mode.

fp32 throughout: the two sides sum the same products in another order
(the JAX fallback scales the weight before the dot, the port and the
kernel after it), so outputs agree to rtol 1e-5 plus 1e-5 of the largest
output."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.formats import get_format as jfmt
from sdnq_tpu_torch.formats import get_format as tfmt

jdq = importlib.import_module("sdnq_tpu.kernels.dequant_mm")
tdq = importlib.import_module("sdnq_tpu_torch.kernels.dequant_mm")


@pytest.fixture(params=["xla", "interpret"])
def backend(request, monkeypatch):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", request.param)
    return request.param


@pytest.mark.parametrize("m", [1, 7, 31])
@pytest.mark.parametrize("fmt", ["int8", "uint8"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_dequant_matmul_rowwise(backend, m, fmt, with_bias):
    k, o = 256, 384
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    if fmt == "int8":
        w = rng.integers(-128, 128, (o, k)).astype(np.int8)
        zp = None
    else:
        w = rng.integers(0, 256, (o, k)).astype(np.uint8)
        zp = rng.normal(size=(o, 1)).astype(np.float32)
    scale = rng.uniform(0.005, 0.02, (o, 1)).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32) if with_bias else None
    j = lambda a: None if a is None else jnp.asarray(a)      # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ref = jdq.dequant_matmul(j(x), j(w), j(scale), j(zp), j(bias),
                             jfmt(fmt), -1, out_dtype=jnp.float32)
    out = tdq.dequant_matmul(t(x), t(w), t(scale), t(zp), t(bias),
                             tfmt(fmt), -1, out_dtype=torch.float32)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_dequant_matmul_grouped_plain():
    """Grouped scales: the plain path on the CPU (its kernel is a later
    slice); same fp32 products as the JAX fallback."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(5, 256)).astype(np.float32)
    w = rng.integers(-128, 128, (64, 256)).astype(np.int8)
    scale = rng.uniform(0.005, 0.02, (64, 4)).astype(np.float32)
    ref = jdq.dequant_matmul(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(scale), None, None, jfmt("int8"),
                             64, out_dtype=jnp.float32)
    out = tdq.dequant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(scale), None, None,
                             tfmt("int8"), 64, out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_dequant_gemv_plain_row_epilogue():
    """The plain version's row epilogue against the dequantize-then-dot
    definition, in float64."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.integers(0, 256, (32, 64)).astype(np.uint8)
    s = rng.uniform(0.01, 0.02, (32,)).astype(np.float32)
    z = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    out = tdq.dequant_gemv_plain(*map(torch.from_numpy, (x, w, s, z, b)),
                                 torch.float32)
    ref = x.astype(np.float64) @ (w * s[:, None].astype(np.float64)
                                  + z[:, None]).T + b
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
