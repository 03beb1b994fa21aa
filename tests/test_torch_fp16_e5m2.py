"""B2's float8_e5m2 codes and fp16 activations on B2 (unpacked, grouped and
bit-plane codes) and B5 (half-split codes), the kernels' plain versions on
the CPU against the JAX package's ``dequant_matmul`` on the same numpy
inputs, through the Pallas bodies in interpret mode (the function of the
kernels: the JAX XLA route rounds a rowwise or zero-pointed weight at
other points, as ``test_torch_weight_only.py`` pins; the interpret backend
keeps fp16 x as the chip's wrapper does, which casts only fp32 x to bf16,
and only on the chip).

Each scaled weight is rounded to x's dtype before the product, fp16 here:
the outputs (fp32) then differ by the summation order alone, so rtol 1e-5
plus 1e-5 of the largest output (as ``test_torch_packed_modes.py``).
The fp16 rounding point is pinned: the same call with x and the weight
rounded to bf16 instead (the card's old cast) misses that bound by far,
at the 2^-10-of-the-largest-output limit the card's checks use."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sdnq_tpu as J
from sdnq_tpu.formats import get_format as jfmt
from sdnq_tpu_torch.convert import tensor_from_numpy
from sdnq_tpu_torch.formats import get_format as tfmt

jdq = importlib.import_module("sdnq_tpu.kernels.dequant_mm")
tdq = importlib.import_module("sdnq_tpu_torch.kernels.dequant_mm")

J_KERNEL_FNS = [jdq._dequant_mm_pallas, jdq._groupdot_mm_pallas,
                jdq._blockdiag_mm_pallas]


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas bodies in interpret mode (its jitted
    wrappers read the backend while tracing: their caches are cleared
    around each test)."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    for fn in J_KERNEL_FNS:
        fn.clear_cache()
    yield
    for fn in J_KERNEL_FNS:
        fn.clear_cache()


def _weight(fmt, k, g, seed, o=96):
    """A JAX-quantized weight (with a few outliers) as numpy: codes, scale
    (O, G), zero point or None."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(o, k)) * (1 + 6 * (rng.random((o, k)) > 0.99))
    jq = J.quantize_tensor(jnp.asarray(w.astype(np.float32) * 0.02), fmt,
                           group_size=g)
    scale = np.asarray(jq.scale).reshape(o, -1)
    zp = (None if jq.zero_point is None
          else np.asarray(jq.zero_point).reshape(o, -1))
    codes = np.asarray(jq.qdata)
    return jq, codes.reshape(o, -1) if codes.ndim > 2 else codes, scale, zp


def _t(a):
    return None if a is None else tensor_from_numpy(a, "cpu")


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(out, ref):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(out, dtype=np.float32), ref,
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _x(m, k, seed, dtype):
    x = np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    return xt, jnp.asarray(xt.float().numpy()).astype(jdt)


def _both(xt, xj, jq, codes, scale, zp, b, fmt, g, layout):
    ref = jdq.dequant_matmul(xj, _j(codes), _j(scale), _j(zp), _j(b),
                             jfmt(fmt), g, out_dtype=jnp.float32,
                             pack_layout=layout)
    out = tdq.dequant_matmul(xt, _t(codes), _t(scale), _t(zp), _t(b),
                             tfmt(fmt), g, out_dtype=torch.float32,
                             pack_layout=layout)
    return out, ref


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16,
                                 torch.float16])
@pytest.mark.parametrize("g", [128, -1])
def test_e5m2_codes_vs_jax(interpret, g, xdt):
    """Native e5m2 codes (grouped and rowwise), the GEMV's plain version at
    1 and 5 rows and the tiles' at 40."""
    k = 1024
    jq, codes, scale, zp = _weight("float8_e5m2", k, g, k + 7)
    assert codes.dtype.name == "float8_e5m2" and jq.meta.fmt == "float8_e5m2"
    b = np.random.default_rng(1).normal(size=(96,)).astype(np.float32)
    gsize = k // scale.shape[1]
    for m in (1, 5, 40):
        xt, xj = _x(m, k, m, xdt)
        out, ref = _both(xt, xj, jq, codes, scale, zp, b, "float8_e5m2",
                         gsize, "bitplane")
        _close(out.numpy(), ref)


@pytest.mark.parametrize("fmt,g,layout", [
    ("int8", 128, None), ("uint8", 256, None), ("int8", -1, None),
    ("float8_e3m4fn", 1024, "bitplane"), ("float9_e3m5fn", -1, "bitplane"),
    ("uint4", 128, "halfsplit"), ("float5_e2m2fn", 128, "halfsplit")])
def test_fp16_x_vs_jax(interpret, fmt, g, layout):
    """fp16 x: B2 on unpacked codes (grouped, with a zero point, rowwise)
    and bit-plane codes at 1 and 40 rows, B5 (half-split) at 40 rows (B6,
    at 1, reads x as fp32: exact); each scaled weight rounded to fp16."""
    k = 2048
    jq, codes, scale, zp = _weight(fmt, k, g, k + len(fmt))
    if layout is not None:
        assert jq.meta.pack_layout == layout
    b = np.random.default_rng(2).normal(size=(96,)).astype(np.float32)
    gsize = k // scale.shape[1]
    for m in (1, 40):
        xt, xj = _x(m, k, m + 3, torch.float16)
        out, ref = _both(xt, xj, jq, codes, scale, zp, b, fmt, gsize,
                         layout or "bitplane")
        _close(out.numpy(), ref)


@pytest.mark.parametrize("fmt,g,layout", [
    ("int8", 128, "bitplane"), ("float8_e3m4fn", 1024, "bitplane"),
    ("uint4", 128, "halfsplit")])
def test_fp16_rounding_point_pinned(interpret, fmt, g, layout):
    """The card's old cast (x and the weight rounded to bf16 for an fp16
    x) differs from the JAX package's fp16 function by more than 2^-10 of
    the largest output; the fp16 plain version agrees to fp32 rounding."""
    k, m = 2048, 40
    jq, codes, scale, zp = _weight(fmt, k, g, k + 11)
    b = np.zeros((96,), np.float32)
    gsize = k // scale.shape[1]
    xt, xj = _x(m, k, 9, torch.float16)
    out, ref = _both(xt, xj, jq, codes, scale, zp, b, fmt, gsize, layout)
    lim = 2 ** -10 * float(np.abs(ref).max())
    assert float(np.abs(out.numpy() - ref).max()) <= lim / 8
    old = tdq.dequant_matmul(xt.bfloat16(), _t(codes), _t(scale), _t(zp),
                             _t(b), tfmt(fmt), gsize,
                             out_dtype=torch.float32, pack_layout=layout)
    # (B5's codes enter exactly in both types: there bf16 x alone moves it)
    assert float(np.abs(old.numpy() - ref).max()) > lim
