"""B2's grouped and many-row modes and B3's additive float masks on the CPU
(the kernels' plain versions), against the JAX package on the same numpy
inputs.

B2 (``dequant_matmul`` on unpacked codes):

* Grouped scales (int8, uint8 with a zero point, e4m3; g 128 and 1024; M
  1, 5, 40 and 77) against the JAX Pallas body in interpret mode and its
  XLA route: both round ``code * scale + zp`` to x's dtype (bf16) and
  multiply in fp32.  The port does the same, so the outputs (fp32) differ
  by the summation order alone: 1e-5 of the sum of |terms| of each
  output.  ``code * scale + zp`` is one fused multiply-add in XLA's
  compile of the interpret body and in the port; the XLA route rounds the
  product first, and where that moves a weight's bf16 rounding (a few in
  10^5) the test adds exactly the moved weights' share, |x| @ |Δw|ᵀ.
* Rowwise codes at 77 rows in bf16 against the interpret body
  (``row_epi``: the codes enter the bf16 product exactly, the scale after
  it), output bf16: within one bf16 ulp of each output.  The XLA route,
  which rounds the scaled weight first, is shown to differ from both: the
  bf16 rounding point is pinned.

B3 (``quantized_attention`` with a float ``attn_mask``): a T5 relative
position bias (1, H, N, N), bf16 and int8 Q·K, one query row masked by
-inf everywhere.  Against the JAX Pallas body in interpret mode at N = 128
(the kernel route on both sides; P rounded to bf16 against a running max
there and the final max in the plain version: 1e-2 of max |v|, as the
unmasked mode), where the -inf row gives 0 on both; and against the JAX XLA
function at N = 96 (``attention_xla`` on both sides; the same fp32
operations, products in float64 in the port: rtol 1e-5 plus 2e-5 of max
|out|)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.formats import get_format as jfmt
from sdnq_tpu.kernels.attention import quantized_attention as jattn
from sdnq_tpu.kernels.dequant_mm import dequant_matmul as jdm
from sdnq_tpu.models.text_encoder import _rel_bucket as jbucket
from sdnq_tpu_torch.convert import tensor_from_numpy
from sdnq_tpu_torch.formats import get_format as tfmt
from sdnq_tpu_torch.kernels.attention import quantized_attention as tattn
from sdnq_tpu_torch.kernels.dequant_mm import dequant_matmul as tdm
from sdnq_tpu_torch.models.text_encoder import _rel_bucket as tbucket

FMT_CODES = {"int8": (-127, 128, np.int8), "uint8": (0, 256, np.uint8),
             "float8_e4m3fn": None}


def _weight(fmt, o, k, g, seed):
    """Codes (O, K), scale (O, G) and a zero point (uint8) as numpy."""
    rng = np.random.default_rng(seed)
    if fmt == "float8_e4m3fn":
        codes = np.asarray(jnp.asarray(rng.normal(size=(o, k)) * 40,
                                       jnp.float32).astype(jnp.float8_e4m3fn))
    else:
        lo, hi, dt = FMT_CODES[fmt]
        codes = rng.integers(lo, hi, (o, k)).astype(dt)
    scale = (rng.uniform(0.5, 1.5, (o, k // g)) * 1e-2).astype(np.float32)
    zp = ((rng.normal(size=(o, k // g)) - 128) * 1e-2).astype(np.float32) \
        if fmt == "uint8" else None
    return codes, scale, zp


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _jx(x_bf16):
    return jnp.asarray(x_bf16.float().numpy()).astype(jnp.bfloat16)


def _port(x, codes, scale, zp, bias, fmt, g, out_dtype=torch.float32):
    c = tensor_from_numpy(codes, "cpu")
    return tdm(x, c, torch.from_numpy(scale),
               None if zp is None else torch.from_numpy(zp),
               torch.from_numpy(bias), tfmt(fmt), g, out_dtype=out_dtype)


def _jax(x, codes, scale, zp, bias, fmt, g, out_dtype=jnp.float32):
    return np.asarray(jdm(_jx(x), jnp.asarray(codes), jnp.asarray(scale),
                          None if zp is None else jnp.asarray(zp),
                          jnp.asarray(bias), jfmt(fmt), g,
                          out_dtype=out_dtype).astype(jnp.float32))


@pytest.mark.parametrize("route", ["interpret", "xla"])
@pytest.mark.parametrize("g,k", [(128, 256), (1024, 3072)])
@pytest.mark.parametrize("fmt", ["int8", "uint8", "float8_e4m3fn"])
def test_grouped_vs_jax(monkeypatch, fmt, g, k, route):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", route)
    o = 96
    codes, scale, zp = _weight(fmt, o, k, g, seed=g + k)
    rng = np.random.default_rng(3)
    bias = rng.normal(size=(o,)).astype(np.float32)
    cf = tensor_from_numpy(codes, "cpu").float().numpy()
    prod = (cf.reshape(o, -1, g) * scale[..., None]).astype(np.float32)
    w = prod.reshape(o, k)
    moved = np.zeros_like(w)
    if zp is not None:
        w = (cf.reshape(o, -1, g).astype(np.float64) * scale[..., None]
             + zp[..., None]).astype(np.float32).reshape(o, k)
        if route == "xla":
            sep = (prod + zp[..., None]).reshape(o, k)
            moved = np.abs(_bf16(sep).float().numpy()
                           - _bf16(w).float().numpy())
    for m in (1, 5, 40, 77):
        x = _bf16(rng.normal(size=(m, k)).astype(np.float32))
        out = _port(x, codes, scale, zp, bias, fmt, g).numpy()
        ref = _jax(x, codes, scale, zp, bias, fmt, g)
        ax = np.abs(x.float().numpy())
        bound = 1e-5 * (ax @ np.abs(w).T + np.abs(bias)) + ax @ moved.T
        assert (np.abs(out - ref) <= bound + 1e-6).all(), (
            m, np.abs(out - ref).max())


def test_rowwise_bf16_rounding_point(monkeypatch):
    """Rowwise uint8 codes with a zero point at 77 rows (the tile kernel's
    row mode), bf16 in and out."""
    o, k, m = 96, 768, 77
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, (o, k)).astype(np.uint8)
    scale = (rng.uniform(0.5, 1.5, (o, 1)) * 1e-2).astype(np.float32)
    zp = (-128 * scale * (1 + 0.1 * rng.normal(size=(o, 1)))).astype(
        np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    x = _bf16(rng.normal(size=(m, k)).astype(np.float32))
    out = _port(x, codes, scale, zp, bias, "uint8", -1,
                torch.bfloat16).float().numpy()
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    ref = _jax(x, codes, scale, zp, bias, "uint8", -1, jnp.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)
    assert (np.abs(out - ref) <= ulp).all(), np.abs(out - ref).max()
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "xla")
    xla = _jax(x, codes, scale, zp, bias, "uint8", -1, jnp.bfloat16)
    assert (np.abs(xla - ref) > ulp).any()


def test_rel_bucket_table_integer_equal():
    """T5's bucket table (XLA's fp32 log and the port's torch.log) is
    integer-equal at the pipeline's 512 tokens."""
    pos = np.arange(512)
    rel = pos[None, :] - pos[:, None]
    ref = np.asarray(jbucket(jnp.asarray(rel), 32, 128))
    out = tbucket(torch.from_numpy(rel), 32, 128).numpy()
    np.testing.assert_array_equal(out, ref)


def _t5_bias(h, n, seed):
    """A T5-style additive mask: a learned (32, H) table gathered by the
    bucket table, (1, H, n, n), with query row 3 masked by -inf."""
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(32, h)) * 2).astype(np.float32)
    pos = np.arange(n)
    b = np.asarray(jbucket(jnp.asarray(pos[None, :] - pos[:, None]), 32,
                           128))
    bias = table[b].transpose(2, 0, 1)[None].copy()
    bias[:, :, 3, :] = -np.inf
    return bias


def _qkv(d, n, h, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = (rng.normal(size=(1, h, n, d)) * scale).astype(np.float32)
        out.append(torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    return out


@pytest.mark.parametrize("mode", [None, "int8"])
@pytest.mark.parametrize("mask_dtype", [np.float32, "bfloat16"])
def test_float_mask_vs_kernel_interpret(monkeypatch, mode, mask_dtype):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    h, n, d = 4, 128, 64
    q, k, v = _qkv(d, n, h, seed=7)
    bias = _t5_bias(h, n, seed=8)
    jb = jnp.asarray(bias)
    tb = torch.from_numpy(bias)
    if mask_dtype == "bfloat16":
        jb, tb = jb.astype(jnp.bfloat16), tb.to(torch.bfloat16)
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           attn_mask=jb, scale=1.0, matmul_dtype=mode)
                     ).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if mode is None:  # bf16 operands, as the JAX kernel path casts them
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
    out = tattn(tq, tk, tv, attn_mask=tb, scale=1.0,
                matmul_dtype=mode).float().numpy()
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    assert not out[:, :, 3].any() and not ref[:, :, 3].any()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2 * np.abs(v).max())
    # a version that ignored the mask would not pass
    plain = tattn(tq, tk, tv, scale=1.0, matmul_dtype=mode).float().numpy()
    assert np.abs(plain - ref).max() > 10 * 1e-2 * np.abs(v).max()


@pytest.mark.parametrize("mode", [None, "int8"])
def test_float_mask_vs_xla(monkeypatch, mode):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "xla")
    h, n, d = 4, 96, 64
    q, k, v = _qkv(d, n, h, seed=9)
    bias = _t5_bias(h, n, seed=10)
    bias[:, :, 3, :] = 0.0   # the XLA function's softmax is NaN on -inf rows
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           attn_mask=jnp.asarray(bias), scale=1.0,
                           matmul_dtype=mode))
    out = tattn(*(torch.from_numpy(a) for a in (q, k, v)),
                attn_mask=torch.from_numpy(bias), scale=1.0,
                matmul_dtype=mode).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=2e-5 * np.abs(ref).max())
