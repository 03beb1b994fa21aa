"""The decode-once design of B2's tiles and B5 on the CPU.

``decode_weight``'s plain version (the bf16 weight W' that the card's
decode kernel writes once a call) against the JAX package's decoded
weights, bit for bit in bf16:

* unpacked and bit-plane codes (B2's grouped, rowwise and packed modes):
  the JAX ``dequant_matmul`` of an identity x, so that each output is one
  weight as the JAX kernel rounds it (its Pallas body in interpret mode,
  or its XLA route where the Pallas body does not take the shape);
* half-split codes (B5): the raw codes of ``unpack_codes_halfsplit`` or
  the minifloat values of ``decode_float``.

The packed codes come from the port's ``quantize_tensor`` (its bytes equal
the JAX package's, tests/test_torch_packing.py), which is fast in eager
torch.  Then "plain decode, then the GEMM's plain version" against
``dequant_mm_plain`` and ``groupdot_mm_plain`` on the same seeded inputs:
equal, since both compute the same fp32 products and folds in the same
order."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.formats import get_format as jfmt
from sdnq_tpu.packing import decode_float as jdecode_float
from sdnq_tpu.packing import unpack_codes_halfsplit as junpack_halfsplit
from sdnq_tpu_torch import quantize_tensor
from sdnq_tpu_torch.convert import tensor_from_numpy
from sdnq_tpu_torch.formats import get_format as tfmt

jdq = importlib.import_module("sdnq_tpu.kernels.dequant_mm")
tdq = importlib.import_module("sdnq_tpu_torch.kernels.dequant_mm")


@pytest.fixture
def backend(monkeypatch, request):
    """The JAX package's kernel backend; its jitted kernel wrappers read it
    while tracing, so their caches are cleared around each test."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", request.param)
    jdq._dequant_mm_pallas.clear_cache()
    yield request.param
    jdq._dequant_mm_pallas.clear_cache()


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bf16_bits(a):
    """bf16 values (as float32 arrays or tensors) as their 16-bit patterns."""
    t = torch.as_tensor(np.asarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16)


def _same_weights(got, want):
    """``got`` (bf16) and the JAX weight ``want`` (float32) hold the same
    bf16 numbers bit for bit, -0 read as +0: the identity product below
    returns a -0 weight as +0 (-0 * 1 + 0 * w = +0)."""
    assert got.dtype == torch.bfloat16
    plus = (got.float() + 0.0).to(torch.bfloat16)
    return torch.equal(plus.view(torch.int16), _bf16_bits(want))


def _jax_weight(codes, scale, zp, fmt, g, k):
    """The JAX kernel's decoded weight (O, K) as float32: its product with
    an identity x in bf16 (each output one weight times 1)."""
    eye = jnp.eye(k, dtype=jnp.bfloat16)
    out = jdq.dequant_matmul(eye, _j(codes), _j(scale), _j(zp), None,
                             jfmt(fmt), g, out_dtype=jnp.float32)
    return np.asarray(out).T


def _unpacked(fmt, o, k, groups, seed):
    rng = np.random.default_rng(seed)
    if fmt == "float8_e4m3fn":
        codes = np.asarray(jnp.asarray(rng.normal(size=(o, k)) * 40,
                                       jnp.float32).astype(jnp.float8_e4m3fn))
    elif fmt == "uint8":
        codes = rng.integers(0, 256, (o, k)).astype(np.uint8)
    else:
        codes = rng.integers(-127, 128, (o, k)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, (o, groups)) * 1e-2).astype(np.float32)
    zp = ((rng.normal(size=(o, groups)) - 1.28) * 1e-1).astype(np.float32) \
        if fmt == "uint8" else None
    return codes, scale, zp


# uint8's zero point only on the interpret backend: the XLA route rounds
# code * scale and + zp apart (tests/test_torch_weight_only.py), and the
# kernel's function is the fused one
@pytest.mark.parametrize("fmt,backend", [
    ("int8", "interpret"), ("uint8", "interpret"),
    ("float8_e4m3fn", "interpret"), ("int8", "xla"),
    ("float8_e4m3fn", "xla")], indirect=["backend"])
def test_decode_unpacked_grouped_vs_jax(fmt, backend):
    """B2 grouped: each weight code * scale (+ zp) rounded to bf16, as the
    JAX kernel rounds it (K 256, groups of 128)."""
    o, k, g = 64, 256, 128
    codes, scale, zp = _unpacked(fmt, o, k, k // g, 1)
    want = _jax_weight(codes, scale, zp, fmt, g, k)
    got = tdq.decode_weight_plain(tensor_from_numpy(codes, "cpu"), k,
                                  _t(scale), _t(zp))
    assert got.shape == (o, k)
    assert _same_weights(got, want)


@pytest.mark.parametrize("fmt,k", [("int8", 200), ("uint8", 77),
                                   ("float8_e4m3fn", 256)])
def test_decode_unpacked_row_mode_exact(fmt, k):
    """B2's row mode: W' holds the codes themselves (exact in bf16), with
    K rounded up to 8 and the padding 0."""
    codes, _, _ = _unpacked(fmt, 40, k, 1, 2)
    tc = tensor_from_numpy(codes, "cpu")
    got = tdq.decode_weight_plain(tc, k)
    assert got.shape == (40, -(-k // 8) * 8)
    ref = np.asarray(jnp.asarray(codes).astype(jnp.float32))
    assert torch.equal(got[:, :k].float(), torch.from_numpy(ref))
    assert not got[:, k:].any()


def _packed(fmt, o, k, g, seed, layout):
    """Codes, scale (O, G) and zero point of seeded weights with a few
    outliers, as numpy."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(o, k)) * (1 + 6 * (rng.random((o, k)) > 0.99))
    q = quantize_tensor(torch.from_numpy(w.astype(np.float32) * 0.02), fmt,
                        group_size=g)
    assert q.meta.pack_layout == layout
    zp = None if q.zero_point is None else q.zero_point.reshape(o, -1).numpy()
    return q.qdata.numpy(), q.scale.reshape(o, -1).numpy(), zp


@pytest.mark.parametrize("fmt,k,g,backend", [
    ("float8_e3m4fn", 1024, 1024, "interpret"),
    ("uint10", 1024, 256, "interpret"),
    ("float9_e3m5fn", 1000, -1, "xla"),
    ("int9", 200, 40, "xla")], indirect=["backend"])
def test_decode_bitplane_vs_jax(fmt, k, g, backend):
    """B2's packed mode on bit-plane codes: integers and minifloats, zero
    points (uint10), rowwise scales (float9), and K / 8 not a multiple of
    4 (1000, 200) on the XLA route."""
    codes, scale, zp = _packed(fmt, 48, k, g, k + g, "bitplane")
    assert backend == "interpret" or zp is None  # as above
    gsize = k // scale.shape[1]
    want = _jax_weight(codes, scale, zp, fmt, gsize, k)
    got = tdq.decode_weight_plain(_t(codes), k, _t(scale), _t(zp),
                                  tfmt(fmt), "bitplane")
    assert got.shape == (48, -(-k // 8) * 8)
    assert _same_weights(got[:, :k], want)
    assert not got[:, k:].any()


@pytest.mark.parametrize("fmt,k", [
    ("uint4", 256), ("int4", 512), ("uint2", 512), ("uint1", 1024),
    ("uint3", 256), ("uint5", 512), ("int6", 512), ("uint7", 256),
    ("float5_e2m2fn", 512), ("float6_e3m3fnu", 256), ("float4_e2m1fn", 256),
    ("float7_e3m3fn", 512)])
def test_decode_halfsplit_vs_jax(fmt, k):
    """B5: the raw integer codes (code_min enters through zpc) or the
    minifloat values of half-split codes in one to three field planes."""
    packed = _packed(fmt, 32, k, 32, k, "halfsplit")[0]
    f = jfmt(fmt)
    codes = junpack_halfsplit(jnp.asarray(packed), f.code_bits, k)
    ref = (np.asarray(codes, dtype=np.float32) if f.is_integer
           else np.asarray(jdecode_float(codes, f), dtype=np.float32))
    got = tdq.decode_weight_plain(_t(packed), k, fmt=tfmt(fmt),
                                  layout="halfsplit")
    assert torch.equal(got.view(torch.int16), _bf16_bits(ref))


def _x(m, k, seed):
    x = np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("fmt,k,groups", [("int8", 200, 5),
                                          ("uint8", 256, 2),
                                          ("float8_e4m3fn", 77, 1)])
def test_decode_then_gemm_equals_dequant_mm_plain(fmt, k, groups):
    """B2's tiles on the card: decode once, then the GEMM with the bias
    epilogue (grouped) or the row epilogue (rowwise)."""
    o, m = 72, 40
    codes, scale, zp = _unpacked(fmt, o, k, groups, 3)
    tc, s, z = tensor_from_numpy(codes, "cpu"), _t(scale), _t(zp)
    bias = torch.from_numpy(np.random.default_rng(4).normal(
        size=(o,)).astype(np.float32))
    x = _x(m, k, 5)
    want = tdq.dequant_mm_plain(x, tc, s, z, bias, torch.float32)
    if groups == 1:
        w = tdq.decode_weight_plain(tc, k)
        got = tdq.wgmma_mm_plain(x, w, k, "row", bias, s.reshape(-1),
                                 None if z is None else z.reshape(-1),
                                 x.float().sum(-1), torch.float32)
    else:
        w = tdq.decode_weight_plain(tc, k, s, z)
        got = tdq.wgmma_mm_plain(x, w, k, "bias", bias,
                                 out_dtype=torch.float32)
    assert torch.equal(got, want)


def test_decode_then_gemm_equals_bitplane_plain():
    k = 1000
    codes, scale, zp = (_t(a) for a in _packed("uint10", 64, k, 200, 6,
                                               "bitplane"))
    x = _x(33, k, 7)
    f = tfmt("uint10")
    want = tdq.dequant_mm_plain(x, codes, scale, zp, None, torch.float32, f)
    w = tdq.decode_weight_plain(codes, k, scale, zp, f, "bitplane")
    got = tdq.wgmma_mm_plain(x, w, k, out_dtype=torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fmt,k,g", [("uint4", 256, 128), ("int4", 512, 32),
                                     ("uint5", 512, 64), ("int6", 1024, 256),
                                     ("float5_e2m2fn", 512, 128)])
def test_decode_then_fold_equals_groupdot_mm_plain(fmt, k, g):
    """B5 on the card: decode the half-split codes once, then the GEMM
    whose epilogue folds each group's product with its scale and the
    zero-point term, as the group-dot plain version does."""
    rng = np.random.default_rng(k + g)
    f = tfmt(fmt)
    codes, scale, zp = (_t(a) for a in _packed(fmt, 80, k, g, k + g,
                                               "halfsplit"))
    s, zpc = tdq._group_operands(scale, zp, f)
    bias = torch.from_numpy(rng.normal(size=(80,)).astype(np.float32))
    x = _x(48, k, 8)
    want = tdq.groupdot_mm_plain(x, codes, s, zpc, bias, f.code_bits,
                                 torch.float32, f)
    w = tdq.decode_weight_plain(codes, k, fmt=f, layout="halfsplit")
    xsum = x.float().reshape(48, k // g, g).sum(-1)
    got = tdq.wgmma_mm_plain(x, w, k, "fold", bias, s, zpc, xsum,
                             torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("fmt,k,g", [("uint4", 256, 128), ("int4", 512, 64),
                                     ("int2", 512, 128), ("uint3", 1024, 128),
                                     ("int5", 512, 64), ("int6", 768, 192),
                                     ("uint7", 1024, 256)])
def test_decode_i8_then_fold_equals_groupdot_i8_mm_plain(fmt, k, g):
    """B7 on the card: decode the half-split codes once into int8 (the raw
    codes, as the JAX package unpacks them), then the int8 GEMM whose
    epilogue folds each group's integer product: plain decode then plain
    GEMM equal ``groupdot_i8_mm_plain`` bit for bit."""
    rng = np.random.default_rng(k + g)
    f = tfmt(fmt)
    codes, scale, zp = (_t(a) for a in _packed(fmt, 80, k, g, k + g,
                                               "halfsplit"))
    s, zpc = tdq._group_operands(scale, zp, f)
    bias = torch.from_numpy(rng.normal(size=(80,)).astype(np.float32))
    xq = torch.from_numpy(rng.integers(-127, 128, (48, k)).astype(np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 2e-2, (48, 1)).astype(np.float32))
    w = tdq.decode_weight_plain(codes, k, fmt=f, layout="halfsplit",
                                dtype=torch.int8)
    ref = np.asarray(junpack_halfsplit(jnp.asarray(codes.numpy()),
                                       f.code_bits, k))
    assert w.dtype == torch.int8 and np.array_equal(w.numpy(), ref)
    want = tdq.groupdot_i8_mm_plain(xq, xs, codes, s, zpc, bias, f.code_bits,
                                    torch.float32)
    xsum = xq.to(torch.int32).reshape(48, k // g, g).sum(-1).float()
    got = tdq.wgmma_mm_plain(xq, w, k, "fold_i8", bias, s, zpc, xsum,
                             torch.float32, xs=xs)
    assert torch.equal(got, want)
