"""Packing codecs: the port's bytes against the JAX package's.

The same seeded numpy codes and values go to ``sdnq_tpu.packing`` and
``sdnq_tpu_torch.packing``; packed bytes, unpacked codes and values, and
minifloat codes must be identical, so that storage written by either
package loads in the other."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu import packing as jp
from sdnq_tpu.formats import get_format as jfmt
from sdnq_tpu_torch import packing as tp
from sdnq_tpu_torch.formats import get_format as tfmt

# the packed integer formats (widths 8 and 16 are native formats; the codec
# test covers those widths)
INT_FMTS = ([f"int{k}" for k in range(2, 8)]
            + [f"uint{k}" for k in range(1, 8)] + ["int12", "uint12"])
FLOAT_FMTS = ["float4_e2m1fn", "float4_e2m2fnu", "float6_e3m2fn",
              "float6_e2m3fn", "float5_e3m1fn", "float8_e4m3fn_sdnq",
              "float8_e5m2fn", "float3_e1m1fn"]


def _same(a_jax, b_torch):
    np.testing.assert_array_equal(b_torch.numpy(), np.asarray(a_jax))


@pytest.mark.parametrize("bits,c", [(b, 40) for b in (1, 2, 3, 4, 5, 6, 7, 8,
                                                     12, 16)]
                         + [(3, 13), (12, 13)])
def test_codecs_byte_equal(bits, c):
    codes = np.random.default_rng(bits * c).integers(
        0, 2 ** bits, (3, 5, c)).astype(np.int32)
    jc, tc = jnp.asarray(codes), torch.from_numpy(codes)
    packed = tp.pack_codes(tc, bits)
    _same(jp.pack_codes(jc, bits), packed)
    _same(jp.unpack_codes(jnp.asarray(packed.numpy()), bits, c),
          tp.unpack_codes(packed, bits, c))
    assert torch.equal(tp.unpack_codes(packed, bits, c), tc)
    if bits <= 8 and c % 8 == 0:
        hs = tp.pack_codes_halfsplit(tc, bits)
        _same(jp.pack_codes_halfsplit(jc, bits), hs)
        assert torch.equal(tp.unpack_codes_halfsplit(hs, bits, c), tc)


def test_halfsplit_planes_equal():
    for bits in range(1, 9):
        assert tp.halfsplit_planes(bits) == jp.halfsplit_planes(bits)


@pytest.mark.parametrize("fmt,layout", [
    (f, lay) for f in INT_FMTS for lay in ("bitplane", "halfsplit")
    if lay == "bitplane" or jfmt(f).code_bits <= 8])
def test_pack_int_formats(fmt, layout):
    jf, tf = jfmt(fmt), tfmt(fmt)
    q = np.random.default_rng(len(fmt)).integers(
        int(jf.min), int(jf.max) + 1, (6, 48)).astype(np.int32)
    packed = tp.pack(torch.from_numpy(q), tf, layout=layout)
    _same(jp.pack(jnp.asarray(q), jf, layout=layout), packed)
    vals = tp.unpack(packed, tf, 48, layout=layout)
    _same(jp.unpack(jnp.asarray(packed.numpy()), jf, 48, layout=layout),
          vals)
    np.testing.assert_array_equal(vals.numpy(), q)


def _float_inputs(jf, seed):
    """Every grid value, every midpoint between neighbours (ties), values
    a quarter ulp off the midpoints, subnormal-range values and random
    in-range values, clamped to the format's range."""
    codes = np.arange(2 ** jf.num_bits, dtype=np.int32)
    grid = np.unique(np.asarray(jp.decode_float(jnp.asarray(codes), jf)))
    mids = (grid[:-1] + grid[1:]) / 2
    gaps = np.diff(grid)
    tiny = 2.0 ** (1 - jf.bias) * np.array([0.1, 0.26, 0.49, 0.5, 0.51, 1.5])
    rng = np.random.default_rng(seed)
    x = np.concatenate([grid, mids, mids + gaps / 4, mids - gaps / 4,
                        tiny, -tiny, rng.uniform(jf.min, jf.max, 200)])
    x = np.clip(x, jf.min, jf.max).astype(np.float32)
    return np.resize(x, 1024)   # one length for every format: one compile


@pytest.mark.parametrize("fmt", FLOAT_FMTS)
def test_minifloat_codec_equal(fmt):
    jf, tf = jfmt(fmt), tfmt(fmt)
    x = _float_inputs(jf, 1)
    codes = tp.encode_float(torch.from_numpy(x), tf)
    _same(jp.encode_float(jnp.asarray(x), jf), codes)
    _same(jp.decode_float(jnp.asarray(codes.numpy()), jf),
          tp.decode_float(codes, tf))
    xr = x.reshape(2, -1)
    for layout in ("bitplane", "halfsplit"):
        packed = tp.pack(torch.from_numpy(xr), tf, layout=layout)
        _same(jp.pack(jnp.asarray(xr), jf, layout=layout), packed)
        _same(jp.unpack(jnp.asarray(packed.numpy()), jf, xr.shape[1],
                        layout=layout),
              tp.unpack(packed, tf, xr.shape[1], layout=layout))


@pytest.mark.parametrize("fmt", ["float4_e2m1fn", "float6_e3m2fn",
                                 "float8_e4m3fn_sdnq"])
def test_encode_float_stochastic_bits(fmt):
    """Stochastic rounding with the same uint32 bits fed to both sides
    (torch holds them in int64)."""
    jf, tf = jfmt(fmt), tfmt(fmt)
    x = _float_inputs(jf, 2)
    bits = np.random.default_rng(3).integers(0, 2 ** 32, x.shape,
                                             dtype=np.uint64)
    want = jp.encode_float(jnp.asarray(x), jf,
                           sr_bits=jnp.asarray(bits.astype(np.uint32)))
    got = tp.encode_float(torch.from_numpy(x), tf,
                          sr_bits=torch.from_numpy(bits.astype(np.int64)))
    _same(want, got)
    # uint32 bits handed over as int32 (the same 32 bits) read the same
    got32 = tp.encode_float(torch.from_numpy(x), tf, sr_bits=torch.from_numpy(
        bits.astype(np.uint32).view(np.int32)))
    assert torch.equal(got32, got)


def test_pack_rejects_native_formats():
    with pytest.raises(ValueError, match="not a packed format"):
        tp.pack(torch.zeros(2, 8, dtype=torch.int32), tfmt("int8"))
