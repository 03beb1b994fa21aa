"""Port vs JAX package: format registry, quantization math, QTensor, config.

Inputs come from seeded numpy and go to both packages.  Integer codes and
fp8 values are compared bit for bit; scales exactly (the same fp32
operations in the same order)."""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu.formats import ACCEPTED_WEIGHT_DTYPES as J_WEIGHT_DTYPES
from sdnq_tpu.quant import core as jcore
from sdnq_tpu_torch.formats import ACCEPTED_WEIGHT_DTYPES as T_WEIGHT_DTYPES
from sdnq_tpu_torch.quant import core as tcore

_FIELDS = ("name", "num_bits", "is_integer", "is_unsigned", "exponent",
           "mantissa", "min", "max", "is_packed", "storage_dtype")


def test_registry_equal():
    assert set(T.FORMATS) == set(J.FORMATS)
    for name, jf in J.FORMATS.items():
        tf = T.FORMATS[name]
        for f in _FIELDS:
            assert getattr(tf, f) == getattr(jf, f), (name, f)
        assert (tf.bias, tf.code_bits, tf.sign_bits) == \
            (jf.bias, jf.code_bits, jf.sign_bits)
        if not tf.is_packed:
            assert str(tf.torch_storage).split(".")[-1] == \
                jnp.dtype(jf.storage_dtype).name
    assert T.WEIGHTS_DTYPE_ORDER == J.WEIGHTS_DTYPE_ORDER
    assert T.ACCEPTED_MATMUL_DTYPES == J.ACCEPTED_MATMUL_DTYPES
    assert T_WEIGHT_DTYPES == J_WEIGHT_DTYPES
    for alias in ("fp8", "bf16", "ufp4", "fp6", "int1", "bool"):
        assert T.resolve_alias(alias) == J.resolve_alias(alias)
    for name in ("int8", "uint8", "int4", "float8_e4m3fn", "fp6", "float16"):
        assert T.default_matmul_format(name) == J.default_matmul_format(name)


def _x(shape, seed=0, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    x.flat[::7] = 0.0           # exact zeros and a zero row exercise floors
    x[..., 1, :] = 0.0
    return x.astype(np.float32)


def _bits(a):
    """fp8 values as their bytes; integer codes as they are."""
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


@pytest.mark.parametrize("fmt", ["int8", "uint8", "int4", "uint4", "int12",
                                 "float8_e4m3fn", "float8_e5m2"])
def test_quantize_weight_bit_equal(fmt):
    x = _x((6, 4, 32), seed=1, scale=3.0)
    jq, js, jz = jcore.quantize_weight(jnp.asarray(x), fmt, axis=(2,))
    tq, ts, tz = tcore.quantize_weight(torch.from_numpy(x), fmt, dims=(2,))
    np.testing.assert_array_equal(_bits(tq.numpy() if tq.dtype not in (
        torch.float8_e4m3fn, torch.float8_e5m2) else tq.view(torch.uint8)
        .numpy()), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tz is None) == (jz is None)
    if tz is not None:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("kind", ["int", "uint", "fp"])
def test_activation_quantizers_bit_equal(kind):
    # values exactly halfway between codes test round-half-to-even
    x = _x((33, 96), seed=2, scale=2.0)
    x[3, :] = np.arange(96, dtype=np.float32) - 47.5
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if kind == "int":
        (jq, js), (tq, ts) = jcore.quantize_int_mm(jx), \
            tcore.quantize_int_mm(tx)
        jz = tz = None
    elif kind == "uint":
        (jq, js, jz), (tq, ts, tz) = jcore.quantize_uint_mm(jx), \
            tcore.quantize_uint_mm(tx)
    else:
        (jq, js), (tq, ts) = jcore.quantize_fp_mm(jx), tcore.quantize_fp_mm(tx)
        jz = tz = None
        tq = tq.view(torch.uint8)
    np.testing.assert_array_equal(tq.numpy(), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if jz is not None:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("fmt,qmm,gs,had", [
    ("int8", True, 0, False), ("uint8", True, 0, False),
    ("float8_e4m3fn", True, 0, False), ("int8", False, 0, False),
    ("int8", False, 32, False), ("int8", True, 0, True),
    ("float16", True, 0, False),
    # packed: half-split codes (bytes, scale, zp, meta and pack_layout)
    ("uint4", False, 0, False), ("int4", True, 0, False),
    ("int2", False, 16, False), ("uint4", True, 32, True),
    ("int3", False, 0, False), ("float4_e2m1fn", False, 0, False),
    ("float6_e3m2fn", True, 0, False), ("int12", False, 0, False)])
def test_quantize_tensor_equal(fmt, qmm, gs, had):
    w = _x((48, 128), seed=3)
    jt = J.quantize_tensor(jnp.asarray(w), fmt, use_quantized_matmul=qmm,
                           group_size=gs, use_hadamard=had)
    tt = T.quantize_tensor(torch.from_numpy(w), fmt, use_quantized_matmul=qmm,
                           group_size=gs, use_hadamard=had)
    assert dataclasses.asdict(tt.meta) == dataclasses.asdict(jt.meta)
    tq = tt.qdata
    if tq.dtype in (torch.float8_e4m3fn, torch.bfloat16):
        tq = tq.view(torch.uint8 if tq.element_size() == 1 else torch.int16)
    jqd = np.asarray(jt.qdata)
    jqd = jqd.view(np.uint8 if jqd.dtype.itemsize == 1 else np.int16) \
        if jqd.dtype.name in ("float8_e4m3fn", "bfloat16") else jqd
    np.testing.assert_array_equal(tq.numpy(), jqd)
    # hadamard rotation reorders fp32 sums: scales within 2 ulp
    np.testing.assert_allclose(tt.scale.numpy(), np.asarray(jt.scale),
                               rtol=0 if not had else 3e-7)
    if jt.zero_point is not None:
        np.testing.assert_array_equal(tt.zero_point.numpy(),
                                      np.asarray(jt.zero_point))
    # dequantize: the same fp32 products (hadamard: fp32 matmul, 1e-6)
    np.testing.assert_allclose(tt.dequantize(torch.float32).numpy(),
                               np.asarray(jt.dequantize(jnp.float32)),
                               rtol=1e-6, atol=1e-6)


def test_packed_formats_raise():
    """Packed formats quantize now that the codecs are ported; packing a
    native format still raises.  Stochastic rounding of native fp8 weights
    is ported (tests/test_torch_options.py holds it against the JAX
    package's bits): it gives e4m3 values on the grid."""
    qt = T.quantize_tensor(torch.zeros(32, 64), "int4")
    assert qt.meta.pack_layout == "halfsplit"
    assert qt.qdata.dtype == torch.uint8 and qt.qdata.shape == (32, 32)
    from sdnq_tpu_torch.packing import pack
    with pytest.raises(ValueError, match="not a packed format"):
        pack(torch.zeros(2, 8, dtype=torch.int32), T.get_format("int8"))
    q, s, _ = tcore.quantize_weight(torch.ones(4, 8), "float8_e4m3fn",
                                    generator=torch.Generator().manual_seed(0))
    assert q.dtype == torch.float8_e4m3fn and q.shape == (4, 8)
    assert torch.equal(q.float() * s, torch.ones(4, 8))


@pytest.mark.parametrize("fmt", ["uint4", "int4", "int2"])
def test_packed_storage_same_under_quantized_matmul(fmt):
    """The stored tensors (codes, scales, zero points, SVD factors) do not
    depend on use_quantized_matmul; only that meta field differs.  So one
    quantized model serves both routes."""
    w = torch.from_numpy(_x((96, 256), seed=4))
    a, b = (T.quantize_tensor(w, fmt, use_svd=True, svd_rank=8,
                              use_quantized_matmul=qmm,
                              generator=torch.Generator().manual_seed(1))
            for qmm in (False, True))
    for f in ("qdata", "scale", "zero_point", "svd_up", "svd_down"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        assert x is None or torch.equal(x, y), f
    assert dataclasses.replace(a.meta, use_quantized_matmul=True) == b.meta
    # SVD layers group 2^(3 + bits) values (128 for 4-bit)
    assert a.meta.group_size == 2 ** (3 + T.get_format(fmt).num_bits)
    assert a.meta.pack_layout == "halfsplit"


def test_quantconfig_json_round_trip():
    jc = J.QuantConfig(weights_dtype="uint8", use_quantized_matmul=True,
                       modules_to_not_convert=["a.b"], group_size=64,
                       modules_dtype_dict={"int8": ["x"]})
    d = jc.to_dict()
    tc = T.QuantConfig.from_json(jc.to_json())
    assert tc.to_dict() == d
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    assert J.QuantConfig.from_json(tc.to_json()).to_dict() == d
    assert T.QuantConfig().to_dict() == J.QuantConfig().to_dict()


def test_convert_uint4_svd_qtensor():
    """A JAX uint4 + SVD QTensor (half-split packed codes, bf16 factors)
    carried into the port keeps every byte and its meta, and dequantizes to
    the same weight (fp32 products of the factors in another order)."""
    from sdnq_tpu_torch.convert import qtensor_from_numpy
    w = _x((96, 256), seed=5)
    jt = J.quantize_tensor(jnp.asarray(w), "uint4", use_svd=True, svd_rank=8)
    fields = {f: (None if getattr(jt, f) is None else np.asarray(
        getattr(jt, f))) for f in ("qdata", "scale", "zero_point", "svd_up",
                                   "svd_down")}
    tt = qtensor_from_numpy(fields, dataclasses.asdict(jt.meta), "cpu")
    assert tt.meta == T.QuantMeta(**dataclasses.asdict(jt.meta))
    assert tt.meta.pack_layout == "halfsplit" and tt.meta.svd_rank == 8
    assert tt.svd_up.dtype == tt.svd_down.dtype == torch.bfloat16
    for f, a in fields.items():
        b = getattr(tt, f)
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.int16), b.view(torch.int16)
        np.testing.assert_array_equal(b.numpy(), a)
    np.testing.assert_allclose(tt.dequantize(torch.float32).numpy(),
                               np.asarray(jt.dequantize(jnp.float32)),
                               rtol=1e-6, atol=1e-6)
