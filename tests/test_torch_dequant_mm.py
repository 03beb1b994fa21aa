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


# ---------------------------------------------------------------------------
# B5 / B6 / B7 on half-split codes: the port's plain versions (through its
# routing entry points) against the JAX Pallas bodies in interpret mode.
# fp32 unless stated: the same exact products summed in another order, so
# rtol 1e-5 plus 1e-5 of the largest output.
# ---------------------------------------------------------------------------

J = importlib.import_module("sdnq_tpu")
T = importlib.import_module("sdnq_tpu_torch")
J_LAYERS = importlib.import_module("sdnq_tpu.layers")


# the JAX package's jitted kernel wrappers; they read the backend and the
# mode switches while tracing, so their caches are cleared around each test
J_KERNEL_FNS = [getattr(jdq, n) for n in (
    "_dequant_mm_pallas", "_groupdot_mm_pallas", "_blockdiag_mm_pallas",
    "_groupdot_i8_mm_pallas", "_blockdiag_i8_mm_pallas")]


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas bodies through the interpreter."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    for fn in J_KERNEL_FNS:
        fn.clear_cache()
    yield monkeypatch
    for fn in J_KERNEL_FNS:
        fn.clear_cache()


def _packed(fmt, m, k, g, seed, o=160, x_dtype=np.float32):
    """Seeded x, bias and a JAX-quantized half-split weight, as numpy."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(o, k)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    jq = J.quantize_tensor(jnp.asarray(w), fmt, group_size=g)
    assert jq.meta.pack_layout == "halfsplit"
    scale = np.asarray(jq.scale).reshape(o, -1)
    zp = (None if jq.zero_point is None
          else np.asarray(jq.zero_point).reshape(o, -1))
    return x, np.array(jq.qdata), scale, zp, b


def _j(a, dtype=None):
    if a is None:
        return None
    a = jnp.asarray(a)
    return a if dtype is None else a.astype(dtype)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(out, ref):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(out, dtype=np.float32), ref,
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _bf16_ulps(out, ref, n):
    """|out - ref| within n bf16 ulps of the largest output."""
    ref = np.asarray(ref.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(out.float().numpy() - ref).max() <= n * ulp


@pytest.mark.parametrize("fmt,m,k,g,with_bias,mode", [
    ("uint4", 33, 256, 128, True, "groupdot"),
    ("uint4", 33, 256, 128, True, "expanded"),
    ("int4", 300, 1024, 128, False, "groupdot"),
    ("int4", 300, 1024, 128, False, "expanded"),
    ("int2", 33, 1024, 128, True, "groupdot"),
    ("int2", 300, 1024, 64, False, "expanded"),
    ("uint4", 300, 1024, 64, True, "expanded"),
    ("int4", 33, 256, 64, False, "expanded")])
def test_groupdot_b5_vs_pallas(interpret, fmt, m, k, g, with_bias, mode):
    """B5: ``dequant_matmul`` above BLOCKDIAG_MAX_ROWS rows against
    ``_groupdot_mm_pallas``, each of its modes forced (the expanded mode
    scales every value before one dot; equal in fp32)."""
    interpret.setenv("SDNQ_TPU_GROUPDOT_MAX_MG",
                     "1000000000" if mode == "groupdot" else "0")
    x, wq, scale, zp, b = _packed(fmt, m, k, g, m + k + g)
    b = b if with_bias else None
    f = jfmt(fmt)
    ref = jdq._groupdot_mm_pallas(
        _j(x), _j(wq), _j(scale), _j(zp), _j(b), fmt_name=fmt,
        code_bits=f.code_bits, code_min=int(f.min), is_float=False,
        group_size=g, out_dtype=jnp.dtype(jnp.float32))
    assert m > tdq.BLOCKDIAG_MAX_ROWS
    out = tdq.dequant_matmul(_t(x), _t(wq), _t(scale), _t(zp), _t(b),
                             tfmt(fmt), g, out_dtype=torch.float32,
                             pack_layout="halfsplit")
    _close(out.numpy(), ref)


@pytest.mark.parametrize("fmt,m,k,g,with_bias", [
    ("uint4", 1, 256, 128, True), ("int4", 7, 1024, 64, False),
    ("int2", 1, 1024, 128, True), ("uint4", 7, 1024, 128, False)])
def test_blockdiag_b6_vs_pallas(interpret, fmt, m, k, g, with_bias):
    """B6: ``dequant_matmul`` on up to BLOCKDIAG_MAX_ROWS rows against
    ``_blockdiag_mm_pallas``."""
    x, wq, scale, zp, b = _packed(fmt, m, k, g, m + k + g)
    b = b if with_bias else None
    f = jfmt(fmt)
    ref = jdq._blockdiag_mm_pallas(
        _j(x), _j(wq), _j(scale), _j(zp), _j(b), fmt_name=fmt,
        code_bits=f.code_bits, code_min=int(f.min), is_float=False,
        group_size=g, out_dtype=jnp.dtype(jnp.float32))
    out = tdq.dequant_matmul(_t(x), _t(wq), _t(scale), _t(zp), _t(b),
                             tfmt(fmt), g, out_dtype=torch.float32,
                             pack_layout="halfsplit")
    _close(out.numpy(), ref)


@pytest.mark.parametrize("fmt,m,k,with_bias", [
    ("uint4", 33, 256, True), ("int4", 300, 1024, False),
    ("int2", 33, 1024, True), ("uint4", 300, 1024, True),
    ("uint3", 33, 1024, True), ("int5", 40, 1024, False),
    ("int6", 33, 512, True), ("uint7", 40, 1024, False),
    ("uint3", 72, 1024, True), ("int5", 72, 1024, False),
    ("int6", 72, 512, True)])
def test_groupdot_i8_b7_vs_pallas(interpret, fmt, m, k, with_bias):
    """B7 and B8: ``packed_int8_matmul`` against the JAX package's, which
    runs ``_groupdot_i8_mm_pallas`` at these shapes (g = 128, more than 32
    rows), on 1-7-bit codes in one to three field planes.  The port's route
    takes B7 (``groupdot_i8_mm``) above I8_BLOCKDIAG_MAX_ROWS rows and B8
    (``blockdiag_i8_mm``, the same function) at or below: both are held
    here, B8 on codes in several field planes too.  Both divide for the x
    codes, which are bit-equal, so only the order of the fp32 epilogue
    differs: rtol 1e-5 plus 1e-5 of the largest output."""
    x, wq, scale, zp, b = _packed(fmt, m, k, 128, m + k)
    assert tdq.packed_int8_route_ok(m, k, 128, tfmt(fmt), "halfsplit")
    b = b if with_bias else None
    ref = jdq.packed_int8_matmul(_j(x), _j(wq), _j(scale), _j(zp), _j(b),
                                 jfmt(fmt), 128, out_dtype=jnp.float32,
                                 pack_layout="halfsplit")
    out = tdq.packed_int8_matmul(_t(x), _t(wq), _t(scale), _t(zp), _t(b),
                                 tfmt(fmt), 128, out_dtype=torch.float32,
                                 pack_layout="halfsplit")
    assert ref is not None and out is not None
    _close(out.numpy(), ref)


def test_halfsplit_kernels_bf16(interpret):
    """One bf16 case per kernel (bf16 x for B5 and B6, bf16 output for all
    three): within two bf16 ulps of the largest output."""
    interpret.setenv("SDNQ_TPU_GROUPDOT_MAX_MG", "1000000000")
    f = jfmt("uint4")
    for m, kernel in ((40, "B5"), (3, "B6"), (40, "B7")):
        x, wq, scale, zp, b = _packed("uint4", m, 512, 128, m)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        xt = _t(x).bfloat16()
        args = (_j(wq), _j(scale), _j(zp), _j(b))
        targs = (_t(wq), _t(scale), _t(zp), _t(b))
        kw = dict(fmt_name="uint4", code_bits=4, code_min=0, is_float=False,
                  group_size=128, out_dtype=jnp.dtype(jnp.bfloat16))
        if kernel == "B5":
            ref = jdq._groupdot_mm_pallas(xb, *args, **kw)
        elif kernel == "B6":
            ref = jdq._blockdiag_mm_pallas(xb, *args, **kw)
        else:
            ref = jdq.packed_int8_matmul(_j(x), *args, f, 128,
                                         out_dtype=jnp.bfloat16,
                                         pack_layout="halfsplit")
        if kernel == "B7":
            out = tdq.packed_int8_matmul(_t(x), *targs, tfmt("uint4"), 128,
                                         out_dtype=torch.bfloat16,
                                         pack_layout="halfsplit")
        else:
            out = tdq.dequant_matmul(xt, *targs, tfmt("uint4"), 128,
                                     out_dtype=torch.bfloat16,
                                     pack_layout="halfsplit")
        _bf16_ulps(out, ref, 2)


# (fmt, rows, K, group): packed_int8_matmul returns None on both sides
NONE_CASES = [
    ("uint4", 80, 1024, 64),     # group not a multiple of 128 (80·8 > 1024)
    ("int4", 40, 128, 64),       # field segment 64, not a multiple of 128
    ("int4", 40, 16640, 128),    # 130 groups > 64
    ("int12", 40, 256, 128),     # bit-plane layout
    ("uint4", 40, 33280, 512),   # K > 32768
    ("uint2", 512, 32768, 16384),  # 512 rows x 2 groups: over the VMEM rule
]


@pytest.mark.parametrize("fmt,m,k,g", NONE_CASES)
def test_packed_int8_route_none_cases(interpret, fmt, m, k, g):
    rng = np.random.default_rng(k)
    w = rng.normal(size=(96, k)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jq = J.quantize_tensor(jnp.asarray(w), fmt, group_size=g,
                           use_quantized_matmul=True)
    scale = np.asarray(jq.scale).reshape(96, -1)
    zp = (None if jq.zero_point is None
          else np.asarray(jq.zero_point).reshape(96, -1))
    assert jdq.packed_int8_matmul(
        _j(x), jq.qdata, _j(scale), _j(zp), None, jfmt(fmt), g,
        pack_layout=jq.meta.pack_layout) is None
    assert tdq.packed_int8_matmul(
        _t(x), _t(np.array(jq.qdata)), _t(scale), _t(zp), None, tfmt(fmt),
        g, pack_layout=jq.meta.pack_layout) is None


@pytest.mark.parametrize("fmt,m,k,g", NONE_CASES)
def test_packed_requantize_route(fmt, m, k, g):
    """After a None the quantized matmul requantizes the packed weight
    rowwise (B1 + B4) on both sides; the JAX package on its XLA route,
    where the row scales divide exactly as the port's do.  The same fp32
    operations: rtol 1e-5."""
    rng = np.random.default_rng(k + 1)
    w = rng.normal(size=(96, k)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    jq = J.quantize_tensor(jnp.asarray(w), fmt, group_size=g,
                           use_quantized_matmul=True,
                           dequant_dtype="float32")
    fields = {a: (None if getattr(jq, a) is None
                  else np.array(getattr(jq, a)))
              for a in ("qdata", "scale", "zero_point", "svd_up",
                        "svd_down")}
    import dataclasses
    from sdnq_tpu_torch.convert import qtensor_from_numpy
    tq = qtensor_from_numpy(fields, dataclasses.asdict(jq.meta), "cpu")
    ref = np.asarray(J_LAYERS.qlinear(_j(x), jq, _j(b)))
    out = T.qlinear(_t(x), tq, _t(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=2e-5 * np.abs(ref).max())


# (fmt, rows, K, group): the JAX package serves these through B8 (groups its
# group-dot kernel cannot tile, rows x groups <= 1024); the port returned
# None at them before it had B8.  The last has 65 groups, and group 32
# straddles the half-split field boundary (codes 8192..8447, segment 8320).
B8_CASES = [
    ("uint4", 32, 1024, 64),
    ("int4", 32, 2048, 64),
    ("uint2", 32, 512, 16),
    ("uint4", 8, 16640, 256),
    # the JAX package takes its group-dot kernel here (3 groups of 256, 40
    # rows), and group 1 straddles the 384-code segment; the port's B7
    # cannot split a group across the fields (on the card the route raised
    # there before B8), B8 can
    ("uint4", 40, 768, 256),
]


@pytest.mark.parametrize("fmt,m,k,g", B8_CASES)
def test_packed_int8_fine_groups_vs_jax(interpret, fmt, m, k, g):
    """``packed_int8_matmul`` has a result where the JAX package's has one,
    and the two agree (JAX's B8 body in interpret mode; the same exact
    integer partials, fp32 folds in another order): rtol 1e-5 plus 1e-5
    of the largest output."""
    x, wq, scale, zp, b = _packed(fmt, m, k, g, m + k + g, o=96)
    assert tdq.packed_int8_route_ok(m, k, g, tfmt(fmt), "halfsplit")
    ref = jdq.packed_int8_matmul(_j(x), _j(wq), _j(scale), _j(zp), _j(b),
                                 jfmt(fmt), g, out_dtype=jnp.float32,
                                 pack_layout="halfsplit")
    out = tdq.packed_int8_matmul(_t(x), _t(wq), _t(scale), _t(zp), _t(b),
                                 tfmt(fmt), g, out_dtype=torch.float32,
                                 pack_layout="halfsplit")
    assert ref is not None and out is not None
    _close(out.numpy(), ref)


@pytest.mark.parametrize("fmt,m,k,g", [
    ("uint4", 5, 1024, 64), ("int2", 3, 512, 16), ("uint1", 4, 1024, 8),
    ("uint4", 8, 16640, 256), ("uint5", 3, 1024, 64), ("int3", 2, 1024, 16)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_blockdiag_i8_b8_vs_pallas(interpret, fmt, m, k, g, with_bias):
    """B8's plain version (``blockdiag_i8_mm`` on CPU tensors) against
    ``_blockdiag_i8_mm_pallas`` on the same int8 rows: g 64, g 16 and g 8
    (the auto groups of 4-, 2- and 1-bit codes), 65 groups with one
    straddling the field boundary, and codes in two field planes (uint5 g
    64, int3 g 16).  Exact integer partials; the JAX body
    reduces the groups with an fp32 dot: rtol 1e-5 plus 1e-5 of the
    largest output."""
    x, wq, scale, zp, b = _packed(fmt, m, k, g, 7 * m + g, o=80)
    b = b if with_bias else None
    f = jfmt(fmt)
    from sdnq_tpu.quant.core import quantize_int_mm as jq_rows
    xq, xs = jq_rows(jnp.asarray(x), axis=-1)
    ref = jdq._blockdiag_i8_mm_pallas(
        xq, xs.reshape(-1, 1), _j(wq), _j(scale), _j(zp), _j(b),
        code_bits=f.code_bits, code_min=int(f.min), group_size=g,
        out_dtype=jnp.dtype(jnp.float32))
    s, zpc = tdq._group_operands(_t(scale), _t(zp), tfmt(fmt))
    out = tdq.blockdiag_i8_mm(_t(np.asarray(xq)), _t(np.asarray(xs)),
                              _t(wq), s, zpc, _t(b), f.code_bits,
                              torch.float32)
    _close(out.numpy(), ref)


def test_packed_int8_route_picks_b7_or_b8():
    """Where the route has a result the port takes B8 up to
    I8_BLOCKDIAG_MAX_ROWS rows and for every group B7 cannot tile, else
    B7: the wrappers' launch counters on the CPU stay 0 (plain versions),
    so the choice is read from which wrapper the route calls."""
    calls = []
    real = (tdq.groupdot_i8_mm, tdq.blockdiag_i8_mm)
    rows = tdq.I8_BLOCKDIAG_MAX_ROWS
    try:
        tdq.groupdot_i8_mm = lambda *a, **k: calls.append("B7")
        tdq.blockdiag_i8_mm = lambda *a, **k: calls.append("B8")
        f = tfmt("uint4")
        for m, k, g in ((rows, 1024, 128), (rows + 1, 1024, 128),
                        (300, 768, 256), (15, 2048, 64),
                        (max(100, rows + 1), 1024, 256), (65, 512, 16)):
            wq = torch.zeros(16, k // 2, dtype=torch.uint8)
            s = torch.ones(16, k // g)
            tdq.packed_int8_matmul(torch.randn(m, k), wq, s, None, None, f,
                                   g, pack_layout="halfsplit")
    finally:
        tdq.groupdot_i8_mm, tdq.blockdiag_i8_mm = real
    # 300 x 768 / 256: group 1 straddles the 384-code segment -> B8;
    # 65 x 512 / 16: 2080 rows x groups -> None (no product)
    assert calls == ["B8", "B7", "B8", "B8", "B7"]
