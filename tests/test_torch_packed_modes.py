"""The plain versions of the kernel modes that dynamic quantization reaches,
against the JAX package on the same quantized bytes (quantized by the JAX
package and carried across):

* B2's packed bit-plane mode (8- to 16-bit codes: minifloats through
  ``decode_float`` with subnormals, signed integers through ``code_min``)
  against ``dequant_matmul``, through the Pallas body of
  ``_dequant_mm_kernel`` in interpret mode and through the XLA route;
* B5 / B6 on multi-plane half-split integers (3/5/6/7 bits) and on
  minifloat codes against ``_groupdot_mm_pallas`` /
  ``_blockdiag_mm_pallas`` in interpret mode.

fp32 (and bf16 x at R1's bit-plane formats): the same exact products of
the same weights summed in another order, so rtol 1e-5 plus 1e-5 of the
largest output (as tests/test_torch_dequant_mm.py)."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sdnq_tpu as J
from sdnq_tpu.formats import get_format as jfmt
from sdnq_tpu_torch.formats import get_format as tfmt

jdq = importlib.import_module("sdnq_tpu.kernels.dequant_mm")
tdq = importlib.import_module("sdnq_tpu_torch.kernels.dequant_mm")

J_KERNEL_FNS = [jdq._dequant_mm_pallas, jdq._groupdot_mm_pallas,
                jdq._blockdiag_mm_pallas]


def _backend(monkeypatch, name):
    """The JAX package's kernel backend; its jitted kernel wrappers read it
    while tracing, so their caches are cleared around each test."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", name)
    for fn in J_KERNEL_FNS:
        fn.clear_cache()
    yield name
    for fn in J_KERNEL_FNS:
        fn.clear_cache()


@pytest.fixture(params=["xla", "interpret"])
def backend(request, monkeypatch):
    yield from _backend(monkeypatch, request.param)


@pytest.fixture
def interpret(monkeypatch):
    yield from _backend(monkeypatch, "interpret")


def _quantized(fmt, m, k, g, seed, layout, o=96):
    """Seeded x, bias and a JAX-quantized weight with a few outliers."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(o, k)) * (1 + 6 * (rng.random((o, k)) > 0.99))
    x = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    jq = J.quantize_tensor(jnp.asarray(w.astype(np.float32) * 0.02), fmt,
                           group_size=g)
    assert jq.meta.pack_layout == layout
    scale = np.asarray(jq.scale).reshape(o, -1)
    zp = (None if jq.zero_point is None
          else np.asarray(jq.zero_point).reshape(o, -1))
    return x, np.array(jq.qdata), scale, zp, b


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(out, ref):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(out, dtype=np.float32), ref,
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("fmt,k,g,xdt", [
    ("float8_e3m4fn", 2048, 1024, "f32"), ("float9_e3m5fn", 1024, -1, "f32"),
    ("int12", 1024, 128, "f32"), ("uint10", 1024, 256, "f32"),
    ("float8_e3m4fn", 2048, 1024, "bf16"), ("float9_e3m5fn", 2048, -1, "bf16")],
    ids=["float8_e3m4fn-2048-1024", "float9_e3m5fn-1024--1", "int12-1024-128",
         "uint10-1024-256", "float8_e3m4fn-2048-1024-bf16",
         "float9_e3m5fn-2048--1-bf16"])
@pytest.mark.parametrize("m", [1, 40, 32])
def test_bitplane_b2_vs_jax(backend, fmt, k, g, xdt, m):
    """``dequant_matmul`` on bit-plane codes (the GEMV's plain version at 1
    and 32 rows, the tiles' at 40); on the interpret backend the JAX side
    runs its packed Pallas body (K a multiple of 1024).  bf16 x at R1's
    formats, as R1's layers give it: each weight rounded to bf16 before the
    product, x read in its natural order.  (With a zero point the JAX
    package's XLA route rounds code * scale before it adds the zero point,
    where its Pallas body and the port fuse the two, so a bf16 weight may
    differ by one ulp between the JAX routes: R1's formats have none.)"""
    x, wq, scale, zp, b = _quantized(fmt, m, k, g, m + k, "bitplane")
    xt = torch.from_numpy(x)
    xj = _j(x)
    if xdt == "bf16":
        xt = xt.bfloat16()
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    gsize = k // scale.shape[1]
    ref = jdq.dequant_matmul(xj, _j(wq), _j(scale), _j(zp), _j(b),
                             jfmt(fmt), gsize, out_dtype=jnp.float32)
    out = tdq.dequant_matmul(xt, _t(wq), _t(scale), _t(zp), _t(b),
                             tfmt(fmt), gsize, out_dtype=torch.float32)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("fmt,m,k,g", [
    ("uint3", 40, 1024, 128), ("uint5", 40, 1024, 128),
    ("int6", 300, 512, 128), ("uint7", 40, 1024, 256),
    ("float5_e2m2fn", 40, 1024, 128), ("int5", 40, 512, 64)])
def test_groupdot_b5_general_vs_pallas(interpret, fmt, m, k, g):
    """B5's general mode through ``dequant_matmul`` against
    ``_groupdot_mm_pallas`` (group-dot or expanded mode by its own gate;
    the same function in fp32)."""
    x, wq, scale, zp, b = _quantized(fmt, m, k, g, m + k + g, "halfsplit")
    f = jfmt(fmt)
    ref = jdq._groupdot_mm_pallas(
        _j(x), _j(wq), _j(scale), _j(zp), _j(b), fmt_name=fmt,
        code_bits=f.code_bits, code_min=int(f.min) if f.is_integer else 0,
        is_float=not f.is_integer, group_size=g,
        out_dtype=jnp.dtype(jnp.float32))
    assert m > tdq.BLOCKDIAG_MAX_ROWS
    out = tdq.dequant_matmul(_t(x), _t(wq), _t(scale), _t(zp), _t(b),
                             tfmt(fmt), g, out_dtype=torch.float32,
                             pack_layout="halfsplit")
    _close(out.numpy(), ref)


@pytest.mark.parametrize("fmt,m,k,g", [
    ("uint3", 1, 1024, 128), ("uint5", 5, 512, 64), ("int6", 1, 512, 128),
    ("uint7", 3, 1024, 256), ("float5_e2m2fn", 1, 1024, 128),
    ("float5_e2m2fn", 7, 256, 32)])
def test_blockdiag_b6_general_vs_pallas(interpret, fmt, m, k, g):
    x, wq, scale, zp, b = _quantized(fmt, m, k, g, m + k + g, "halfsplit")
    f = jfmt(fmt)
    ref = jdq._blockdiag_mm_pallas(
        _j(x), _j(wq), _j(scale), _j(zp), _j(b), fmt_name=fmt,
        code_bits=f.code_bits, code_min=int(f.min) if f.is_integer else 0,
        is_float=not f.is_integer, group_size=g,
        out_dtype=jnp.dtype(jnp.float32))
    out = tdq.dequant_matmul(_t(x), _t(wq), _t(scale), _t(zp), _t(b),
                             tfmt(fmt), g, out_dtype=torch.float32,
                             pack_layout="halfsplit")
    _close(out.numpy(), ref)


def test_general_plain_decodes_minifloat_values():
    """B5's plain version on minifloat codes multiplies their decoded
    values (signed), with the zero point alone as zpc: against the
    dequantized weight in float64."""
    x, wq, scale, zp, b = _quantized("float6_e3m3fnu", 9, 256, 64, 3,
                                     "halfsplit")
    f = tfmt("float6_e3m3fnu")
    assert zp is not None
    s, zpc = tdq._group_operands(_t(scale), _t(zp), f)
    torch.testing.assert_close(zpc, _t(zp).float())
    out = tdq.groupdot_mm_plain(_t(x), _t(wq), s, zpc, _t(b), f.code_bits,
                                torch.float32, f)
    from sdnq_tpu_torch.packing import unpack
    vals = unpack(_t(wq), f, 256, dtype=torch.float64,
                  layout="halfsplit").numpy()
    w = (vals.reshape(96, 4, 64) * scale[..., None] + zp[..., None]).reshape(
        96, 256)
    ref = x.astype(np.float64) @ w.T + b
    _close(out.numpy(), ref)
