"""B1 (quantize_rows + scaled_gemm) and B4 (scaled_gemm): the port's plain
versions against the JAX package's ``scaled_mm_fused_act`` / ``scaled_mm``,
through its XLA fallback and through the Pallas bodies in interpret mode.

Activation codes are compared bit for bit.  Outputs are fp32: the int32
sums are exact on both sides and the epilogue runs the same fp32
operations, so rtol=1e-5 leaves room only for operation order (the JAX
uint8 path adds its zero-point terms through a small matmul); atol is
1e-5 of the largest output for the cancelling zero-point terms.

One known difference: the JAX Pallas prologue run in interpret mode on
the CPU forms ``absmax / 127`` as a multiply by the reciprocal, one ulp
below the true quotient on some rows, while the port (like
``sdnq_tpu.quant.core`` and the XLA path) divides.  Under that backend a
row may therefore carry codes one step apart; those rows are held to the
bound one code step per element gives (``_flip_bound``)."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

# the modules (their packages re-export functions of the same name)
jmm = importlib.import_module("sdnq_tpu.kernels.scaled_mm")
tmm = importlib.import_module("sdnq_tpu_torch.kernels.scaled_mm")


@pytest.fixture(params=["xla", "interpret"])
def backend(request, monkeypatch):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", request.param)
    return request.param


def _case(m, k, o, seed=0, asym=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[:, :3] += 2.0  # skewed rows for the asymmetric path
    x[5] = 0.0       # an all-zero row hits the scale floor
    w = rng.integers(-127, 128, (o, k)).astype(np.int8)
    ws = rng.uniform(0.005, 0.02, (o, 1)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, w, ws, b


def _close(out, ref, flip_bound=None):
    """rtol 1e-5; where ``flip_bound`` is given (interpret backend), rows
    off by that may differ by up to one code step per element."""
    ref = np.asarray(ref)
    out = np.asarray(out)
    tol = 1e-5 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    err = np.abs(out - ref)
    if flip_bound is None:
        assert (err <= tol).all(), err.max()
        return
    bad_rows = (err > tol).any(-1)
    assert bad_rows.mean() <= 0.1, bad_rows.mean()
    assert (err <= tol + flip_bound).all()


def _flip_bound(x, w, ws, vz0=None):
    """|dy| when every code of a row moves by one step:
    step * (sum_k |w| * ws [+ K |vz0|]), step = (row range)/127."""
    step = np.abs(x).max(-1, keepdims=True) / 127.0 * 2.0
    b = step * (np.abs(w.astype(np.float32)).sum(-1)[None, :]
                * ws.reshape(1, -1))
    if vz0 is not None:
        b = b + step * x.shape[-1] * np.abs(vz0).reshape(1, -1)
    return b


@pytest.mark.parametrize("m,k,o", [(64, 256, 96), (45, 272, 80),
                                   (32, 512, 128)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_act_int8(backend, m, k, o, with_bias):
    x, w, ws, b = _case(m, k, o)
    bias = b if with_bias else None
    ref = jmm.scaled_mm_fused_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
        None if bias is None else jnp.asarray(bias), x_fmt="int8",
        out_dtype=jnp.float32)
    out = tmm.scaled_mm_fused_act(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ws),
        None if bias is None else torch.from_numpy(bias), x_fmt="int8",
        out_dtype=torch.float32)
    _close(out.numpy(), ref, _flip_bound(x, w, ws)
           if backend == "interpret" else None)


@pytest.mark.parametrize("m,k", [(64, 256), (40, 384)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_act_uint8(backend, m, k, with_bias):
    o = 64
    x, w, ws, b = _case(m, k, o, seed=1)
    rng = np.random.default_rng(2)
    wz = rng.normal(size=(1, o)).astype(np.float32) * 0.1
    colsum = w.astype(np.int32).sum(-1)[None, :].astype(np.float32)
    vz1 = colsum * ws.reshape(1, -1) + np.float32(k) * wz
    bias = b if with_bias else None
    ref = jmm.scaled_mm_fused_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
        None if bias is None else jnp.asarray(bias), x_fmt="uint8",
        out_dtype=jnp.float32, v_zp0=jnp.asarray(wz), v_zp1=jnp.asarray(vz1))
    out = tmm.scaled_mm_fused_act(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ws),
        None if bias is None else torch.from_numpy(bias), x_fmt="uint8",
        out_dtype=torch.float32, v_zp0=torch.from_numpy(wz),
        v_zp1=torch.from_numpy(vz1))
    _close(out.numpy(), ref, _flip_bound(x, w, ws, wz)
           if backend == "interpret" else None)


def _codes(q):
    q = q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q
    return q.numpy()


@pytest.mark.parametrize("x_fmt", ["int8", "uint8", "float8_e4m3fn"])
def test_quantize_rows_codes_match_kernel_prologue(backend, x_fmt):
    """The JAX fused kernel's own quantized rows (emit_quantized) against
    the port's quantize_rows: bit-equal codes, equal scales."""
    asym = x_fmt == "uint8"
    x, w, ws, _ = _case(48, 256, 128, seed=3)
    kw = {}
    if asym:
        kw = dict(v_zp0=jnp.zeros((1, 128), jnp.float32),
                  v_zp1=jnp.zeros((1, 128), jnp.float32))
    wj = jnp.asarray(w)
    if x_fmt == "float8_e4m3fn":
        wj = wj.astype(jnp.float8_e4m3fn)
    res = jmm.scaled_mm_fused_act(
        jnp.asarray(x), wj, jnp.asarray(ws), None, x_fmt=x_fmt,
        out_dtype=jnp.float32, emit_quantized=True, **kw)
    jq = np.asarray(res[1])
    jq = jq.view(np.uint8) if x_fmt == "float8_e4m3fn" else jq
    xq, xs, zp, rs = tmm.quantize_rows(torch.from_numpy(x), x_fmt)
    same = (xs.numpy() == np.asarray(res[2]))[:, 0]
    if backend == "xla":
        assert same.all()
    else:  # reciprocal-multiply rows: one ulp of scale
        np.testing.assert_allclose(xs.numpy(), np.asarray(res[2]),
                                   rtol=2 ** -23)
        if x_fmt != "float8_e4m3fn":  # and integer codes one step
            assert np.abs(_codes(xq).astype(int) - jq.astype(int)).max() <= 1
    # the port's scale is the IEEE quotient
    qmax = {"int8": 127, "float8_e4m3fn": 448}.get(x_fmt)
    if qmax:
        amax = np.abs(x).max(-1, keepdims=True)
        np.testing.assert_array_equal(
            xs.numpy(), np.maximum(amax / np.float32(qmax), 2.0 ** -126))
    np.testing.assert_array_equal(_codes(xq)[same], jq[same])
    if asym:
        np.testing.assert_array_equal(zp.numpy()[same],
                                      np.asarray(res[3])[same])
        # rowsum(x_q) * scale, exactly as the kernel prologue forms it
        ref_rs = (xq.to(torch.int32).sum(-1, keepdim=True).float()
                  * xs).numpy()
        np.testing.assert_array_equal(rs.numpy(), ref_rs)
    # the padded form carries zero columns and the same codes
    xq_p = _codes(tmm.quantize_rows(torch.from_numpy(x), x_fmt, k_pad=32)[0])
    assert xq_p.shape == (48, 288) and not xq_p[:, 256:].any()
    np.testing.assert_array_equal(xq_p[:, :256], _codes(xq))


@pytest.mark.parametrize("m,k,o", [(64, 256, 128), (100, 200, 72),
                                   (33, 48, 40)])
def test_scaled_mm_prequantized(backend, m, k, o):
    rng = np.random.default_rng(4)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (o, k)).astype(np.int8)
    xs = rng.uniform(0.01, 0.02, (m, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.02, (o,)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    u = rng.normal(size=(m, 4)).astype(np.float32)
    v = rng.normal(size=(4, o)).astype(np.float32)
    ref = jmm.scaled_mm(*map(jnp.asarray, (xq, w, xs, ws, b)),
                        out_dtype=jnp.float32, lowrank_u=jnp.asarray(u),
                        lowrank_v=jnp.asarray(v))
    out = tmm.scaled_mm(*map(torch.from_numpy, (xq, w, xs, ws, b)),
                        out_dtype=torch.float32, lowrank_u=torch.from_numpy(u),
                        lowrank_v=torch.from_numpy(v))
    _close(out.numpy(), ref)
    # exact integer accumulation: the int64 product, then the fp32 epilogue
    acc = (xq.astype(np.int64) @ w.T.astype(np.int64)).astype(np.float32)
    plain = tmm.scaled_gemm_plain(*map(torch.from_numpy, (xq, w)),
                                  torch.float32, torch.from_numpy(xs),
                                  torch.from_numpy(ws), torch.from_numpy(b))
    np.testing.assert_array_equal(plain.numpy(), acc * xs * ws[None] + b)


def test_bf16_scaled_mm(backend):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 96)).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    ws = rng.uniform(0.5, 1.5, (64,)).astype(np.float32)
    ref = jmm.bf16_scaled_mm(jnp.asarray(x), jnp.asarray(w), None,
                             jnp.asarray(ws), None, out_dtype=jnp.float32)
    out = tmm.bf16_scaled_mm(torch.from_numpy(x), torch.from_numpy(w), None,
                             torch.from_numpy(ws), None,
                             out_dtype=torch.float32)
    # bf16 products are exact in fp32; only the summation order differs
    _close(out.numpy(), ref)


def test_fp8_fused_act_plain():
    x, _, ws, b = _case(32, 128, 48, seed=6)
    w8 = np.random.default_rng(7).normal(size=(48, 128)).astype(np.float32)
    jw = jnp.asarray(w8).astype(jnp.float8_e4m3fn)
    tw = torch.from_numpy(w8).to(torch.float8_e4m3fn)
    ref = jmm.scaled_mm_fused_act(jnp.asarray(x), jw, jnp.asarray(ws),
                                  jnp.asarray(b), x_fmt="float8_e4m3fn",
                                  out_dtype=jnp.float32)
    out = tmm.scaled_mm_fused_act(torch.from_numpy(x), tw,
                                  torch.from_numpy(ws), torch.from_numpy(b),
                                  x_fmt="float8_e4m3fn",
                                  out_dtype=torch.float32)
    # fp8 products are exact in fp32; summation order differs
    _close(out.numpy(), ref)


# ---------------------------------------------------------------------------
# B1's training modes (nn layout, x_colscale, emit_quantized) and B10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,o", [(64, 256, 128), (40, 384, 256)])
def test_fused_act_nn_colscale(backend, m, k, o):
    """The grad-input route: x (M, K) times a column scale, quantized per
    row, against w (K, O) contracting its leading axis.  Under the
    interpret backend this is ``_fused_act_mm_pallas(b_dim0=True)``."""
    x, _, _, _ = _case(m, k, o, seed=11)
    rng = np.random.default_rng(12)
    w = rng.integers(-127, 128, (k, o)).astype(np.int8)
    cs = rng.uniform(0.001, 0.02, (k,)).astype(np.float32)
    ref = jmm.scaled_mm_fused_act(
        jnp.asarray(x), jnp.asarray(w), None, None, x_fmt="int8",
        out_dtype=jnp.float32, b_layout="nn", x_colscale=jnp.asarray(cs))
    out = tmm.scaled_mm_fused_act(
        torch.from_numpy(x), torch.from_numpy(w), None, None, x_fmt="int8",
        out_dtype=torch.float32, b_layout="nn",
        x_colscale=torch.from_numpy(cs))
    _close(out.numpy(), ref, _flip_bound(x * cs, w.T, np.ones(o, np.float32))
           if backend == "interpret" else None)
    # the same function as the plain composition, and as the nt layout on
    # the transposed weight
    xq, xs = tmm.quantize_rows_plain(torch.from_numpy(x) *
                                     torch.from_numpy(cs))[:2]
    plain = tmm.scaled_gemm_plain(xq, torch.from_numpy(w), torch.float32, xs,
                                  b_layout="nn")
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    nt = tmm.scaled_gemm_plain(xq, torch.from_numpy(w.T.copy()),
                               torch.float32, xs)
    np.testing.assert_array_equal(out.numpy(), nt.numpy())


@pytest.mark.parametrize("x_fmt", ["int8", "uint8", "float8_e4m3fn"])
def test_fused_act_emit_quantized(backend, x_fmt):
    """``emit_quantized``: the returned codes and scales against the JAX
    kernel's emitted ones (codes within one step and scales within one ulp
    under interpret, the reciprocal quirk; equal on the XLA route), in the
    JAX tuple order, unpadded."""
    asym = x_fmt == "uint8"
    x, w, ws, b = _case(48, 320, 128, seed=13)
    kw_j, kw_t = {}, {}
    if asym:
        z = np.zeros((1, 128), np.float32)
        kw_j = dict(v_zp0=jnp.asarray(z), v_zp1=jnp.asarray(z))
        kw_t = dict(v_zp0=torch.from_numpy(z), v_zp1=torch.from_numpy(z))
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    if x_fmt == "float8_e4m3fn":
        wj, wt = wj.astype(jnp.float8_e4m3fn), wt.to(torch.float8_e4m3fn)
    res = jmm.scaled_mm_fused_act(jnp.asarray(x), wj, jnp.asarray(ws),
                                  jnp.asarray(b), x_fmt=x_fmt,
                                  out_dtype=jnp.float32, emit_quantized=True,
                                  **kw_j)
    out = tmm.scaled_mm_fused_act(torch.from_numpy(x), wt,
                                  torch.from_numpy(ws), torch.from_numpy(b),
                                  x_fmt=x_fmt, out_dtype=torch.float32,
                                  emit_quantized=True, **kw_t)
    assert len(out) == len(res) == (4 if asym else 3)
    assert tuple(out[1].shape) == (48, 320) and tuple(out[2].shape) == (48, 1)
    jq = np.asarray(res[1])
    jq = jq.view(np.uint8) if x_fmt == "float8_e4m3fn" else jq
    np.testing.assert_allclose(out[2].numpy(), np.asarray(res[2]),
                               rtol=2 ** -23)
    if x_fmt != "float8_e4m3fn":
        assert np.abs(_codes(out[1]).astype(int) - jq.astype(int)).max() <= 1
    same = (out[2].numpy() == np.asarray(res[2]))[:, 0]
    np.testing.assert_array_equal(_codes(out[1])[same], jq[same])
    if backend == "xla":
        assert same.all()
    if asym:
        np.testing.assert_allclose(out[3].numpy(), np.asarray(res[3]),
                                   rtol=2 ** -22)


def _tn_case(m, n, k, seed, fp8=False):
    rng = np.random.default_rng(seed)
    if fp8:
        a = rng.normal(size=(m, n)).astype(np.float32) * 4
        b = rng.normal(size=(m, k)).astype(np.float32) * 4
    else:
        a = rng.integers(-128, 128, (m, n)).astype(np.int8)
        b = rng.integers(-128, 128, (m, k)).astype(np.int8)
    a_s = rng.uniform(0.001, 0.02, (n,)).astype(np.float32)
    b_s = rng.uniform(0.001, 0.02, (k,)).astype(np.float32)
    u = rng.normal(size=(n, 2)).astype(np.float32)
    v = rng.normal(size=(2, k)).astype(np.float32)
    return a, b, a_s, b_s, u, v


@pytest.fixture
def tn_kernel(monkeypatch):
    """The JAX package's TN Pallas kernel, in interpret mode."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    monkeypatch.setenv("SDNQ_TPU_TN_MM_BLOCKS", "128,128,64")


@pytest.mark.parametrize("m", [1, 70, 256])
@pytest.mark.parametrize("lowrank", [False, True])
def test_scaled_mm_tn_int8_vs_pallas(tn_kernel, m, lowrank):
    """B10's plain version against ``_tn_mm_kernel``: int8 bit-equal (exact
    integer sums, the same fp32 epilogue order: acc*a_s, then *b_s; the
    rank-2 u@v term in fp32 after it, one rounding of order apart), ragged
    M (70: the kernel zero-pads to 96) and M = 1 included."""
    n, k = 256, 384
    a, b, a_s, b_s, u, v = _tn_case(m, n, k, seed=14)
    uv_j = (jnp.asarray(u), jnp.asarray(v)) if lowrank else (None, None)
    uv_t = (torch.from_numpy(u), torch.from_numpy(v)) if lowrank \
        else (None, None)
    ref = np.asarray(jmm.scaled_mm_tn(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_s), jnp.asarray(b_s),
        out_dtype=jnp.float32, lowrank_u=uv_j[0], lowrank_v=uv_j[1]))
    out = tmm.scaled_mm_tn(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(a_s), torch.from_numpy(b_s),
                           torch.float32, *uv_t).numpy()
    if lowrank:
        np.testing.assert_allclose(out, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        np.testing.assert_array_equal(out, ref)
    acc = (a.astype(np.int64).T @ b.astype(np.int64)).astype(np.float32)
    plain = acc * a_s[:, None] * b_s[None, :]
    if not lowrank:
        np.testing.assert_array_equal(out, plain)


@pytest.mark.parametrize("m", [1, 70])
def test_scaled_mm_tn_fp8_vs_pallas(tn_kernel, m):
    """e4m3: products exact in fp32, sums in another order than the TPU
    kernel's: rtol 1e-5 of the sum of |terms| (scaled)."""
    n, k = 128, 256
    a, b, a_s, b_s, _, _ = _tn_case(m, n, k, seed=15, fp8=True)
    aj = jnp.asarray(a).astype(jnp.float8_e4m3fn)
    bj = jnp.asarray(b).astype(jnp.float8_e4m3fn)
    ref = np.asarray(jmm.scaled_mm_tn(aj, bj, jnp.asarray(a_s),
                                      jnp.asarray(b_s),
                                      out_dtype=jnp.float32))
    at = torch.from_numpy(a).to(torch.float8_e4m3fn)
    bt = torch.from_numpy(b).to(torch.float8_e4m3fn)
    out = tmm.scaled_mm_tn(at, bt, torch.from_numpy(a_s),
                           torch.from_numpy(b_s)).numpy()
    terms = (np.abs(at.float().numpy()).T @ np.abs(bt.float().numpy())) \
        * a_s[:, None] * b_s[None, :]
    assert (np.abs(out - ref) <= 1e-5 * terms + 1e-7).all()


@pytest.mark.parametrize("fmt", ["int8", "uint8", "float8_e4m3fn",
                                 "bfloat16"])
@pytest.mark.parametrize("m", [1, 48])
def test_dynamic_mm_tn_and_nn(fmt, m):
    """The grad-weight (``dynamic_mm_tn``) and grad-input
    (``train.matmul._dynamic_mm_nn``) GEMMs of each family against the JAX
    package's, on its XLA route: the same columnwise / rowwise quantize and
    exact integer sums, so rtol 1e-5 (fp8 and the 16-bit family: fp32
    summation order; uint8: the rank-2 cross terms)."""
    from sdnq_tpu.train import matmul as jtm
    from sdnq_tpu_torch.train import matmul as ttm
    rng = np.random.default_rng(16)
    n, k = 96, 160
    a = rng.normal(size=(m, n)).astype(np.float32)
    b = rng.normal(size=(m, k)).astype(np.float32)
    a[:, :4] += 1.5
    ref = np.asarray(jmm.dynamic_mm_tn(jnp.asarray(a), jnp.asarray(b), fmt))
    out = tmm.dynamic_mm_tn(torch.from_numpy(a), torch.from_numpy(b),
                            fmt).numpy()
    _close(out, ref)
    w = rng.normal(size=(n, k)).astype(np.float32)
    ref = np.asarray(jtm._dynamic_mm_nn(jnp.asarray(a), jnp.asarray(w), fmt))
    out = ttm._dynamic_mm_nn(torch.from_numpy(a), torch.from_numpy(w),
                             fmt).numpy()
    _close(out, ref)


def test_tma_rows_copies_only_what_tma_cannot_read():
    """The operand helper of the Hopper kernels (B3, B4, B8, B9 and the
    GEMM): a tensor TMA can read in place comes back as itself; a view off
    a 16-byte boundary, with a row stride that is not a multiple of 16
    bytes, or with a zero (broadcast) stride, comes back as an equal copy
    on a 16-byte boundary, its rows padded to 16 bytes with zeros."""
    from sdnq_tpu_torch.kernels import _build
    t = torch.arange(4 * 32, dtype=torch.float32).reshape(4, 32)
    assert _build.tma_rows(t) is t
    view = t[:, :20]   # rows 128 bytes apart: read in place
    assert _build.tma_rows(view, 20) is view
    flat = torch.arange(1 + 3 * 2 * 64, dtype=torch.int8)
    off = flat[1:].view(3, 2, 64)
    assert off.data_ptr() % 16
    c = _build.tma_rows(off)
    assert c.data_ptr() % 16 == 0 and torch.equal(c, off)
    rows = torch.randn(5, 13).bfloat16()
    c = _build.tma_rows(rows)
    assert c.data_ptr() % 16 == 0 and c.stride(0) == 16
    assert torch.equal(c[:, :13], rows) and not c[:, 13:].any()
    bcast = torch.randn(1, 32).expand(3, 32)
    c = _build.tma_rows(bcast)
    assert c.stride(0) == 32 and torch.equal(c, bcast)
