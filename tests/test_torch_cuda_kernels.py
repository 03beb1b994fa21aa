"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a GPU (the kernels have no CPU
mode).  Run on a machine with an H100 and nvcc:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q``.

Tolerances: the int8 GEMM and the row quantization are bit-exact (integer
sums, the same rounded fp32 epilogue); bf16 and fp32-sum kernels differ
from their plain versions in summation order (GEMV, bf16 GEMM: rtol 1e-4
of the sum of |terms|) and, for attention, in where P is rounded to bf16
against a running instead of the final row max (2^-6 of the largest
output, two bf16 ulps of it)."""

import pytest
import torch

from sdnq_tpu_torch.kernels import attention as ka
from sdnq_tpu_torch.kernels import dequant_mm as kd
from sdnq_tpu_torch.kernels import scaled_mm as ks

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("m,k", [(1, 64), (37, 200), (300, 3072)])
@pytest.mark.parametrize("x_fmt", ["int8", "uint8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows(dev, m, k, x_fmt, dtype):
    x = torch.randn(m, k, device=dev, generator=_gen(0)).to(dtype)
    got = ks.quantize_rows(x, x_fmt, k_pad=24)
    want = ks.quantize_rows_plain(x, x_fmt, k_pad=24)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:  # bytes equal (fp8 codes compared as bytes)
            assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                               else a,
                               b.view(torch.uint8) if b.element_size() == 1
                               else b)


@pytest.mark.parametrize("m,n,k", [(1, 8, 64), (130, 200, 200),
                                   (257, 129, 1088)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_scaled_gemm_int8_exact(dev, m, n, k, out_dtype):
    g = _gen(1)
    a = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (n, k), device=dev, generator=g,
                      dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=g) * 0.02
    ws = torch.rand(n, device=dev, generator=g) * 0.02
    bias = torch.randn(n, device=dev, generator=g)
    rs, zp = torch.randn(m, device=dev, generator=g), torch.randn(
        m, device=dev, generator=g)
    vz0, vz1 = torch.randn(n, device=dev, generator=g), torch.randn(
        n, device=dev, generator=g)
    for extra in ({}, dict(rs=rs, zp=zp, vz0=vz0, vz1=vz1)):
        got = ks.scaled_gemm(a, b, out_dtype, xs, ws, bias, **extra)
        want = ks.scaled_gemm_plain(a, b, out_dtype, xs, ws, bias, **extra)
        assert torch.equal(got, want)


def test_scaled_gemm_fp8(dev):
    """e4m3 products are exact in fp32; only the summation order differs."""
    g = _gen(8)
    a = torch.randn(150, 200, device=dev, generator=g).to(torch.float8_e4m3fn)
    b = torch.randn(72, 200, device=dev, generator=g).to(torch.float8_e4m3fn)
    xs = torch.rand(150, 1, device=dev, generator=g)
    got = ks.scaled_gemm(a, b, torch.float32, xs)
    want = ks.scaled_gemm_plain(a, b, torch.float32, xs)
    bound = 1e-5 * (a.float().abs() @ b.float().abs().T) * xs
    assert ((got - want).abs() <= bound + 1e-6).all()


def test_scaled_gemm_bf16(dev):
    g = _gen(2)
    a = torch.randn(200, 96, device=dev, generator=g).bfloat16()
    b = torch.randn(136, 96, device=dev, generator=g).bfloat16()
    got = ks.scaled_gemm(a, b, torch.float32)
    want = ks.scaled_gemm_plain(a, b, torch.float32)
    bound = 1e-4 * (a.float().abs() @ b.float().abs().T)
    assert ((got - want).abs() <= bound + 1e-6).all()


@pytest.mark.parametrize("m", [1, 3, 8, 17, 32])
@pytest.mark.parametrize("unsigned", [False, True])
def test_dequant_gemv(dev, m, unsigned):
    g = _gen(3)
    k, o = 776, 1000
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    lo, hi, dt = (0, 256, torch.uint8) if unsigned else (-128, 128,
                                                         torch.int8)
    w = torch.randint(lo, hi, (o, k), device=dev, generator=g, dtype=dt)
    s = torch.rand(o, device=dev, generator=g) * 0.01
    z = torch.randn(o, device=dev, generator=g) if unsigned else None
    bias = torch.randn(o, device=dev, generator=g)
    got = kd.dequant_gemv(x, w, s, z, bias, torch.float32)
    want = kd.dequant_gemv_plain(x, w, s, z, bias, torch.float32)
    bound = 1e-4 * ((x.float().abs() @ w.float().abs().T) * s
                    + (x.float().abs().sum(-1, keepdim=True)
                       * (z.abs() if z is not None else 0)))
    assert ((got - want).abs() <= bound + 1e-5).all()


@pytest.mark.parametrize("x_fmt", ["int8", "uint8", "float8_e4m3fn"])
def test_fused_act_wrapper_matches_cpu(dev, x_fmt):
    """B1 as the layers call it (K 272 is padded on the card only): the
    card's result equals the plain composition on the CPU."""
    g = _gen(5)
    m, k, o = 70, 272, 96
    x = torch.randn(m, k, device=dev, generator=g)
    w = torch.randint(-128, 128, (o, k), device=dev, generator=g,
                      dtype=torch.int8)
    if x_fmt == "float8_e4m3fn":
        w = (w.float() / 8).to(torch.float8_e4m3fn)
    ws = torch.rand(o, 1, device=dev, generator=g) * 0.01
    bias = torch.randn(o, device=dev, generator=g)
    kw = {}
    if x_fmt == "uint8":
        kw = dict(v_zp0=torch.randn(1, o, device=dev, generator=g) * 0.1,
                  v_zp1=torch.randn(1, o, device=dev, generator=g))
    got = ks.scaled_mm_fused_act(x, w, ws, bias, x_fmt=x_fmt,
                                 out_dtype=torch.float32, **kw)
    want = ks.scaled_mm_fused_act(
        x.cpu(), w.cpu(), ws.cpu(), bias.cpu(), x_fmt=x_fmt,
        out_dtype=torch.float32, **{a: b.cpu() for a, b in kw.items()})
    # integer sums are exact; fp8 sums differ in order (fp32)
    tol = 1e-5 if x_fmt == "float8_e4m3fn" else 1e-6
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("rows", [5, 40])
def test_qlinear_on_card_matches_cpu(dev, rows):
    """Both qlinear routes on the card (B2 below 32 rows, B1 above) against
    the same QTensor on the CPU, bf16 output: one bf16 ulp."""
    import sdnq_tpu_torch as T
    g = _gen(6)
    w = torch.randn(192, 256, device=dev, generator=g)
    x = torch.randn(rows, 256, device=dev, generator=g)
    b = torch.randn(192, device=dev, generator=g)
    qt = T.quantize_tensor(w, "int8", use_quantized_matmul=True)
    got = T.qlinear(x, qt, b).float().cpu()
    qt_cpu = T.QTensor(qdata=qt.qdata.cpu(), scale=qt.scale.cpu(),
                       zero_point=None, svd_up=None, svd_down=None,
                       meta=qt.meta)
    want = T.qlinear(x.cpu(), qt_cpu, b.cpu()).float()
    assert ((got - want).abs() <= want.abs() * 2 ** -7 + 1e-3).all()


def test_dequant_matmul_many_rows(dev):
    """Rowwise weight-only above 32 rows takes the tile kernel's row mode
    (fp32 x cast to bf16 on the card): it launches and agrees with the
    plain version on the bf16 rows, 1e-5 of the sum of |terms|."""
    from sdnq_tpu_torch.formats import get_format
    g = _gen(7)
    x = torch.randn(48, 320, device=dev, generator=g)
    w = torch.randint(0, 256, (136, 320), device=dev, generator=g,
                      dtype=torch.uint8)
    s = torch.rand(136, 1, device=dev, generator=g) * 0.01
    z = torch.randn(136, 1, device=dev, generator=g)
    before = kd.dequant_mm.mode_launches["row"]
    got = kd.dequant_matmul(x, w, s, z, None, get_format("uint8"), -1,
                            out_dtype=torch.float32)
    assert kd.dequant_mm.mode_launches["row"] == before + 1
    want = kd.dequant_gemv_plain(x.bfloat16(), w, s, z, None, torch.float32)
    bound = 1e-5 * ((x.abs() @ w.float().T) * s.T
                    + x.abs().sum(-1, keepdim=True) * z.abs().T)
    assert ((got - want).abs() <= bound + 1e-5).all()


def _codes(kind, o, k, gen, dev):
    if kind == "float8_e4m3fn":
        return (torch.randn(o, k, device=dev, generator=gen) * 40).to(
            torch.float8_e4m3fn)
    lo, hi, dt = ((-128, 128, torch.int8) if kind == "int8"
                  else (0, 256, torch.uint8))
    return torch.randint(lo, hi, (o, k), device=dev, generator=gen, dtype=dt)


def _grouped_bound(x, codes, scale, zp, bias):
    """1e-5 of the sum of |terms| of each output (bf16 products are exact
    in fp32; only the summation order differs)."""
    w = kd.dequant_gemv_plain(torch.eye(codes.shape[1], device=x.device),
                              codes, scale, zp, None, torch.float32).T
    return 1e-5 * (x.float().abs() @ w.abs().T + (
        bias.abs() if bias is not None else 0)) + 1e-6


@pytest.mark.parametrize("m,k,o,groups", [
    (33, 256, 200, 2), (130, 3072, 136, 3), (300, 200, 72, 5),
    (77, 1024, 256, 8), (4, 512, 128, 4)])
@pytest.mark.parametrize("kind", ["int8", "uint8", "float8_e4m3fn"])
def test_dequant_mm_grouped(dev, m, k, o, groups, kind):
    """B2's tile kernel, grouped: ragged M, N and K (K 200 is padded to a
    multiple of 16), groups of 40 .. 1024 codes."""
    gen = _gen(20)
    codes = _codes(kind, o, k, gen, dev)
    scale = torch.rand(o, groups, device=dev, generator=gen) * 0.01 + 1e-3
    zp = (torch.randn(o, groups, device=dev, generator=gen) - 1.28
          if kind == "uint8" else None)
    x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    bias = torch.randn(o, device=dev, generator=gen)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = kd.dequant_mm(x, codes, scale, zp, bias, out_dtype).float()
        want = kd.dequant_mm_plain(x, codes, scale, zp, bias,
                                   torch.float32)
        bound = _grouped_bound(x, codes, scale, zp, bias)
        if out_dtype == torch.bfloat16:
            bound = bound + want.abs() * 2 ** -8
        assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("m", [1, 5, 32])
@pytest.mark.parametrize("kind", ["int8", "uint8", "float8_e4m3fn"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_dequant_gemv_grouped(dev, m, kind, x_dtype):
    """B2's GEMV, grouped (K 3072 in 3 groups, as the FLUX modulation
    linears) and rowwise e4m3: the weight rounded to x's dtype; fp32 sums
    in another order, 1e-5 of the sum of |terms|."""
    gen = _gen(21)
    k, o = 3072, 1000
    codes = _codes(kind, o, k, gen, dev)
    x = torch.randn(m, k, device=dev, generator=gen).to(x_dtype)
    bias = torch.randn(o, device=dev, generator=gen)
    for groups in (3, 1):
        scale = torch.rand(o, groups, device=dev, generator=gen) * 0.01
        zp = (torch.randn(o, groups, device=dev, generator=gen)
              if kind == "uint8" else None)
        got = kd.dequant_gemv(x, codes, scale, zp, bias, torch.float32)
        want = kd.dequant_gemv_plain(x, codes, scale, zp, bias,
                                     torch.float32)
        bound = _grouped_bound(x, codes, scale, zp, bias)
        if groups == 1 and zp is not None:
            bound = bound + 1e-5 * x.float().abs().sum(-1, keepdim=True) \
                * zp.abs().T
        assert ((got - want).abs() <= bound).all()


def test_dequant_matmul_routes(dev):
    """Unpacked codes take the GEMV up to 32 rows (grouped where the group
    is a multiple of 8) and the tiles above, each mode counted."""
    from sdnq_tpu_torch.formats import get_format
    gen = _gen(22)
    w = torch.randint(-128, 128, (96, 3072), device=dev, generator=gen,
                      dtype=torch.int8)
    s = torch.rand(96, 3, device=dev, generator=gen) * 0.01
    fmt = get_format("int8")
    for m, key in ((1, "dequant_gemv:grouped"), (32, "dequant_gemv:grouped"),
                   (33, "dequant_mm:grouped")):
        from sdnq_tpu_torch.kernels import launch_counts
        before = launch_counts()[key]
        kd.dequant_matmul(torch.randn(m, 3072, device=dev), w, s, None, None,
                          fmt, 1024)
        assert launch_counts()[key] == before + 1


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", [(64, 512), (128, 200)])
def test_flash_attention_float_mask(dev, quant, mask_dtype, d, n):
    """B3's additive mask: a T5-style (1, H, N, N) bias over 2 batches read
    through its strides, one query row masked by -inf everywhere (0, not
    NaN), bf16 or int8 Q·K.  Per row against the row's largest output,
    2^-6 (P rounded to bf16 against a running max)."""
    g = _gen(23)
    b, h = 2, 4
    q = torch.randn(b * h, n, d, device=dev, generator=g) * 0.4
    k = torch.randn(b * h, n, d, device=dev, generator=g) * 0.4
    v = torch.randn(b * h, n, d, device=dev, generator=g).bfloat16()
    bias = (torch.randn(1, h, n, n, device=dev, generator=g) * 2)
    bias[:, :, 5] = float("-inf")
    bias = bias.to(mask_dtype)
    if quant:
        from sdnq_tpu_torch.quant.core import quantize_int_mm
        qq, qs = quantize_int_mm(q)
        kq, kss = quantize_int_mm(k)
        args = (qq, kq, v, qs[..., 0] * ka.LOG2E, kss[..., 0])
    else:
        args = ((q * ka.LOG2E).bfloat16(), k.bfloat16(), v)
    before = ka.flash_attention.mode_launches["float_mask"]
    got = ka.flash_attention(*args, out_dtype=torch.float32, heads=h,
                             mask=bias)
    assert ka.flash_attention.mode_launches["float_mask"] == before + 1
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, heads=h,
                                    mask=bias)
    assert torch.isfinite(got).all() and not got[:, 5].any()
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[5] = False
    err = (got - want).abs()[:, keep].amax(-1)
    assert (err <= 2 ** -6 * want.abs()[:, keep].amax(-1)).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n,kn", [(77, 77), (128, 300), (300, 64)])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_attention(dev, d, n, kn, quant):
    g = _gen(4)
    q = torch.randn(3, n, d, device=dev, generator=g)
    k = torch.randn(3, kn, d, device=dev, generator=g)
    v = torch.randn(3, kn, d, device=dev, generator=g).bfloat16()
    if quant:
        from sdnq_tpu_torch.quant.core import quantize_int_mm
        qq, qs = quantize_int_mm(q)
        kq, kss = quantize_int_mm(k)
        args = (qq, kq, v, qs[..., 0] * d ** -0.5 * ka.LOG2E, kss[..., 0])
    else:
        args = ((q * d ** -0.5 * ka.LOG2E).bfloat16(), k.bfloat16(), v)
    got = ka.flash_attention(*args, out_dtype=torch.float32)
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32)
    assert (got - want).abs().max() <= 2 ** -6 * want.abs().max()


# ---------------------------------------------------------------------------
# B5 / B6 / B7: group-dot kernels on half-split codes
# ---------------------------------------------------------------------------

def _halfsplit(o, k, bits, g, dev, gen, signed=False):
    """Random half-split codes with scale and zpc (O, K/g), as
    ``dequant_mm._group_operands`` builds them."""
    from sdnq_tpu_torch.packing import pack_codes_halfsplit
    codes = torch.randint(0, 2 ** bits, (o, k), device=dev, generator=gen,
                          dtype=torch.int32)
    scale = torch.rand(o, k // g, device=dev, generator=gen) * 0.01 + 1e-3
    if signed:
        zpc = -float(2 ** (bits - 1)) * scale
    else:
        zpc = torch.randn(o, k // g, device=dev, generator=gen) * 0.05
    return pack_codes_halfsplit(codes, bits), scale, zpc


def _magnitude(x, packed, scale, zpc, bits):
    """The group-dot sum of absolute terms: the scale of fp32 rounding."""
    return kd.groupdot_mm_plain(x.float().abs(), packed, scale.abs(),
                                zpc.abs(), None, bits, torch.float32)


@pytest.mark.parametrize("bits,m,k,o,g", [
    (4, 33, 256, 200, 128), (4, 300, 1024, 136, 64), (2, 130, 1024, 384, 128),
    (1, 64, 2048, 128, 256), (4, 17, 15360, 96, 128)])
@pytest.mark.parametrize("signed", [False, True])
def test_groupdot_mm(dev, bits, m, k, o, g, signed):
    """B5: bf16 products are exact in fp32, only the summation order
    differs from the plain version: 1e-5 of the sum of |terms|."""
    gen = _gen(10)
    packed, scale, zpc = _halfsplit(o, k, bits, g, dev, gen, signed)
    x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    bias = torch.randn(o, device=dev, generator=gen)
    got = kd.groupdot_mm(x, packed, scale, zpc, bias, bits, torch.float32)
    want = kd.groupdot_mm_plain(x, packed, scale, zpc, bias, bits,
                                torch.float32)
    bound = 1e-5 * _magnitude(x, packed, scale, zpc, bits) + 1e-6
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("bits,m,k,o,g", [
    (4, 1, 3072, 1000, 128), (4, 8, 256, 300, 128), (2, 3, 256, 300, 64),
    (1, 5, 1024, 200, 128), (4, 2, 15360, 64, 128), (4, 4, 256, 77, 8),
    (2, 6, 512, 130, 128), (1, 7, 1024, 33, 8), (4, 1, 64, 5, 32),
    (1, 8, 128, 64, 16)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_blockdiag_mm(dev, bits, m, k, o, g, x_dtype):
    """B6: fp32 sums in another order (and with FMA): 1e-5 of the sum of
    |terms| in fp32, and that plus half an ulp of the output in bf16 and
    fp16; groups down to 8 codes and up to the field segment, every row
    count 1..8, x from a view off a 16-byte boundary too."""
    gen = _gen(11)
    packed, scale, zpc = _halfsplit(o, k, bits, g, dev, gen, m % 2 == 0)
    x = torch.randn(m, k, device=dev, generator=gen).to(x_dtype)
    bias = torch.randn(o, device=dev, generator=gen)
    want = kd.blockdiag_mm_plain(x, packed, scale, zpc, bias, bits,
                                 torch.float32)
    bound = 1e-5 * _magnitude(x, packed, scale, zpc, bits) + 1e-6
    for out_dtype, half_ulp in ((torch.float32, 0.0), (torch.bfloat16, 2 ** -8),
                                (torch.float16, 2 ** -11)):
        got = kd.blockdiag_mm(x, packed, scale, zpc, bias, bits, out_dtype)
        assert got.dtype == out_dtype
        assert ((got.float() - want).abs()
                <= bound + half_ulp * want.abs()).all()
    flat = torch.zeros(m * k + 1, dtype=x_dtype, device=dev)
    xv = flat[1:].view(m, k)
    xv.copy_(x)
    got = kd.blockdiag_mm(xv, packed, scale, zpc, bias, bits, torch.float32)
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("bits,m,k,o,g", [
    (4, 33, 256, 200, 128), (4, 300, 3072, 136, 128), (2, 130, 1024, 384, 128),
    (1, 64, 2048, 128, 256), (4, 40, 1024, 64, 64), (3, 77, 1024, 130, 128),
    (5, 129, 1024, 200, 64), (6, 40, 512, 72, 128), (7, 300, 2048, 136, 256),
    (5, 33, 15360, 96, 256), (6, 65, 768, 65, 192), (7, 50, 4096, 64, 1024),
    (4, 40, 8192, 64, 4096)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_groupdot_i8_mm_exact(dev, bits, m, k, o, g, out_dtype):
    """B7: integer partials and the same rounded fp32 folds, so the kernel
    equals its plain version bit for bit: 1-7-bit codes in one to three
    field planes, groups of 64 and 192 (ending inside a 128-code stage),
    ragged M and N tails, and large partials (7 bits at g 1024, 4 bits at
    g 4096)."""
    gen = _gen(12)
    packed, scale, zpc = _halfsplit(o, k, bits, g, dev, gen, bits == 2)
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                       dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=gen) * 0.02 + 1e-3
    bias = torch.randn(o, device=dev, generator=gen)
    before = kd.groupdot_i8_mm.launches
    got = kd.groupdot_i8_mm(xq, xs, packed, scale, zpc, bias, bits, out_dtype)
    assert kd.groupdot_i8_mm.launches == before + 1
    want = kd.groupdot_i8_mm_plain(xq, xs, packed, scale, zpc, bias, bits,
                                   out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [16, 3])
def test_groupdot_i8_mm_strided_x(dev, offset):
    """B7 on x a column slice of a wider int8 tensor: rows 16-byte aligned
    (TMA reads it in place) or not (copied); bit-equal."""
    gen = _gen(16)
    m, k, o, g = 70, 1024, 136, 128
    packed, scale, zpc = _halfsplit(o, k, 5, g, dev, gen)
    wide = torch.randint(-127, 128, (m, k + 32), device=dev, generator=gen,
                         dtype=torch.int8)
    xq = wide[:, offset:offset + k]
    xs = torch.rand(m, 1, device=dev, generator=gen) * 0.02 + 1e-3
    got = kd.groupdot_i8_mm(xq, xs, packed, scale, zpc, None, 5,
                            torch.float32)
    want = kd.groupdot_i8_mm_plain(xq, xs, packed, scale, zpc, None, 5,
                                   torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k,g", [(33, 200, 256, 64), (129, 136, 768, 192),
                                     (300, 1000, 3072, 128)])
def test_wgmma_mm_fold_i8(dev, m, n, k, g):
    """B7's GEMM alone on any int8 W' (negative codes too): exact integer
    partials, the plain version's fold; bit-equal."""
    gen = _gen(17)
    x = torch.randint(-128, 128, (m, k), device=dev, generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k), device=dev, generator=gen,
                      dtype=torch.int8)
    scale = torch.rand(n, k // g, device=dev, generator=gen) * 0.01 + 1e-3
    zpc = torch.randn(n, k // g, device=dev, generator=gen) * 0.05
    xsum = x.float().reshape(m, k // g, g).sum(-1)
    xs = torch.rand(m, device=dev, generator=gen) * 0.02 + 1e-3
    bias = torch.randn(n, device=dev, generator=gen)
    args = (x, w, k, "fold_i8", bias, scale, zpc, xsum, torch.float32)
    before = kd.wgmma_mm.mode_launches["fold_i8"]
    got = kd.wgmma_mm(*args, xs=xs)
    assert kd.wgmma_mm.mode_launches["fold_i8"] == before + 1
    assert torch.equal(got, kd.wgmma_mm_plain(*args, xs=xs))


@pytest.mark.parametrize("rows,qmm", [(5, False), (40, False), (40, True)])
@pytest.mark.parametrize("fmt", ["uint4", "int4"])
def test_packed_qlinear_on_card_matches_cpu(dev, rows, qmm, fmt):
    """uint4 / int4 + SVD through qlinear on the card (B6 at 5 rows, B5 at
    40 weight-only rows, B7 with the quantized matmul) against the same
    QTensor on the CPU, bf16 output.  The CPU multiplies fp32 x where the
    card's B5 takes bf16, so the limit is 2^-6 of the largest output (two
    bf16 ulps of it)."""
    import dataclasses
    import sdnq_tpu_torch as T
    gen = _gen(13)
    w = torch.randn(192, 512, device=dev, generator=gen)
    x = torch.randn(rows, 512, device=dev, generator=gen)
    b = torch.randn(192, device=dev, generator=gen)
    qt = T.quantize_tensor(w, fmt, use_quantized_matmul=qmm, use_svd=True,
                           svd_rank=16)
    assert qt.meta.pack_layout == "halfsplit"
    got = T.qlinear(x, qt, b).float().cpu()
    qt_cpu = dataclasses.replace(qt, **{
        f: (None if getattr(qt, f) is None else getattr(qt, f).cpu())
        for f in ("qdata", "scale", "zero_point", "svd_up", "svd_down")})
    want = T.qlinear(x.cpu(), qt_cpu, b.cpu()).float()
    assert (got - want).abs().max() <= 2 ** -6 * want.abs().max()


def test_packed_bitplane_raises_on_card(dev):
    """Bit-plane codes (B2's packed mode) run on the card (int12 at groups
    of 24, 3 rows: the GEMV), and so do multi-plane codes under the
    quantized matmul: above I8_BLOCKDIAG_MAX_ROWS rows on B7 and, since B8
    takes them too, at up to that many rows on B8 (int5), which raised
    before; both agree with the same QTensor on the CPU (one bf16 ulp of
    the largest output)."""
    import dataclasses
    import sdnq_tpu_torch as T
    w = torch.randn(64, 72, device=dev, generator=_gen(14))
    qt = T.quantize_tensor(w, "int12", group_size=24)
    assert qt.meta.pack_layout == "bitplane"
    before = kd.dequant_gemv.mode_launches["bitplane"]
    T.qlinear(torch.randn(3, 72, device=dev), qt)
    assert kd.dequant_gemv.mode_launches["bitplane"] == before + 1
    qt = T.quantize_tensor(torch.randn(256, 1024, device=dev,
                                       generator=_gen(15)), "int5",
                           group_size=128, use_quantized_matmul=True)
    assert qt.meta.pack_layout == "halfsplit"
    qt_cpu = dataclasses.replace(qt, **{
        f: (None if getattr(qt, f) is None else getattr(qt, f).cpu())
        for f in ("qdata", "scale", "zero_point", "svd_up", "svd_down")})
    rows = kd.I8_BLOCKDIAG_MAX_ROWS
    for m, counter in ((rows + 8, kd.groupdot_i8_mm), (rows, kd.blockdiag_i8_mm)):
        x = torch.randn(m, 1024, device=dev, generator=_gen(16))
        before = counter.launches
        got = T.qlinear(x, qt).float().cpu()
        assert counter.launches == before + 1
        want = T.qlinear(x.cpu(), qt_cpu).float()
        assert (got - want).abs().max() <= 2 ** -7 * want.abs().max()


# B2's bit-plane mode and B5 / B6's general mode (multi-plane and minifloat
# half-split codes) against their plain versions.  B2 multiplies the same
# bf16-rounded weights as its plain version and sums in fp32 in another
# order; B5 and B6 form the same exact products (codes or minifloat values
# times bf16 or fp32 x) and fold the groups in another order.  bf16
# outputs: within one bf16 ulp of the largest (2^-7 of it); fp32 outputs:
# 1e-5 of the sum of |terms| (B2) or of the largest output (B5, B6).

def _qt_operands(qt):
    o = qt.qdata.shape[0]
    scale = qt.scale.reshape(o, -1)
    zp = None if qt.zero_point is None else qt.zero_point.reshape(o, -1)
    return qt.qdata, scale, zp


@pytest.mark.parametrize("fmt,k,gsize", [
    ("float8_e3m4fn", 2048, 1024), ("float9_e3m5fn", 768, -1),
    ("int12", 384, 64), ("uint10", 256, 32), ("int9", 200, 40),
    ("float11_e4m6fn", 136, -1), ("uint12", 1000, 200),
    ("float8_e3m4fn", 3104, 776), ("float9_e3m5fn", 1040, -1)])
@pytest.mark.parametrize("m", [1, 5, 32, 33, 300])
def test_dequant_bitplane(dev, fmt, k, gsize, m):
    """Ragged K (200, 136, 1000, 1040: K / 8 not a multiple of 4, a byte a
    lane in the GEMV), planes whose bytes are not a multiple of 32 (3104:
    388 bytes, the GEMV's last 128-byte step short), groups that straddle
    the 8 segments of a byte, rowwise scales and zero points (uint)."""
    import sdnq_tpu_torch as T
    g = _gen(30)
    o = 200
    w = torch.randn(o, k, device=dev, generator=g) * 0.02
    w = w * (1 + 5 * (torch.rand(o, k, device=dev, generator=g) > 0.98))
    qt = T.quantize_tensor(w, fmt, group_size=gsize)
    assert qt.meta.pack_layout == "bitplane"
    f = qt.meta.format
    codes, scale, zp = _qt_operands(qt)
    bias = torch.randn(o, device=dev, generator=g)
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    fn = kd.dequant_gemv if m <= kd.GEMV_MAX_ROWS else kd.dequant_mm
    mode = fn.mode_launches["bitplane"]
    got = fn(x, codes, scale, zp, bias, torch.bfloat16, fmt=f)
    want = kd.dequant_gemv_plain(x, codes, scale, zp, bias, torch.bfloat16,
                                 fmt=f)
    assert fn.mode_launches["bitplane"] == mode + 1
    assert (got.float() - want.float()).abs().max() <= \
        2 ** -7 * want.float().abs().max()
    got = fn(x, codes, scale, zp, None, torch.float32, fmt=f)
    want = kd.dequant_gemv_plain(x, codes, scale, zp, None, torch.float32,
                                 fmt=f)
    wd = T.dequantize(qt, torch.bfloat16).float()
    bound = 1e-5 * (x.float().abs() @ wd.abs().T) + 1e-30
    assert ((got - want).abs() <= bound).all()
    if m <= kd.GEMV_MAX_ROWS:  # fp32 rows: weights rounded to fp32
        xf = x.float()
        got = kd.dequant_gemv(xf, codes, scale, zp, bias, torch.float32,
                              fmt=f)
        want = kd.dequant_gemv_plain(xf, codes, scale, zp, bias,
                                     torch.float32, fmt=f)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


_GENERAL = [("uint3", 256, 32), ("uint5", 512, 64), ("int6", 1024, 256),
            ("uint7", 512, -1), ("int5", 3072, 256), ("int3", 768, 96),
            ("float5_e2m2fn", 512, 128), ("float6_e3m3fnu", 256, 64),
            ("float4_e2m1fn", 512, 64), ("float7_e3m3fn", 1024, 1024)]


def _general_operands(dev, fmt, k, gsize, seed):
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.kernels.dequant_mm import _group_operands
    g = _gen(seed)
    o = 160
    w = torch.randn(o, k, device=dev, generator=g) * 0.02
    qt = T.quantize_tensor(w, fmt, group_size=gsize)
    assert qt.meta.pack_layout == "halfsplit"
    codes, scale, zp = _qt_operands(qt)
    s, zpc = _group_operands(scale, zp, qt.meta.format)
    return codes, s, zpc, torch.randn(o, device=dev, generator=g), \
        qt.meta.format


@pytest.mark.parametrize("fmt,k,gsize", _GENERAL)
@pytest.mark.parametrize("m", [9, 40, 300])
def test_groupdot_mm_general(dev, fmt, k, gsize, m):
    codes, s, zpc, bias, f = _general_operands(dev, fmt, k, gsize, 31)
    x = torch.randn(m, k, device=dev, generator=_gen(32)).bfloat16()
    mode = "minifloat" if not f.is_integer else "multiplane"
    before = kd.groupdot_mm.mode_launches[mode]
    for out_dtype, lim in ((torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)):
        args = (x, codes, s, zpc, bias, f.code_bits, out_dtype, f)
        got = kd.groupdot_mm(*args).float()
        want = kd.groupdot_mm_plain(*args).float()
        assert (got - want).abs().max() <= lim * want.abs().max()
    assert kd.groupdot_mm.mode_launches[mode] == before + 2


def _minifloats():
    """Every minifloat format of 1 to 7 bits in the registry, each at a K
    whose narrowest plane's segment is 64 codes and groups of 8 (the
    geometry limit)."""
    from sdnq_tpu_torch.formats import FORMATS
    out = []
    for name, f in sorted(FORMATS.items()):
        if not f.is_integer and f.num_bits <= 7:
            low = f.num_bits & -f.num_bits
            out.append((name, 64 * 8 // low, 8))
    return out


@pytest.mark.parametrize("fmt,k,gsize", _GENERAL + [("uint5", 64, 8),
                                                    ("float5_e2m2fn", 128,
                                                     16)]
                         + _minifloats())
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_blockdiag_mm_general(dev, fmt, k, gsize, m, xdt):
    codes, s, zpc, bias, f = _general_operands(dev, fmt, k, gsize, 33)
    x = torch.randn(m, k, device=dev, generator=_gen(34)).to(xdt)
    mode = "minifloat" if not f.is_integer else "multiplane"
    before = kd.blockdiag_mm.mode_launches[mode]
    for out_dtype, lim in ((torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)):
        args = (x, codes, s, zpc, bias, f.code_bits, out_dtype, f)
        got = kd.blockdiag_mm(*args).float()
        want = kd.blockdiag_mm_plain(*args).float()
        assert (got - want).abs().max() <= lim * want.abs().max()
    assert kd.blockdiag_mm.mode_launches[mode] == before + 2


# ---------------------------------------------------------------------------
# The decode-once design of B2's tiles and B5: decode_weight, then wgmma_mm
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


@pytest.mark.parametrize("kind", ["int8", "uint8", "float8_e4m3fn"])
@pytest.mark.parametrize("k,groups", [(3072, 3), (200, 5), (1000, 1),
                                      (77, 7)])
@pytest.mark.parametrize("row", [False, True])
def test_decode_weight_unpacked_bit_equal(dev, kind, k, groups, row):
    """Unpacked codes: grouped (code * scale (+ zp) rounded to bf16) and
    the row mode (bf16(code)), ragged K (the padding columns 0)."""
    gen = _gen(40)
    o = 136
    codes = _codes(kind, o, k, gen, dev)
    scale = torch.rand(o, groups, device=dev, generator=gen) * 0.01 + 1e-3
    zp = (torch.randn(o, groups, device=dev, generator=gen) - 1.28
          if kind == "uint8" else None)
    args = (codes, k) if row else (codes, k, scale, zp)
    mode = "row" if row else "grouped"
    before = kd.decode_weight.mode_launches[mode]
    got = kd.decode_weight(*args)
    assert kd.decode_weight.mode_launches[mode] == before + 1
    assert _bits_equal(got, kd.decode_weight_plain(*args))


@pytest.mark.parametrize("fmt,k,gsize", [
    ("float8_e3m4fn", 2048, 1024), ("float9_e3m5fn", 768, -1),
    ("int12", 384, 64), ("uint10", 256, 32), ("int9", 200, 40),
    ("float11_e4m6fn", 136, -1), ("uint12", 1000, 200),
    ("int11", 40, -1), ("int10", 1020, 102), ("uint9", 1020, 204)])
def test_decode_weight_bitplane_bit_equal(dev, fmt, k, gsize):
    """Bit-plane integers and minifloats, S = K / 8 not a multiple of 4
    (200, 136, 1000, 40: a byte a thread), S a multiple of 4 with a group
    that is not (1020 / 102) and with a K tail (1020 / 204: four bytes a
    thread), zero points on the unsigned formats."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.formats import get_format
    assert get_format(fmt).is_packed
    g = _gen(41)
    o = 200
    qt = T.quantize_tensor(torch.randn(o, k, device=dev, generator=g) * 0.02,
                           fmt, group_size=gsize)
    codes, scale, zp = _qt_operands(qt)
    args = (codes, k, scale, zp, qt.meta.format, "bitplane")
    got = kd.decode_weight(*args)
    assert _bits_equal(got, kd.decode_weight_plain(*args))


@pytest.mark.parametrize("fmt,k", [
    ("uint4", 256), ("int4", 3072), ("uint2", 512), ("uint1", 1024),
    ("uint3", 256), ("uint5", 512), ("int6", 1024), ("uint7", 512),
    ("float5_e2m2fn", 512), ("float6_e3m3fnu", 256), ("float4_e2m1fn", 512),
    ("float7_e3m3fn", 1024)])
def test_decode_weight_halfsplit_bit_equal(dev, fmt, k):
    """Half-split codes in one to three field planes: the raw integer code
    or the minifloat value, exact in bf16."""
    import sdnq_tpu_torch as T
    g = _gen(42)
    qt = T.quantize_tensor(torch.randn(96, k, device=dev, generator=g), fmt,
                           group_size=32)
    assert qt.meta.pack_layout == "halfsplit"
    f = qt.meta.format
    args = (qt.qdata, k, None, None, f, "halfsplit", f.code_bits)
    got = kd.decode_weight(*args)
    assert _bits_equal(got, kd.decode_weight_plain(*args))


@pytest.mark.parametrize("fmt,k", [
    ("uint4", 256), ("int4", 3072), ("uint2", 512), ("uint1", 1024),
    ("uint3", 256), ("uint5", 512), ("int6", 1024), ("uint7", 512)])
def test_decode_weight_halfsplit_i8_bit_equal(dev, fmt, k):
    """B7's decode: the raw half-split integer codes as int8, one to three
    field planes."""
    import sdnq_tpu_torch as T
    g = _gen(48)
    qt = T.quantize_tensor(torch.randn(96, k, device=dev, generator=g), fmt,
                           group_size=32)
    assert qt.meta.pack_layout == "halfsplit"
    f = qt.meta.format
    args = (qt.qdata, k, None, None, f, "halfsplit", f.code_bits)
    before = kd.decode_weight.mode_launches["halfsplit_i8"]
    got = kd.decode_weight(*args, dtype=torch.int8)
    assert kd.decode_weight.mode_launches["halfsplit_i8"] == before + 1
    assert torch.equal(got, kd.decode_weight_plain(*args, dtype=torch.int8))


def _gemm_operands(m, n, k, groups, dev, seed):
    g = _gen(seed)
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    w = kd.decode_weight(torch.randint(-127, 128, (n, k), device=dev,
                                       generator=g, dtype=torch.int8), k)
    scale = torch.rand(n, groups, device=dev, generator=g) * 0.01 + 1e-3
    zp = torch.randn(n, groups, device=dev, generator=g) * 0.05
    bias = torch.randn(n, device=dev, generator=g)
    return x, w, scale, zp, bias


_GEMM_SHAPES = [(33, 200, 200), (77, 3072, 768), (129, 1000, 3000),
                (4608, 136, 3072), (300, 128, 64), (1, 8, 40)]


@pytest.mark.parametrize("m,n,k", _GEMM_SHAPES)
@pytest.mark.parametrize("epilogue", ["bias", "row"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
def test_wgmma_mm(dev, m, n, k, epilogue, out_dtype):
    """The GEMM against its plain version at ragged M, N (N % 128 != 0)
    and K (K % 64 != 0, K % 8 != 0 at 3000 / 40: x re-padded): the same
    bf16 products summed in another order; 2^-7 of the largest output in
    bf16 / fp16, 1e-5 of it in fp32."""
    x, w, scale, zp, bias = _gemm_operands(m, n, k, 1, dev, 43)
    kw = {}
    if epilogue == "row":
        kw = dict(scale=scale[:, 0], zp=zp[:, 0], xsum=x.float().sum(-1))
    before = kd.wgmma_mm.mode_launches[epilogue]
    got = kd.wgmma_mm(x, w, k, epilogue, bias, out_dtype=out_dtype, **kw)
    assert kd.wgmma_mm.mode_launches[epilogue] == before + 1
    want = kd.wgmma_mm_plain(x, w, k, epilogue, bias, out_dtype=torch.float32,
                             **kw)
    lim = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    assert (got.float() - want).abs().max() <= lim * want.abs().max()


@pytest.mark.parametrize("m,n,k", [(33, 200, 256), (77, 1000, 3072),
                                   (129, 136, 1024), (4608, 200, 2048)])
@pytest.mark.parametrize("g", [32, 128, 1024])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_wgmma_mm_fold(dev, m, n, k, g, out_dtype):
    """B5's group fold: a group ends inside a stage (32), on a stage's end
    (128) or after many (1024; where K < g the group is K)."""
    g = min(g, k)
    x, w, scale, zp, bias = _gemm_operands(m, n, k, k // g, dev, 44)
    xsum = x.float().reshape(m, k // g, g).sum(-1)
    got = kd.wgmma_mm(x, w, k, "fold", bias, scale, zp, xsum, out_dtype)
    want = kd.wgmma_mm_plain(x, w, k, "fold", bias, scale, zp, xsum,
                             torch.float32)
    lim = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    assert (got.float() - want).abs().max() <= lim * want.abs().max()


def test_wgmma_mm_strided_views(dev):
    """x a column slice of a wider tensor (rows 16-byte aligned: read in
    place), x at an odd offset (copied), and w a layer view of a stack."""
    x_wide = torch.randn(150, 1040, device=dev, generator=_gen(45)).bfloat16()
    x = x_wide[:, 8:1032]
    stack = torch.randn(3, 200, 1024, device=dev,
                        generator=_gen(46)).bfloat16()
    got = kd.wgmma_mm(x, stack[1], 1024, out_dtype=torch.float32)
    want = kd.wgmma_mm_plain(x, stack[1], 1024, out_dtype=torch.float32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # a contiguous x whose rows do not start on 16-byte boundaries: copied
    flat = torch.randn(150 * 1024 + 1, device=dev,
                       generator=_gen(47)).bfloat16()
    x = flat[1:].view(150, 1024)
    got = kd.wgmma_mm(x, stack[1], 1024, out_dtype=torch.float32)
    want = kd.wgmma_mm_plain(x, stack[1], 1024, out_dtype=torch.float32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# ---------------------------------------------------------------------------
# B3 serving modes and B8
# ---------------------------------------------------------------------------

def _attn_inputs(dev, g, bh, bkh, n, kn, d, quant, token):
    from sdnq_tpu_torch.quant.core import quantize_int_mm
    q = torch.randn(bh, n, d, device=dev, generator=g)
    k = torch.randn(bkh, kn, d, device=dev, generator=g)
    v = torch.randn(bkh, kn, d, device=dev, generator=g)
    if quant:
        qq, qs = quantize_int_mm(q)
        kq, ks = quantize_int_mm(k)
        args = [qq, kq, None, qs[..., 0] * d ** -0.5 * ka.LOG2E, ks[..., 0]]
    else:
        args = [(q * d ** -0.5 * ka.LOG2E).bfloat16(), k.bfloat16(), None,
                None, None]
    vs = None
    if token:
        vq, vs = quantize_int_mm(v)
        args[2], vs = vq, vs[..., 0]
    else:
        args[2] = v.bfloat16()
    return args, vs


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n,kn,heads,kv_heads", [
    (72, 256, 4, 2), (200, 512, 8, 1), (64, 1024, 4, 4)])
@pytest.mark.parametrize("mode", ["mask", "causal", "mask_token",
                                  "causal_token", "gqa_bf16_token"])
def test_flash_attention_serving_modes(dev, d, n, kn, heads, kv_heads, mode):
    """Bool masks read through their strides (a (B, 1, N, KN) mask with
    random holes, key 0 always kept), causal with the tile skip, grouped KV
    heads, token-mode int8 P·V with 1-4 P blocks.  Against the plain
    version in fp32, each row against its own largest output (under causal
    the first rows attend a few keys and dwarf the rest): 2^-6 of it where
    P is rounded to bf16 (running against final max); token mode quantizes
    P at the same points as the plain version: 1e-4 of it."""
    g = _gen(20)
    b = 2
    token = "token" in mode
    quant = token and "bf16" not in mode
    args, vs = _attn_inputs(dev, g, b * heads, b * kv_heads,
                            n, kn if "causal" not in mode else n, d, quant,
                            token)
    kw = dict(heads=heads, v_scale=vs,
              p_block=ka.attn_p_block(args[1].shape[1]) if token else None)
    if "causal" in mode:
        kw["causal"] = True
        if token and n % 64:
            pytest.skip("token mode needs KN a multiple of 64")
    else:
        mask = torch.rand(b, 1, n, kn, device=dev, generator=g) < 0.6
        mask[..., 0] = True
        kw["mask"] = mask
    got = ka.flash_attention(*args, out_dtype=torch.float32, **kw)
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, **kw)
    limit = 1e-4 if token and quant else 2 ** -6
    row_err = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert row_err.max() <= limit
    assert ka.flash_attention.mode_launches["int8_pv"] >= int(token)


def test_quantized_attention_decode_on_card(dev):
    """N = 1 takes attention_xla on the card too (no kernel launch): the
    same float64 products as on the CPU, so the two agree to fp32 softmax
    rounding."""
    g = _gen(21)
    q = torch.randn(4, 32, 1, 128, device=dev, generator=g)
    k = torch.randn(4, 8, 1024, 128, device=dev, generator=g)
    v = torch.randn(4, 8, 1024, 128, device=dev, generator=g)
    mask = (torch.arange(1024, device=dev) <= 900)[None, None, None]
    kq, ks, vq, vs = ka.quantize_kv(k, v)
    before = ka.flash_attention.launches
    got = ka.quantized_attention(q, kq, vq, attn_mask=mask, kv_scales=(ks, vs))
    assert ka.flash_attention.launches == before
    want = ka.quantized_attention(q.cpu(), kq.cpu(), vq.cpu(),
                                  attn_mask=mask.cpu(),
                                  kv_scales=(ks.cpu(), vs.cpu()))
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("bits,m,k,o,g", [
    (4, 32, 2048, 200, 64), (4, 1, 1024, 130, 64), (2, 32, 512, 96, 16),
    (1, 7, 1024, 64, 8), (4, 8, 16640, 72, 256), (4, 70, 768, 65, 12),
    (4, 300, 768, 128, 256)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_blockdiag_i8_mm_exact(dev, bits, m, k, o, g, out_dtype):
    """B8: groups of 8 and 16 codes, 65 groups with one straddling the field
    boundary, a group of 12 (the byte-at-a-time loop), straddling groups at
    300 rows; exact integer partials and the plain version's fp32 folds, so
    bit-equal."""
    gen = _gen(22)
    packed, scale, zpc = _halfsplit(o, k, bits, g, dev, gen, bits == 2)
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                       dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=gen) * 0.02 + 1e-3
    bias = torch.randn(o, device=dev, generator=gen)
    got = kd.blockdiag_i8_mm(xq, xs, packed, scale, zpc, bias, bits,
                             out_dtype)
    want = kd.blockdiag_i8_mm_plain(xq, xs, packed, scale, zpc, bias, bits,
                                    out_dtype)
    assert torch.equal(got, want)


def test_packed_qlinear_takes_b8_on_card(dev):
    """uint4 at its auto group of 64 (K 2048 -> 512) on 32 rows with the
    quantized matmul: the JAX route's B8 domain; B8 launches and agrees
    with the same QTensor on the CPU (x quantized alike, exact partials:
    one bf16 ulp of the largest output)."""
    import sdnq_tpu_torch as T
    gen = _gen(23)
    w = torch.randn(512, 2048, device=dev, generator=gen)
    x = torch.randn(32, 2048, device=dev, generator=gen)
    qt = T.quantize_tensor(w, "uint4", use_quantized_matmul=True)
    assert qt.meta.group_size == 64 and qt.meta.pack_layout == "halfsplit"
    before = kd.blockdiag_i8_mm.launches
    got = T.qlinear(x, qt).float().cpu()
    assert kd.blockdiag_i8_mm.launches == before + 1
    import dataclasses
    qt_cpu = dataclasses.replace(qt, **{
        f: (None if getattr(qt, f) is None else getattr(qt, f).cpu())
        for f in ("qdata", "scale", "zero_point", "svd_up", "svd_down")})
    want = T.qlinear(x.cpu(), qt_cpu).float()
    assert (got - want).abs().max() <= 2 ** -7 * want.abs().max()


# B1's training modes and B10.  The int8 GEMMs and the row quantize are
# bit-exact here too (integer sums; the same rounded fp32 epilogue; the
# column scale a single fp32 multiply on both sides); e4m3 products are
# exact in fp32 and only the summation order differs (rtol 1e-5 of the sum
# of |terms|).

@pytest.mark.parametrize("m,k", [(1, 64), (37, 200), (300, 3072)])
@pytest.mark.parametrize("x_fmt", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_colscale(dev, m, k, x_fmt, dtype):
    g = _gen(20)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    cs = torch.rand(k, device=dev, generator=g) * 3e-3 + 1e-4
    got = ks.quantize_rows(x, x_fmt, k_pad=24, colscale=cs)
    want = ks.quantize_rows_plain(x, x_fmt, k_pad=24, colscale=cs)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a,
                           b.view(torch.uint8) if b.element_size() == 1
                           else b)
    assert ks.quantize_rows.mode_launches["colscale"] > 0


@pytest.mark.parametrize("m,n,k", [(1, 8, 64), (130, 200, 192),
                                   (257, 130, 1088), (64, 3072, 256)])
def test_scaled_gemm_nn_int8_exact(dev, m, n, k):
    g = _gen(21)
    a = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), device=dev, generator=g,
                      dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=g) * 0.02
    ws = torch.rand(n, device=dev, generator=g) * 0.02
    got = ks.scaled_gemm(a, b, torch.float32, xs, ws, b_layout="nn")
    want = ks.scaled_gemm_plain(a, b, torch.float32, xs, ws, b_layout="nn")
    assert torch.equal(got, want)
    # against the nt kernel on the transposed copy
    nt = ks.scaled_gemm(a, b.T.contiguous(), torch.float32, xs, ws)
    assert torch.equal(got, nt)


def test_scaled_gemm_nn_fp8(dev):
    g = _gen(22)
    a = torch.randn(150, 192, device=dev, generator=g).to(torch.float8_e4m3fn)
    b = torch.randn(192, 72, device=dev, generator=g).to(torch.float8_e4m3fn)
    xs = torch.rand(150, 1, device=dev, generator=g)
    got = ks.scaled_gemm(a, b, torch.float32, xs, b_layout="nn")
    want = ks.scaled_gemm_plain(a, b, torch.float32, xs, b_layout="nn")
    bound = 1e-5 * (a.float().abs() @ b.float().abs()) * xs
    assert ((got - want).abs() <= bound + 1e-6).all()


def _equal_bytes(a, b):
    return torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                       b.view(torch.uint8) if b.element_size() == 1 else b)


@pytest.mark.parametrize("m", [1, 37, 64, 65, 200, 1536])
@pytest.mark.parametrize("k,n", [(1000, 300), (2000, 3008)])
def test_scaled_gemm_nn_int8_shapes(dev, m, k, n):
    """B4 nn (TMA + s8 wgmma, B transposed in shared memory) bit-equal to
    its plain version at ragged M, N and K, every epilogue term: K and N
    off every tile, and (1000, 300) rows that TMA cannot read in place (the
    wrapper copies them)."""
    g = _gen(25)
    a = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), device=dev, generator=g,
                      dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=g) * 0.02
    ws = torch.rand(n, device=dev, generator=g) * 0.02
    bias, vz0, vz1 = (torch.randn(n, device=dev, generator=g)
                      for _ in range(3))
    rs, zp = (torch.randn(m, device=dev, generator=g) for _ in range(2))
    for args in ((xs, ws, bias, rs, zp, vz0, vz1), (xs,), ()):
        for out_dtype in (torch.float32, torch.bfloat16):
            got = ks.scaled_gemm(a, b, out_dtype, *args, b_layout="nn")
            want = ks.scaled_gemm_plain(a, b, out_dtype, *args,
                                        b_layout="nn")
            assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(1, 18432, 3072), (1, 9216, 3072),
                                   (512, 9216, 3072), (1536, 21504, 3072),
                                   (3, 300, 40)])
def test_scaled_gemm_nn_split_contraction(dev, m, k, n):
    """The contraction split by ``nn_plan`` (the batch-1 modulation
    grad-inputs, txt qkv, linear1) adds its int32 partials exactly:
    bit-equal to the plain version and to the kernel with no split, call
    after call on the workspace (its counters as the last call left
    them)."""
    g = _gen(26)
    a = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), device=dev, generator=g,
                      dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=g) * 1e-4
    nb, whole, splits = ks.nn_plan(m, n, k, torch.int8,
                                   torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
    got = ks.scaled_gemm(a, b, torch.float32, xs, b_layout="nn")
    assert torch.equal(got, ks.scaled_gemm_plain(a, b, torch.float32, xs,
                                                 b_layout="nn"))
    tiles = -(-m // 128) * -(-n // (128 * nb))
    plan = ks.nn_plan
    try:  # every tile whole; every tile split 2, 3 and 7 ways; the tail only
        for p in ((nb, tiles, 1), (nb, 0, 2), (nb, 0, 3), (nb, 0, 7),
                  (nb, tiles // 2, 5)):
            if p[2] > -(-k // 128):
                continue
            ks.nn_plan = lambda *args, p=p, **kw: p
            for _ in range(2):
                assert torch.equal(ks.scaled_gemm(a, b, torch.float32, xs,
                                                  b_layout="nn"), got), p
    finally:
        ks.nn_plan = plan


def test_scaled_gemm_nn_views(dev):
    """Operands off a 16-byte boundary or with rows TMA cannot read are
    copied by the wrapper, and the result equals the plain version."""
    g = _gen(27)
    a = torch.randint(-128, 128, (70, 200), device=dev, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (200, 260), device=dev, generator=g,
                      dtype=torch.int8)
    xs = torch.rand(70, 1, device=dev, generator=g) * 0.02
    want = ks.scaled_gemm_plain(a, b, torch.float32, xs, b_layout="nn")
    av, bv = _unreadable_rows(a, g), _unreadable_rows(b, g)
    assert torch.equal(ks.scaled_gemm(av, bv, torch.float32, xs,
                                      b_layout="nn"), want)


@pytest.mark.parametrize("m,k,n", [(1, 18432, 3072), (65, 1000, 300),
                                   (200, 2000, 3008)])
def test_scaled_gemm_nn_fp8_shapes(dev, m, k, n):
    """e4m3 nn (fp16 wgmma, B MN-major) within 1e-5 of sum |a b| at ragged
    shapes and with the contraction split (M = 1)."""
    g = _gen(28)
    a = (torch.randn(m, k, device=dev, generator=g) * 8).to(
        torch.float8_e4m3fn)
    b = (torch.randn(k, n, device=dev, generator=g) * 8).to(
        torch.float8_e4m3fn)
    xs = torch.rand(m, 1, device=dev, generator=g)
    got = ks.scaled_gemm(a, b, torch.float32, xs, b_layout="nn")
    want = ks.scaled_gemm_plain(a, b, torch.float32, xs, b_layout="nn")
    bound = 1e-5 * (a.float().abs() @ b.float().abs()) * xs
    assert ((got - want).abs() <= bound + 1e-6).all()


def _planted_rows(m, k, x_fmt, dtype, g):
    """Rows of x whose quotients x / scale are half-integers where the
    plain version's division rounds them (ties to even): each row's scale
    is s0 = 2^-4 exactly (its largest |x| 127 s0; uint8 also its least
    -128 s0, so that zp is 0), and half of its values are (n + 1/2) s0,
    exact in bf16 and fp16."""
    s0 = 2.0 ** -4
    x = (torch.rand(m, k, device="cuda", generator=g) * 250 - 125) * s0
    n = torch.randint(-127, 127, (m, k), device="cuda", generator=g)
    half = torch.rand(m, k, device="cuda", generator=g) < 0.5
    x = torch.where(half, (n.float() + 0.5) * s0, x)
    x[:, 0] = 127 * s0
    if x_fmt == "uint8" and k > 1:
        x[:, 1] = -128 * s0
    return x.to(dtype)


@pytest.mark.parametrize("m,k", [(1, 37), (300, 37), (1, 21504),
                                 (300, 21504), (64, 3072), (5000, 3072),
                                 (5, 18432), (3, 30000)])
@pytest.mark.parametrize("x_fmt", ["int8", "uint8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quantize_rows_bit_equal(dev, m, k, x_fmt, dtype):
    """B1's row quantizer (one read of x, the multiply with the division
    next to half-integers) bit-equal to the plain version in every mode
    and dtype: codes, scales, zero points, row sums, with and without the
    column scale, with half-integer quotients planted, through each of its
    kernels: rows staged in shared memory a block a row (K 3072 to 21504;
    M 1 included, and M 5000, where a block takes several rows through
    both of its buffers more than once), the two-pass loop with 16-byte
    loads (fp32 at K 30000: two rows do not fit in shared memory) and a
    value at a time (odd K, and any K of x off a 16-byte boundary)."""
    g = _gen(29)
    x = _planted_rows(m, k, x_fmt, dtype, g)
    for cs in (None, torch.ones(k, device=dev),
               2.0 ** torch.randint(-2, 3, (k,), device=dev,
                                    generator=g).float()):
        for pad in (0, 11):
            got = ks.quantize_rows(x, x_fmt, k_pad=pad, colscale=cs)
            want = ks.quantize_rows_plain(x, x_fmt, k_pad=pad, colscale=cs)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    assert _equal_bytes(a, b)
    off = torch.empty(m * k + 1, dtype=dtype, device=dev)[1:].view(m, k)
    off.copy_(x)   # contiguous, one value off a 16-byte boundary
    for pad in (0, 11):
        got = ks.quantize_rows(off, x_fmt, k_pad=pad)
        want = ks.quantize_rows_plain(x, x_fmt, k_pad=pad)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert _equal_bytes(a, b)


@pytest.mark.parametrize("m", [1, 37, 64, 200])
def test_fused_act_nn_colscale_emit(dev, m):
    """The grad-input route (nn + colscale) and the forward's emitted
    residual, bit-equal to the plain composition."""
    g = _gen(23)
    o, k = 384, 256
    x = torch.randn(m, o, device=dev, generator=g).bfloat16()
    w = torch.randint(-127, 128, (o, k), device=dev, generator=g,
                      dtype=torch.int8)
    cs = torch.rand(o, device=dev, generator=g) * 1e-2
    got = ks.scaled_mm_fused_act(x, w, None, None, b_layout="nn",
                                 x_colscale=cs, out_dtype=torch.float32)
    xq, xs = ks.quantize_rows_plain(x, "int8", colscale=cs)[:2]
    want = ks.scaled_gemm_plain(xq, w, torch.float32, xs, b_layout="nn")
    assert torch.equal(got, want)
    xk = torch.randn(m, k, device=dev, generator=g).bfloat16()
    y, eq, es = ks.scaled_mm_fused_act(xk, w, None, None, emit_quantized=True)
    pq, ps = ks.quantize_rows_plain(xk, "int8")[:2]
    assert torch.equal(eq, pq) and torch.equal(es, ps)


def _unreadable_rows(t, g):
    """An equal view of ``t`` (M, C) that TMA cannot read in place: rows
    a multiple of 4 but not of 16 bytes apart, and one byte off a 16-byte
    boundary where the rows are dense."""
    m, c = t.shape
    pad = 4 if (c + 4) % 16 else 8
    big = torch.zeros(m * (c + pad) + 1, dtype=t.dtype, device=t.device)
    v = big[1:].view(m, c + pad)[:, :c]
    v.copy_(t)
    return v


@pytest.mark.parametrize("m,n,k", [(1, 8, 64), (1, 18432, 3072),
                                   (37, 200, 132), (100, 258, 126),
                                   (1536, 384, 640), (7, 100, 36),
                                   (31, 132, 260), (32, 388, 68),
                                   (33, 260, 516), (70, 200, 136),
                                   (96, 132, 260), (1000, 1028, 300)])
def test_scaled_mm_tn_int8_exact(dev, m, n, k):
    """B10 int8 bit-equal to its plain version at ragged M (a stage of 32,
    64, 96 or 128 tokens), N and K (multiples of 4 but not of 16 included),
    with and without each scale and on views TMA cannot read in place (the
    wrapper copies them); the rank-R term within ``TN_LOWRANK_TOL`` (fp32
    in r order against torch's u @ v), also as the uint8 family's rank-2
    term through ``dynamic_mm_tn``."""
    g = _gen(24)
    a = torch.randint(-128, 128, (m, n), device=dev, generator=g,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                      dtype=torch.int8)
    a_s = torch.rand(n, device=dev, generator=g) * 0.02
    b_s = torch.rand(k, device=dev, generator=g) * 0.02
    for sc in ((a_s, b_s), (a_s, None), (None, b_s), (None, None)):
        got = ks.scaled_mm_tn(a, b, *sc)
        want = ks.scaled_mm_tn_plain(a, b, *sc)
        assert torch.equal(got, want)
    av, bv = _unreadable_rows(a, g), _unreadable_rows(b, g)
    assert torch.equal(ks.scaled_mm_tn(av, bv, a_s, b_s),
                       ks.scaled_mm_tn_plain(a, b, a_s, b_s))

    def within(got, want, u, v):
        mag = want.abs() + u.abs() @ v.abs()
        return bool(((got - want).abs() <= ks.TN_LOWRANK_TOL * mag).all())
    u = torch.randn(n, 2, device=dev, generator=g)
    v = torch.randn(2, k, device=dev, generator=g)
    got = ks.scaled_mm_tn(a, b, a_s, b_s, lowrank_u=u, lowrank_v=v)
    assert within(got, ks.scaled_mm_tn_plain(a, b, a_s, b_s, lowrank_u=u,
                                             lowrank_v=v), u, v)
    ga = torch.randn(m, n, device=dev, generator=g) + 0.5
    xb = torch.randn(m, k, device=dev, generator=g) * 2
    ops = ks.uint8_tn_operands(ga, xb)
    want = ks.scaled_mm_tn_plain(*ops[:4], lowrank_u=ops[4], lowrank_v=ops[5])
    assert within(ks.dynamic_mm_tn(ga, xb, "uint8"), want, ops[4], ops[5])


@pytest.mark.parametrize("m,n,k", [(1, 64, 64), (70, 200, 136),
                                   (1024, 512, 256), (7, 100, 36),
                                   (31, 132, 260), (32, 388, 68),
                                   (33, 260, 516), (1000, 1028, 300)])
def test_scaled_mm_tn_fp8(dev, m, n, k):
    """B10 e4m3 (fp16 wgmma on converted stages): 1e-5 of the sum of
    |terms|, with and without each scale, and on views TMA cannot read in
    place."""
    g = _gen(25)
    a = torch.randn(m, n, device=dev, generator=g).to(torch.float8_e4m3fn)
    b = torch.randn(m, k, device=dev, generator=g).to(torch.float8_e4m3fn)
    a_s = torch.rand(n, device=dev, generator=g)
    b_s = torch.rand(k, device=dev, generator=g)
    terms = a.float().abs().T @ b.float().abs()
    for sc in ((a_s, b_s), (a_s, None), (None, b_s), (None, None)):
        got = ks.scaled_mm_tn(a, b, *sc)
        want = ks.scaled_mm_tn_plain(a, b, *sc)
        bound = terms * (1 if sc[0] is None else a_s[:, None]) \
            * (1 if sc[1] is None else b_s[None, :])
        assert ((got - want).abs() <= 1e-5 * bound + 1e-6).all()
    got = ks.scaled_mm_tn(_unreadable_rows(a, g), _unreadable_rows(b, g),
                          a_s, b_s)
    want = ks.scaled_mm_tn_plain(a, b, a_s, b_s)
    bound = terms * a_s[:, None] * b_s[None, :]
    assert ((got - want).abs() <= 1e-5 * bound + 1e-6).all()


def test_fit_adamw_sr_on_card(dev):
    """``fit``'s default generator lies on the card, so AdamW's stochastic
    rounding draws its bits beside the card's parameters."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.optim import adamw
    from sdnq_tpu_torch.train import fit, make_train_params, train_qlinear
    g = _gen(26)
    w = torch.randn(256, 512, device=dev, generator=g)
    tp = make_train_params({"w": T.quantize_tensor(
        w, "int8", use_quantized_matmul=True)})
    x = torch.randn(64, 512, device=dev, generator=g).bfloat16()
    opt = adamw(lr=1e-2, quantize_state=True, stochastic_rounding=True)
    q0 = tp["w"].qt.qdata.clone()

    def step(state, gen):
        loss = train_qlinear(x, tp["w"]).float().square().mean()
        loss.backward()
        return loss, lambda: opt.update(None, state, tp, gen)[1]

    state = fit(step, opt.init(tp), 2, params=tp)
    assert state["step"] == 2
    assert tp["w"].qt.qdata.is_cuda
    assert (tp["w"].qt.qdata != q0).any()


def test_scaled_mm_tn_rejects(dev):
    a = torch.zeros(4, 8, device=dev).bfloat16()
    with pytest.raises(ValueError):
        ks.scaled_mm_tn(a, a)
    z = torch.zeros(0, 8, device=dev, dtype=torch.int8)
    assert torch.equal(ks.scaled_mm_tn(z, z), torch.zeros(8, 8, device=dev))


# ---------------------------------------------------------------------------
# B9: flash attention over one KV block (the ring's step), unnormalised
# partials (acc, m, l) in natural-log units
# ---------------------------------------------------------------------------

def _block_inputs(dev, g, bh, n, kn, mode):
    """The ring's block operands: per-token int8 q, k with q_scale carrying
    sm_scale (``int8``), or bf16 (``bf16``); v bf16, or per-token int8 with
    v_scale (``token``)."""
    from sdnq_tpu_torch.quant.core import quantize_int_mm
    d = 128
    q = torch.randn(bh, n, d, device=dev, generator=g)
    k = torch.randn(bh, kn, d, device=dev, generator=g)
    v = torch.randn(bh, kn, d, device=dev, generator=g)
    quant, token = mode != "bf16", mode == "int8_token"
    if quant:
        qq, qs = quantize_int_mm(q)
        kq, ks = quantize_int_mm(k)
        args = [qq, kq, None, qs[..., 0] * d ** -0.5, ks[..., 0], None]
    else:
        args = [q.bfloat16(), k.bfloat16(), None, None, None, None]
    if token:
        vq, vs = quantize_int_mm(v)
        args[2], args[5] = vq, vs[..., 0]
    else:
        args[2] = v.bfloat16()
    return args, dict(quantized=quant, quantized_pv=token,
                      sm_scale=d ** -0.5)


def _block_check(got, want, token):
    """acc / l per row within 2^-6 of the row's largest output where P is
    rounded to bf16 (against a 64-key tile's running max in the kernel, a
    block's in the plain version), 1e-4 in token mode (P quantized at the
    same points); m to fp32 rounding of the scores (1e-5 of max |m|); l to
    1e-5 relative."""
    (acc, m, l), (wacc, wm, wl) = got, want
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert m.shape == l.shape == (acc.shape[0], acc.shape[1], 1)
    live = wm > -1e29
    assert torch.equal(m[~live], wm[~live])
    assert (m - wm).abs().max() <= 1e-5 * wm[live].abs().max()
    assert ((l - wl).abs() / wl).max() <= 1e-5
    out, wout = acc / l, wacc / wl
    row = (out - wout).abs().amax(-1) / wout.abs().amax(-1)
    assert row.max() <= (1e-4 if token else 2 ** -6)


@pytest.mark.parametrize("n,kn", [(72, 256), (256, 1152), (136, 1024)])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_token"])
@pytest.mark.parametrize("mask", [None, "triangle", "holes_false_row"])
def test_flash_attention_block(dev, n, kn, mode, mask):
    """B9 against its plain version: no mask, a (1, N, KN) triangle read by
    every head, and a (BH, N, KN) mask with random holes and one row hidden
    everywhere (m = -1e30, every p = 1, l = KN); token mode with 1-3 P
    blocks (KN 1152: blocks of 128)."""
    g = _gen(40)
    bh = 6
    args, kw = _block_inputs(dev, g, bh, n, kn, mode)
    if mask == "triangle":
        args.append(torch.ones(n, kn, dtype=torch.bool, device=dev)
                    .tril()[None])
    elif mask == "holes_false_row":
        hm = torch.rand(bh, n, kn, device=dev, generator=g) < 0.5
        hm[..., 0] = True
        hm[2, 5] = False
        args.append(hm.to(torch.int8))
    before = ka.flash_attention_block.launches
    got = ka.flash_attention_block(*args, **kw)
    assert ka.flash_attention_block.launches == before + 1
    want = ka.flash_attention_block_plain(*args, **kw)
    _block_check(got, want, mode == "int8_token")
    if mask == "holes_false_row":
        assert got[1][2, 5, 0] == torch.tensor(-1e30) and \
            got[2][2, 5, 0] == kn


def test_flash_attention_block_additive_mask(dev):
    """A float mask (``mask_is_bool=False``) is added to the natural-unit
    scores, bf16 or fp32, read through its strides."""
    g = _gen(41)
    args, kw = _block_inputs(dev, g, 4, 64, 512, "bf16")
    bias = torch.randn(1, 64, 512, device=dev, generator=g)
    for mask in (bias, bias.bfloat16()):
        got = ka.flash_attention_block(*args, mask, mask_is_bool=False, **kw)
        want = ka.flash_attention_block_plain(*args, mask, mask_is_bool=False,
                                              **kw)
        _block_check(got, want, False)


def test_flash_attention_block_routes_on_card(dev):
    """The JAX route on the card: KN % 128 != 0 or D 64 take the XLA block
    function in plain torch (no launch); D 256 with KN 128 passes the
    route and runs B9 (its D 256 kernels), D 384 passes it and raises."""
    g = _gen(42)
    q = torch.randn(2, 64, 128, device=dev, generator=g).bfloat16()
    kw = dict(quantized=False, sm_scale=0.1)
    b9, xla = ka.flash_attention_block.launches, ka.attention_block_xla.calls
    got = ka.flash_attention_block(q, q[:, :48], q[:, :48], **kw)
    assert ka.flash_attention_block.launches == b9
    assert ka.attention_block_xla.calls == xla + 1
    want = ka.attention_block_xla(*(t.cpu() for t in (q, q[:, :48],
                                                      q[:, :48])), **kw)
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()
    wide = torch.randn(2, 128, 256, device=dev, generator=g).bfloat16()
    b9 = ka.flash_attention_block.launches
    got = ka.flash_attention_block(wide, wide, wide, **kw)
    assert ka.flash_attention_block.launches == b9 + 1
    _block_check(got, ka.flash_attention_block_plain(wide, wide, wide, **kw),
                 False)
    wider = torch.zeros(2, 128, 384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="above 256"):
        ka.flash_attention_block(wider, wider, wider, **kw)
    k = torch.zeros(2, 128, 128, device=dev)
    with pytest.raises(ValueError):   # float q / k on the kernel route
        ka.flash_attention_block(q.float(), k, k.bfloat16(), **kw)


def test_ring_on_card_matches_local_and_float64(dev):
    """``ring_attention`` through a mesh of one on the card (B9), and the
    local ring at P = 2 (B9) and 4 (chunks of 64 keys: the XLA block
    function), causal in the zigzag layout, against float64 attention."""
    from sdnq_tpu_torch.parallel import create_mesh, ring_attention
    from sdnq_tpu_torch.parallel.ring_attention import _local_ring
    g = _gen(43)
    q, k, v = (torch.randn(1, 4, 512, 128, device=dev, generator=g)
               for _ in range(3))
    s = (q.double() @ k.double().transpose(-1, -2)) * 128 ** -0.5
    s = s.masked_fill(~torch.ones(512, 512, dtype=torch.bool,
                                  device=dev).tril(), float("-inf"))
    ref = torch.softmax(s, -1) @ v.double()
    before = ka.flash_attention_block.launches
    outs = [ring_attention(q, k, v, create_mesh(sequence=1), causal=True)]
    outs += [_local_ring(q, k, v, p, causal=True) for p in (2, 4)]
    assert ka.flash_attention_block.launches > before
    for out in outs:   # the JAX tests' limit for int8
        assert (out.double() - ref).abs().max() < 0.05


# ---------------------------------------------------------------------------
# B3 / B9's TMA + wgmma kernel (bf16 P.V) at its edges: tensor maps per
# head, a ring of stages that wraps many times, the diagonal tile with a
# ragged end, the ring's block shapes, fp16 output, int8 Q.K^T at D 64
# (the 64-byte swizzle) over grouped heads.  Limits as above: 2^-6 of the
# largest output (per row under masks); B9's m and l within 1e-5.
# ---------------------------------------------------------------------------

def _rows_close(got, want, limit=2 ** -6):
    assert torch.isfinite(got).all()
    row = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert row.max() <= limit


@pytest.mark.parametrize("quant", [False, True])
def test_flash_attention_head_edge_reads_no_next_head(dev, quant):
    """KN 200 (a ragged last tile) over 3 KV heads, 6 query heads: k and v
    are the first 3 heads of a 4-head tensor whose 4th is NaN, so a tile
    that read past its head's KN into the next head's rows would give NaN
    (0 x NaN); the 3-D tensor maps zero-fill there instead."""
    g = _gen(60)
    n, kn, d = 136, 200, 128
    q = torch.randn(6, n, d, device=dev, generator=g)
    kbig, vbig = (torch.randn(4, kn, d, device=dev, generator=g)
                  for _ in range(2))
    kbig[3], vbig[3] = float("nan"), float("nan")
    if quant:
        from sdnq_tpu_torch.quant.core import quantize_int_mm
        qq, qs = quantize_int_mm(q)
        kq, kss = quantize_int_mm(kbig)
        args = (qq, kq[:3], vbig.bfloat16()[:3],
                qs[..., 0] * d ** -0.5 * ka.LOG2E, kss[:3, :, 0])
    else:
        args = ((q * d ** -0.5 * ka.LOG2E).bfloat16(), kbig.bfloat16()[:3],
                vbig.bfloat16()[:3])
    got = ka.flash_attention(*args, out_dtype=torch.float32, heads=6)
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, heads=6)
    _rows_close(got, want)


def test_flash_attention_long_ring(dev):
    """N = KN = 4608 at BH 2: 36 tiles of 128 keys a block, so the ring of
    K / V stages wraps many times."""
    args, _ = _attn_inputs(dev, _gen(61), 2, 2, 4608, 4608, 128, False,
                           False)
    got = ka.flash_attention(*args[:3], out_dtype=torch.float32)
    want = ka.flash_attention_plain(*args[:3], out_dtype=torch.float32)
    assert (got - want).abs().max() <= 2 ** -6 * want.abs().max()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
def test_flash_attention_causal_ragged_diagonal(dev, out_dtype):
    """Causal at N = KN = 1000: every block's first tile holds its diagonal,
    the last block's also KN's ragged end (1000 = 7 x 128 + 104); fp16
    output."""
    args, _ = _attn_inputs(dev, _gen(62), 4, 2, 1000, 1000, 128, False,
                           False)
    kw = dict(heads=4, causal=True)
    got = ka.flash_attention(*args[:3], out_dtype=out_dtype, **kw)
    assert got.dtype == out_dtype
    want = ka.flash_attention_plain(*args[:3], out_dtype=torch.float32, **kw)
    _rows_close(got.float(), want)


def test_flash_attention_int8_qk_d64_gqa(dev):
    """int8 Q.K^T at D 64 (64-byte rows, the 64-byte swizzle) with 8 query
    heads over 2 KV heads, bf16 P.V, a bool mask with random holes."""
    g = _gen(63)
    b, h, kh, n, kn = 2, 8, 2, 200, 384
    args, _ = _attn_inputs(dev, g, b * h, b * kh, n, kn, 64, True, False)
    mask = torch.rand(b, 1, n, kn, device=dev, generator=g) < 0.7
    mask[..., 0] = True
    kw = dict(heads=h, mask=mask)
    got = ka.flash_attention(*args, out_dtype=torch.float32, **kw)
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, **kw)
    _rows_close(got, want)


@pytest.mark.parametrize("n", [2304, 1152])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_flash_attention_block_ring_shapes(dev, n, mode):
    """B9 at the ring's P = 2 and P = 4 block shapes of FLUX's joint
    attention (4608 tokens cut in 2 and 4), bf16 P.V."""
    args, kw = _block_inputs(dev, _gen(64), 4, n, n, mode)
    args.append(None)
    got = ka.flash_attention_block(*args, **kw)
    want = ka.flash_attention_block_plain(*args, **kw)
    _block_check(got, want, False)


def test_flash_attention_rejects_misaligned(dev):
    """q, k and v go through TMA tensor maps: views off a 16-byte boundary
    are copied before the launch (no longer refused), and the result
    equals the kernel's on fresh aligned copies and agrees with the plain
    version as the other B3 rows do (2^-6 of each row's largest output);
    B9 the same."""
    g = _gen(65)
    args, _ = _attn_inputs(dev, g, 2, 2, 64, 128, 128, False, False)
    views = []
    for t in args[:3]:
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        views.append(view)
    got = ka.flash_attention(*views, out_dtype=torch.float32)
    aligned = ka.flash_attention(*(v.clone() for v in views),
                                 out_dtype=torch.float32)
    assert torch.equal(got, aligned)
    want = ka.flash_attention_plain(*args[:3], out_dtype=torch.float32)
    _rows_close(got, want)
    bargs, kw = _block_inputs(dev, g, 2, 128, 256, "bf16")
    bviews = []
    for t in bargs[:3]:
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        bviews.append(buf[1:].view(t.shape))
        bviews[-1].copy_(t)
    got = ka.flash_attention_block(*bviews, *bargs[3:], None, **kw)
    want = ka.flash_attention_block_plain(*bargs, None, **kw)
    _block_check(got, want, False)


# B4's nt kernel (TMA + wgmma): every operand kind at ragged M, N and K, every
# epilogue term and output type, a layer view of a stacked weight and
# misaligned views.  int8 is bit-equal; e4m3 and bf16 differ from the plain
# version in summation order only (1e-5 / 1e-4 of the sum of |terms|, as
# test_scaled_gemm_fp8 / _bf16).

def _b4_operands(dev, g, kind, m, n, k):
    if kind == "int8":
        a = torch.randint(-128, 128, (m, k), device=dev, generator=g,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (n, k), device=dev, generator=g,
                          dtype=torch.int8)
    else:
        dt = torch.bfloat16 if kind == "bf16" else torch.float8_e4m3fn
        a = torch.randn(m, k, device=dev, generator=g).to(dt)
        b = (torch.randn(n, k, device=dev, generator=g) * 4).to(dt)
    return a, b


def _b4_check(a, b, got, want, xs, ws):
    if a.dtype == torch.int8:
        assert torch.equal(got, want)
        return
    rtol = 1e-4 if a.dtype == torch.bfloat16 else 1e-5
    mag = a.float().abs() @ b.float().abs().T
    if xs is not None:
        mag = mag * xs.reshape(-1, 1)
    if ws is not None:
        mag = mag * ws.reshape(1, -1)
    # one ulp of the output type on top where it is narrower than fp32
    ulp = {torch.float32: 0.0, torch.bfloat16: 2 ** -7,
           torch.float16: 2 ** -10}[got.dtype]
    bound = rtol * mag + ulp * want.float().abs() + 1e-6
    assert ((got.float() - want.float()).abs() <= bound).all()


@pytest.mark.parametrize("kind", ["int8", "e4m3", "bf16"])
@pytest.mark.parametrize("m,n,k", [(1000, 3000, 3000), (33, 200, 1088),
                                   (1, 8, 24), (300, 520, 100)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
def test_scaled_gemm_nt_ragged(dev, kind, m, n, k, out_dtype):
    """Ragged M, N and K (K not a multiple of the 128-byte stage row: TMA's
    zero fill), with and without every epilogue term (xs, ws, bias and the
    uint8 rank-1 terms)."""
    g = _gen(30)
    a, b = _b4_operands(dev, g, kind, m, n, k)
    xs = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
    ws = torch.rand(n, device=dev, generator=g) * 0.02 + 1e-3
    bias = torch.randn(n, device=dev, generator=g)
    rs, zp = (torch.randn(m, device=dev, generator=g) for _ in range(2))
    vz0, vz1 = (torch.randn(n, device=dev, generator=g) for _ in range(2))
    before = ks.scaled_gemm.mode_launches["nt"]
    for extra in ({}, dict(xs=xs, ws=ws, bias=bias, rs=rs, zp=zp, vz0=vz0,
                           vz1=vz1)):
        got = ks.scaled_gemm(a, b, out_dtype, **extra)
        want = ks.scaled_gemm_plain(a, b, out_dtype, **extra)
        _b4_check(a, b, got, want, extra.get("xs"), extra.get("ws"))
    assert ks.scaled_gemm.mode_launches["nt"] == before + 2


@pytest.mark.parametrize("kind", ["int8", "e4m3", "bf16"])
def test_scaled_gemm_nt_views(dev, kind):
    """A layer of a stacked (L, N, K) weight read in place (its view's
    base), and operands off a 16-byte boundary or with a row stride that is
    not a multiple of 16 bytes, copied before the launch: all equal the
    kernel on fresh contiguous copies."""
    g = _gen(31)
    m, n, k = 200, 384, 512
    a, _ = _b4_operands(dev, g, kind, m, n, k)
    stack, _ = _b4_operands(dev, g, kind, 3 * n, n, k)
    stack = stack.reshape(3, n, k)
    xs = torch.rand(m, 1, device=dev, generator=g) * 0.02
    layer = stack[1]
    got = ks.scaled_gemm(a, layer, torch.float32, xs)
    assert torch.equal(got, ks.scaled_gemm(a, layer.clone(), torch.float32,
                                           xs))
    _b4_check(a, layer, got, ks.scaled_gemm_plain(a, layer, torch.float32,
                                                  xs), xs, None)
    # misaligned base; a row stride of K + 1 elements
    buf = torch.zeros(m * k + 1, device=dev, dtype=a.dtype)
    off = buf[1:].view(m, k)
    off.copy_(a)
    wide = torch.zeros(n, k + 1, device=dev, dtype=a.dtype)
    wide[:, :k].copy_(layer)
    got = ks.scaled_gemm(off, wide[:, :k], torch.float32, xs)
    assert torch.equal(got, ks.scaled_gemm(a, layer.clone(), torch.float32,
                                           xs))


def test_scaled_gemm_refuses_inexact_int8_k(dev):
    """An int32 sum is exact only for K < 2^17: at K = 2^17 the kernel
    adds its parts' int32 sums in int64 and stays exact (the name is kept
    from when it raised there), codes of -128 summing to 2^31 exactly."""
    a = torch.full((2, 1 << 17), -128, device=dev, dtype=torch.int8)
    got = ks.scaled_gemm(a, a, torch.float32)
    assert torch.equal(got, ks.scaled_gemm_plain(a, a, torch.float32))
    assert got[0, 0].item() == 2.0 ** 31


# B8 on the tensor cores: every half-split width; groups of 8 and 16, of 40
# (ending inside k32 steps), of 64, and of 1024 (straddling every plane's
# field boundaries at K 5120); rows from 1 up to past the route's cut-off;
# exact integer partials and the plain version's fp32 folds, so bit-equal.
# x and the codes also as views whose row stride is padded past the dense
# one (the kernel reads dense rows: the wrapper copies such views).

@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("g", [8, 16, 40, 64, 1024])
@pytest.mark.parametrize("m", [1, 17, 32, 128])
def test_blockdiag_i8_mm_widths(dev, bits, g, m):
    gen = _gen(32)
    k, o = 5120, 72
    packed, scale, zpc = _halfsplit(o, k, bits, g, dev, gen, bits == 2)
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                       dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=gen) * 0.02 + 1e-3
    bias = torch.randn(o, device=dev, generator=gen)
    got = kd.blockdiag_i8_mm(xq, xs, packed, scale, zpc, bias, bits,
                             torch.float32)
    want = kd.blockdiag_i8_mm_plain(xq, xs, packed, scale, zpc, bias, bits,
                                    torch.float32)
    assert torch.equal(got, want)
    nb = packed.shape[1]
    xpad = torch.zeros(m, k + 16, device=dev, dtype=torch.int8)
    xpad[:, :k].copy_(xq)
    cpad = torch.zeros(o, nb + 16, device=dev, dtype=torch.uint8)
    cpad[:, :nb].copy_(packed)
    got = kd.blockdiag_i8_mm(xpad[:, :k], xs, cpad[:, :nb], scale, zpc, bias,
                             bits, torch.float32)
    assert torch.equal(got, want)


# B3 / B9 in token mode on the TMA + s8 wgmma kernel (64-key tiles, V^T
# written once a call in vt_key's order, three passes a P block).  Token
# mode quantizes P at the same points as the plain version (the codes by
# the division's rounding), so each row agrees to fp32 rounding: 1e-4 of
# the row's largest output, as test_flash_attention_serving_modes.

def _token_inputs(dev, g, bh, bkh, n, kn, d, quant=True):
    args, vs = _attn_inputs(dev, g, bh, bkh, n, kn, d, quant, True)
    return args, dict(v_scale=vs, p_block=ka.attn_p_block(kn))


@pytest.mark.parametrize("n", [1, 63, 65, 896])
@pytest.mark.parametrize("kn", [64, 192, 1024])
@pytest.mark.parametrize("d,qpk", [(64, 1), (64, 4), (128, 1), (128, 4)])
def test_flash_attention_token(dev, n, kn, d, qpk):
    """Query rows off and on the 64-row blocks, P blocks of 64, 192 (three
    tiles) and 512 keys (two blocks), one and four query heads a KV head,
    D 64 and 128, int8 Q.K^T."""
    g = _gen(70)
    b, kh = 2, 2
    args, kw = _token_inputs(dev, g, b * kh * qpk, b * kh, n, kn, d)
    kw["heads"] = kh * qpk
    before = ka.flash_attention.mode_launches["int8_pv"]
    got = ka.flash_attention(*args, out_dtype=torch.float32, **kw)
    assert ka.flash_attention.mode_launches["int8_pv"] == before + 1
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, **kw)
    _rows_close(got, want, 1e-4)


@pytest.mark.parametrize("mask", ["causal", "bool", "bf16", "fp32"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_attention_token_masks(dev, mask, out_dtype, quant):
    """Causal (the diagonal's tile masked inside, the tiles right of it not
    read), a bool (B, 1, N, KN) mask with holes, and additive bf16 / fp32
    (1, H, N, KN) masks broadcast over the batch with one row -inf
    everywhere (0, not NaN); int8 or bf16 Q.K^T, every output type (bf16 /
    fp16: one ulp of the output on top).  bf16 Q.K^T sums its products in
    another order than the plain version, so a P code may round the other
    way: 2^-6 of the row's largest output there, as in
    test_flash_attention_serving_modes."""
    g = _gen(71)
    b, h, kh, n = 2, 4, 2, 320   # P blocks of 320 keys: five tiles
    args, kw = _token_inputs(dev, g, b * h, b * kh, n, n, 128, quant)
    kw["heads"] = h
    row = None
    if mask == "causal":
        kw["causal"] = True
    elif mask == "bool":
        mk = torch.rand(b, 1, n, n, device=dev, generator=g) < 0.6
        mk[..., 0] = True
        kw["mask"] = mk
    else:
        mk = torch.randn(1, h, n, n, device=dev, generator=g) * 2
        row = 7
        mk[:, :, row] = float("-inf")
        kw["mask"] = mk.to(torch.bfloat16 if mask == "bf16" else
                           torch.float32)
    got = ka.flash_attention(*args, out_dtype=out_dtype, **kw).float()
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, **kw)
    assert torch.isfinite(got).all()
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    if row is not None:
        assert not got[:, row].any()
        keep[row] = False
    ulp = {torch.float32: 0.0, torch.bfloat16: 2 ** -8,
           torch.float16: 2 ** -11}[out_dtype]
    err = (got - want).abs()[:, keep]
    lim = (1e-4 if quant else 2 ** -6) * want.abs()[:, keep].amax(
        -1, keepdim=True) \
        + ulp * want.abs()[:, keep]
    assert (err <= lim).all()


@pytest.mark.parametrize("mask_heads", [1, 3, 6])
@pytest.mark.parametrize("kn", [384, 1024])
def test_flash_attention_block_token_mask_heads(dev, mask_heads, kn):
    """B9's token mode with a bool mask of 1, 3 or 6 heads over BH 6 (row bh
    reads mask head bh % mask_heads), one row hidden everywhere (m = -1e30,
    every p = 1, l = KN), N 136 off the 64-row blocks, P blocks of 384 keys
    (six tiles) and 512."""
    g = _gen(72)
    bh, n = 6, 136
    args, kw = _block_inputs(dev, g, bh, n, kn, "int8_token")
    mk = torch.rand(mask_heads, n, kn, device=dev, generator=g) < 0.5
    mk[..., 0] = True
    mk[0, 9] = False
    args.append(mk)
    got = ka.flash_attention_block(*args, **kw)
    want = ka.flash_attention_block_plain(*args, **kw)
    _block_check(got, want, True)
    assert got[1][0, 9, 0] == torch.tensor(-1e30) and got[2][0, 9, 0] == kn


def test_flash_attention_token_views_off_16_bytes(dev):
    """q, k and v views that start off a 16-byte boundary are copied by the
    wrappers (TMA reads them), in token mode as in the bf16 one: the result
    equals the kernel's on aligned copies, for B3 and B9."""
    g = _gen(73)
    args, kw = _token_inputs(dev, g, 4, 2, 100, 256, 128)
    views = []
    for t in args[:3]:
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        views.append(view)
    kw["heads"] = 4
    got = ka.flash_attention(*views, *args[3:], out_dtype=torch.float32, **kw)
    aligned = ka.flash_attention(*(v.clone() for v in views), *args[3:],
                                 out_dtype=torch.float32, **kw)
    assert torch.equal(got, aligned)
    bargs, bkw = _block_inputs(dev, g, 2, 128, 512, "int8_token")
    bviews = []
    for t in bargs[:3]:
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        bviews.append(buf[1:].view(t.shape))
        bviews[-1].copy_(t)
    got = ka.flash_attention_block(*bviews, *bargs[3:], None, **bkw)
    want = ka.flash_attention_block_plain(*bargs, None, **bkw)
    _block_check(got, want, True)


# B2's rowwise and grouped GEMV (a stream of the weight: 16-byte code loads,
# x staged once a block, K split over warps for layers with few rows).  fp32
# sums in another order than the plain version's: 1e-5 of the sum of
# |terms| (_grouped_bound, the weight rounded to x's dtype in both).

@pytest.mark.parametrize("m", [1, 4, 5, 8, 17, 32])
@pytest.mark.parametrize("k,o", [(8, 7), (771, 1024), (14336, 1),
                                 (4096, 14336), (14336, 1024)])
def test_dequant_gemv_rows(dev, m, k, o):
    """Rowwise int8 codes with bf16 x at every row count: K 8 and K 771
    (the wrapper pads them to multiples of 16), K 14336 (x staged up to 128
    KB, read through L1 above), one output row, 1024 rows (K split over
    warps) and 14336."""
    gen = _gen(74)
    codes = _codes("int8", o, k, gen, dev)
    scale = torch.rand(o, device=dev, generator=gen) * 0.01 + 1e-3
    x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    bias = torch.randn(o, device=dev, generator=gen)
    got = kd.dequant_gemv(x, codes, scale, None, bias, torch.float32)
    want = kd.dequant_gemv_plain(x, codes, scale, None, bias, torch.float32)
    assert ((got - want).abs() <= _grouped_bound(x, codes, scale, None,
                                                 bias)).all()


@pytest.mark.parametrize("kind", ["int8", "uint8", "float8_e4m3fn"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("gsize", [8, 32, 128, 1024, None])
def test_dequant_gemv_groups(dev, kind, x_dtype, gsize):
    """Every code kind (uint8 with a zero point), x dtype and group size
    (None: rowwise), at M 4 (x staged) and 5, O 1024 (K split) and 72."""
    gen = _gen(75)
    k = 3072
    groups = 1 if gsize is None else k // gsize
    for m, o in ((4, 1024), (5, 72)):
        codes = _codes(kind, o, k, gen, dev)
        scale = torch.rand(o, groups, device=dev, generator=gen) * 0.01 \
            + 1e-3
        zp = (torch.randn(o, groups, device=dev, generator=gen) - 1.28
              if kind == "uint8" else None)
        x = torch.randn(m, k, device=dev, generator=gen).to(x_dtype)
        bias = torch.randn(o, device=dev, generator=gen)
        if gsize is None:
            scale = scale[:, 0]
            zp = None if zp is None else zp[:, 0]
        got = kd.dequant_gemv(x, codes, scale, zp, bias, torch.float32)
        want = kd.dequant_gemv_plain(x, codes, scale, zp, bias,
                                     torch.float32)
        bound = _grouped_bound(x, codes, scale, zp, bias)
        if gsize is None and zp is not None:
            bound = bound + 1e-5 * x.float().abs().sum(-1, keepdim=True) \
                * zp.abs()[None]
        assert ((got - want).abs() <= bound).all()


def test_dequant_gemv_views_off_alignment(dev):
    """x and codes starting off a 16-byte boundary are copied by the
    wrapper; the result equals the aligned call's."""
    gen = _gen(76)
    k, o = 1024, 300
    codes = _codes("int8", o, k, gen, dev)
    scale = torch.rand(o, 8, device=dev, generator=gen) * 0.01
    x = torch.randn(3, k, device=dev, generator=gen).bfloat16()
    xb = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)
    xv = xb[1:].view(x.shape)
    xv.copy_(x)
    cb = torch.empty(codes.numel() + 3, device=dev, dtype=codes.dtype)
    cv = cb[3:].view(codes.shape)
    cv.copy_(codes)
    assert xv.data_ptr() % 16 and cv.data_ptr() % 16
    got = kd.dequant_gemv(xv, cv, scale, None, None, torch.float32)
    assert torch.equal(got, kd.dequant_gemv(x, codes, scale, None, None,
                                            torch.float32))


# ---------------------------------------------------------------------------
# Head-mode int8 P·V and e4m3 Q·K (B3, and B9 for e4m3).  Head mode rounds
# p127 at the same points as its plain version and e4m3 products are exact
# in the fp16 wgmma's fp32 sum, so with int8 or e4m3 Q·K each row agrees to
# 1e-4 of its largest output, as token mode does; with bf16 Q·K (products
# summed in another order) a code may round the other way: 2^-6, and
# likewise where P is rounded to bf16 (bf16 P·V).
# ---------------------------------------------------------------------------

def _new_mode_inputs(dev, g, bh, bkh, n, kn, d, qk, pv):
    """q, k of Q·K kind ``qk`` (bf16 pre-scaled, or int8 / e4m3 per token
    with q_scale carrying sm_scale·log2 e), v for P·V mode ``pv`` (bf16,
    token or head), and the keywords of that mode."""
    from sdnq_tpu_torch.quant.core import quantize_fp_mm, quantize_int_mm
    q = torch.randn(bh, n, d, device=dev, generator=g)
    k = torch.randn(bkh, kn, d, device=dev, generator=g)
    v = torch.randn(bkh, kn, d, device=dev, generator=g)
    if qk == "bf16":
        args = [(q * d ** -0.5 * ka.LOG2E).bfloat16(), k.bfloat16(), None,
                None, None]
    else:
        quant = quantize_int_mm if qk == "int8" else quantize_fp_mm
        (qq, qs), (kq, ks) = quant(q), quant(k)
        args = [qq, kq, None, qs[..., 0] * d ** -0.5 * ka.LOG2E, ks[..., 0]]
    kw = {}
    if pv == "bf16":
        args[2] = v.bfloat16()
    elif pv == "token":
        vq, vs = quantize_int_mm(v)
        args[2] = vq
        kw = dict(v_scale=vs[..., 0], p_block=ka.attn_p_block(kn))
    else:
        vs = v.abs().amax((1, 2)).clamp_min(1e-20) / 127.0
        args[2] = torch.round(v / vs[:, None, None]).to(torch.int8)
        kw = dict(v_head_scale=vs, p_block=ka.attn_p_block(kn))
    return args, kw


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n,kn,qpk", [(72, 256, 1), (200, 1024, 2),
                                      (65, 192, 4)])
@pytest.mark.parametrize("qk", ["bf16", "int8", "e4m3"])
def test_flash_attention_head_mode(dev, d, n, kn, qpk, qk):
    """Head-mode P·V with every Q·K kind: query rows off the 64-row blocks,
    P blocks of 192 (three tiles), 256 and 512 keys (two blocks), grouped KV
    heads; fp32 and bf16 output (the head scale applied to the rounded
    output, as the JAX wrapper does)."""
    g = _gen(80)
    b, kh = 2, 2
    args, kw = _new_mode_inputs(dev, g, b * kh * qpk, b * kh, n, kn, d, qk,
                                "head")
    kw["heads"] = kh * qpk
    before = dict(ka.flash_attention.mode_launches)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ka.flash_attention(*args, out_dtype=out_dtype, **kw).float()
        want = ka.flash_attention_plain(*args, out_dtype=out_dtype,
                                        **kw).float()
        _rows_close(got, want, (1e-4 if qk != "bf16" else 2 ** -6)
                    + (2 ** -8 if out_dtype == torch.bfloat16 else 0))
    modes = ka.flash_attention.mode_launches
    assert modes["head_pv"] == before["head_pv"] + 2
    assert modes[f"{qk}_qk"] == before[f"{qk}_qk"] + 2


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("pv", ["bf16", "token", "head"])
@pytest.mark.parametrize("mask", [None, "causal", "bool", "fp32"])
def test_flash_attention_e4m3(dev, d, pv, mask):
    """e4m3 Q·K (Q and every K tile converted to fp16 in shared memory) with
    each P·V mode, a ragged KN (bf16 P·V: the last tile zero-filled), 4
    query heads over 2 KV heads, and each mask kind."""
    g = _gen(81)
    b, h, kh, n = 2, 4, 2, 136
    kn = 320 if pv != "bf16" else 200
    args, kw = _new_mode_inputs(dev, g, b * h, b * kh, n, kn, d, "e4m3", pv)
    kw["heads"] = h
    if mask == "causal":
        kw["causal"] = True
    elif mask == "bool":
        mk = torch.rand(b, 1, n, kn, device=dev, generator=g) < 0.6
        mk[..., 0] = True
        kw["mask"] = mk
    elif mask == "fp32":
        kw["mask"] = torch.randn(1, h, n, kn, device=dev, generator=g) * 2
    got = ka.flash_attention(*args, out_dtype=torch.float32, **kw)
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, **kw)
    _rows_close(got, want, 2 ** -6 if pv == "bf16" else 1e-4)


@pytest.mark.parametrize("n,kn", [(72, 256), (136, 1024)])
@pytest.mark.parametrize("token", [False, True])
def test_flash_attention_block_e4m3(dev, n, kn, token):
    """B9 with e4m3 Q·K (q_scale carrying sm_scale) and bf16 or token-mode
    P·V, a bool mask with one row hidden everywhere."""
    from sdnq_tpu_torch.quant.core import quantize_fp_mm, quantize_int_mm
    g = _gen(82)
    bh, d = 4, 128
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g)
               for s in (n, kn, kn))
    (qq, qs), (kq, ks) = quantize_fp_mm(q), quantize_fp_mm(k)
    args = [qq, kq, v.bfloat16(), qs[..., 0] * d ** -0.5, ks[..., 0], None]
    if token:
        vq, vs = quantize_int_mm(v)
        args[2], args[5] = vq, vs[..., 0]
    mk = torch.rand(1, n, kn, device=dev, generator=g) < 0.5
    mk[..., 0] = True
    mk[0, 9] = False
    args.append(mk)
    kw = dict(quantized=True, quantized_pv=token, sm_scale=d ** -0.5)
    before = ka.flash_attention_block.mode_launches["e4m3_qk"]
    got = ka.flash_attention_block(*args, **kw)
    assert ka.flash_attention_block.mode_launches["e4m3_qk"] == before + 1
    _block_check(got, ka.flash_attention_block_plain(*args, **kw), token)


@pytest.mark.parametrize("kw", [
    dict(matmul_dtype="int8", pv_matmul_dtype="int8"),
    dict(matmul_dtype="fp8", pv_matmul_dtype="int8"),
    dict(matmul_dtype="fp8")])
@pytest.mark.parametrize("kn", [256, 77])
def test_quantized_attention_new_modes_card_vs_cpu(dev, kw, kn):
    """``quantized_attention`` in head mode and with fp8 Q·K on the card
    (B3 at KN 256, the XLA function at the UNet's 77 text tokens) against
    the same call on the CPU, bf16 in and out: 2^-6 of each row's largest
    output on top of two bf16 ulps (the CPU's plain version and the card
    round bf16 P, and the output, at other points)."""
    g = torch.Generator().manual_seed(83)
    q = torch.randn(2, 5, 256, 64, generator=g).bfloat16()
    k, v = (torch.randn(2, 5, kn, 64, generator=g).bfloat16()
            for _ in range(2))
    want = ka.quantized_attention(q, k, v, **kw).float()
    got = ka.quantized_attention(q.to(dev), k.to(dev), v.to(dev),
                                 **kw).float().cpu()
    _rows_close(got, want, 2 ** -6 + 2 ** -7)


# ---------------------------------------------------------------------------
# fp16 x on B2's tiles and B5 (the weight decoded in x's type), B2's e5m2
# codes and fp16 bit-plane mode, B3 at any head dim up to 256 and at a value
# head dim other than the query's (zero-padded), B9 at D 256
# ---------------------------------------------------------------------------

def _terms_bound(x, w, lim=1e-5):
    """``lim`` of each output's sum of |terms|, x (M, K) times the weight
    w (O, K) as the kernel multiplies it."""
    return lim * (x.float().abs() @ w.float().abs().T) + 1e-30


def _fp16_operands(dev, mode, m, seed=90):
    """x fp16 (M, K) and a weight quantized on the card for one of B2's
    tile modes (grouped int8, rowwise uint8 with a zero point, bit-plane
    float8_e3m4fn of R1, B5's uint4): (x, codes, scale, zp, bias, fmt, g,
    layout, the weight as fp16 rounds it)."""
    import sdnq_tpu_torch as T
    g = _gen(seed)
    fmt, gsize, k = {"grouped": ("int8", 128, 2048),
                     "row": ("uint8", -1, 1536),
                     "bitplane": ("float8_e3m4fn", 1024, 2048),
                     "halfsplit": ("uint4", 128, 2048)}[mode]
    o = 200
    w = torch.randn(o, k, device=dev, generator=g) * 0.02
    qt = T.quantize_tensor(w, fmt, group_size=gsize)
    codes, scale, zp = _qt_operands(qt)
    if codes.dim() > 2:
        codes = codes.reshape(o, -1)
    x = torch.randn(m, k, device=dev, generator=g).half()
    bias = torch.randn(o, device=dev, generator=g)
    wd = T.dequantize(qt, torch.float32)
    return (x, codes, scale, zp, bias, qt.meta.format, k // scale.shape[1],
            qt.meta.pack_layout, wd)


def _kernel_terms(mode, x, codes, scale, zp, f, wd):
    """Each output's sum of |terms| as the kernel forms it: B2 grouped and
    bit-plane, x times each weight rounded to x's type; the row mode, x
    times the exact codes, then the scale, plus rowsum(x) times the zero
    point; B5, each group's product of x and the exact codes (or minifloat
    values) times its scale, plus the group's rowsum times zpc."""
    xa = x.float().abs()
    if mode in ("grouped", "bitplane"):
        return xa @ wd.to(x.dtype).float().abs().T
    o, k = wd.shape
    if mode == "row":
        c = codes.float() * scale.reshape(o, 1)
        off = zp.reshape(o, 1).abs().expand(o, k) if zp is not None else 0
        return xa @ (c.abs() + off).T
    from sdnq_tpu_torch.kernels.dequant_mm import (
        _group_operands, _halfsplit_values)
    s, zpc = _group_operands(scale, zp, f)
    vals = _halfsplit_values(codes, f.code_bits, k, f)
    g = k // s.shape[1]
    c = (vals.reshape(o, -1, g).abs() * s[..., None]
         + zpc.abs()[..., None]).reshape(o, k)
    return xa @ c.T


@pytest.mark.parametrize("mode", ["grouped", "row", "bitplane", "halfsplit"])
@pytest.mark.parametrize("m", [40, 300])
def test_fp16_x_on_the_tiles(dev, mode, m):
    """fp16 x stays fp16 on B2's tiles and B5: the weight is decoded in
    fp16 (B2: each scaled weight rounded to fp16, as the TPU kernel's
    scratch of x's dtype rounds it) and multiplied by the fp16 wgmma.
    fp32 out within 1e-5 of each output's sum of |terms| as the kernel
    forms them; fp16 out within 2^-10 of the largest output.  The old cast
    of x (and so of the weight) to bf16 misses the first bound."""
    x, codes, scale, zp, bias, f, g, layout, wd = _fp16_operands(dev, mode, m)
    fn = kd.groupdot_mm if mode == "halfsplit" else kd.dequant_mm
    before = fn.mode_launches["fp16"]
    args = (x, codes, scale, zp, bias, f, g)
    got = kd.dequant_matmul(*args, out_dtype=torch.float32,
                            pack_layout=layout)
    want = kd.dequant_matmul(*(t.cpu() if torch.is_tensor(t) else t
                               for t in args), out_dtype=torch.float32,
                             pack_layout=layout).to(dev)
    assert fn.mode_launches["fp16"] == before + 1
    bound = 1e-5 * (_kernel_terms(mode, x, codes, scale, zp, f, wd)
                    + bias.abs()) + 1e-30
    assert ((got - want).abs() <= bound).all()
    got16 = kd.dequant_matmul(*args, out_dtype=torch.float16,
                              pack_layout=layout).float()
    assert (got16 - want).abs().max() <= 2 ** -10 * want.abs().max()
    old = kd.dequant_matmul(x.bfloat16(), *args[1:], out_dtype=torch.float32,
                            pack_layout=layout)
    assert not ((old - want).abs() <= bound).all()


@pytest.mark.parametrize("kind", ["float8_e5m2", "int8"])
@pytest.mark.parametrize("k,groups,row", [(3072, 3, False), (200, 5, False),
                                          (1000, 1, True)])
def test_decode_weight_fp16_and_e5m2_bit_equal(dev, kind, k, groups, row):
    """The decode in fp16 (x's type) and of e5m2 codes (the high byte of
    their fp16 value), bit-equal to the plain version in bf16 and fp16."""
    gen = _gen(91)
    o = 136
    codes = (torch.randn(o, k, device=dev, generator=gen) * 300).to(
        torch.float8_e5m2) if kind == "float8_e5m2" else _codes(
            kind, o, k, gen, dev)
    scale = torch.rand(o, groups, device=dev, generator=gen) * 0.01 + 1e-3
    args = (codes, k) if row else (codes, k, scale, None)
    for dt in (torch.bfloat16, torch.float16):
        got = kd.decode_weight(*args, dtype=dt)
        assert got.dtype == dt
        assert _bits_equal(got, kd.decode_weight_plain(*args, dtype=dt))


@pytest.mark.parametrize("m", [1, 4, 32, 40, 300])
@pytest.mark.parametrize("g", [-1, 128])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16,
                                 torch.float16])
def test_e5m2_codes(dev, m, g, xdt):
    """Native e5m2 weights (rowwise and grouped): the GEMV (M <= 32, every
    x type) and the tiles (bf16 and fp16 x), fp32 out: 1e-5 of each
    output's sum of |terms|."""
    import sdnq_tpu_torch as T
    gen = _gen(92)
    o, k = 264, 1024
    qt = T.quantize_tensor(torch.randn(o, k, device=dev, generator=gen),
                           "float8_e5m2", group_size=g)
    codes, scale, zp = _qt_operands(qt)
    codes = codes.reshape(o, k)
    assert codes.dtype == torch.float8_e5m2
    x = torch.randn(m, k, device=dev, generator=gen).to(xdt)
    bias = torch.randn(o, device=dev, generator=gen)
    if m > kd.GEMV_MAX_ROWS and xdt == torch.float32:
        x = x.bfloat16()   # the tiles take 16-bit x
    fn = kd.dequant_gemv if m <= kd.GEMV_MAX_ROWS else kd.dequant_mm
    before = fn.launches
    got = fn(x, codes, scale, zp, bias, torch.float32)
    want = kd.dequant_gemv_plain(x, codes, scale, zp, bias, torch.float32)
    assert fn.launches == before + 1
    wd = T.dequantize(qt, torch.float32)
    assert ((got - want).abs()
            <= _terms_bound(x, wd) + 1e-6 * bias.abs().max()).all()


@pytest.mark.parametrize("fmt,k,gsize", [("float8_e3m4fn", 2048, 1024),
                                         ("float9_e3m5fn", 1040, -1),
                                         ("uint10", 256, 32)])
@pytest.mark.parametrize("m", [1, 5, 32])
def test_bitplane_gemv_fp16(dev, fmt, k, gsize, m):
    """B2's bit-plane GEMV at fp16 x: each scaled weight rounded to fp16;
    fp32 out within 1e-5 of each output's sum of |terms|, fp16 out within
    2^-10 of the largest output."""
    import sdnq_tpu_torch as T
    g = _gen(93)
    o = 200
    qt = T.quantize_tensor(torch.randn(o, k, device=dev, generator=g) * 0.02,
                           fmt, group_size=gsize)
    codes, scale, zp = _qt_operands(qt)
    f = qt.meta.format
    x = torch.randn(m, k, device=dev, generator=g).half()
    bias = torch.randn(o, device=dev, generator=g)
    before = kd.dequant_gemv.mode_launches["bitplane"]
    got = kd.dequant_gemv(x, codes, scale, zp, bias, torch.float32, fmt=f)
    want = kd.dequant_gemv_plain(x, codes, scale, zp, bias, torch.float32,
                                 fmt=f)
    assert kd.dequant_gemv.mode_launches["bitplane"] == before + 1
    wd = T.dequantize(qt, torch.float32).half()
    assert ((got - want).abs()
            <= _terms_bound(x, wd) + 1e-6 * bias.abs().max()).all()
    got16 = kd.dequant_gemv(x, codes, scale, zp, bias, torch.float16, fmt=f)
    assert got16.dtype == torch.float16
    assert (got16.float() - want).abs().max() <= 2 ** -10 * want.abs().max()


def _head_dim_inputs(dev, g, bh, bkh, n, kn, d, vd, qk, pv):
    """``_new_mode_inputs`` with v at its own head dim vd."""
    from sdnq_tpu_torch.quant.core import quantize_fp_mm, quantize_int_mm
    args, kw = _new_mode_inputs(dev, g, bh, bkh, n, kn, d, qk, "bf16")
    v = torch.randn(bkh, kn, vd, device=dev, generator=g)
    if pv == "bf16":
        args[2] = v.bfloat16()
    elif pv == "token":
        vq, vs = quantize_int_mm(v)
        args[2] = vq
        kw = dict(v_scale=vs[..., 0], p_block=ka.attn_p_block(kn))
    else:
        vs = v.abs().amax((1, 2)).clamp_min(1e-20) / 127.0
        args[2] = torch.round(v / vs[:, None, None]).to(torch.int8)
        kw = dict(v_head_scale=vs, p_block=ka.attn_p_block(kn))
    return args, kw


@pytest.mark.parametrize("d,vd", [(100, 100), (160, 160), (256, 256),
                                  (32, 32), (64, 96), (200, 128)])
@pytest.mark.parametrize("qk", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("pv", ["bf16", "token", "head"])
def test_flash_attention_any_head_dim(dev, d, vd, qk, pv):
    """B3 at head dims the kernels do not hold (zero-padded to the next of
    64, 128, 256: D 32, 100, 160, 200) and at D 256 (two blocks a query
    tile, each writing 128 of the output columns), v's head dim other than
    q's (64 / 96, 200 / 128), 4 query heads over 2 KV heads, a ragged KN
    for bf16 P·V, causal at D 256 and 100.  Against the plain version on
    the unpadded operands: 2^-6 of each row's largest output with bf16
    P·V or bf16 Q·K, 2^-7 with e4m3 Q·K, 1e-4 otherwise."""
    g = _gen(94)
    b, h, kh, n = 2, 4, 2, 136
    kn = 320 if pv != "bf16" else 200
    args, kw = _head_dim_inputs(dev, g, b * h, b * kh, n, kn, d, vd, qk, pv)
    kw["heads"] = h
    if d in (100, 256) and pv != "bf16":
        kw["causal"] = True
        args, kw2 = _head_dim_inputs(dev, g, b * h, b * kh, kn, kn, d, vd,
                                     qk, pv)
        kw2.update(heads=h, causal=True)
        kw = kw2
    before = dict(ka.flash_attention.mode_launches)
    got = ka.flash_attention(*args, out_dtype=torch.float32, **kw)
    want = ka.flash_attention_plain(*args, out_dtype=torch.float32, **kw)
    assert got.shape == want.shape and got.shape[-1] == vd
    modes = ka.flash_attention.mode_launches
    assert modes["padded"] == before["padded"] + (d not in (64, 128, 256)
                                                  or vd != d)
    assert modes["d256"] == before["d256"] + (max(d, vd) > 128)
    # bf16 Q.K^T sums its products in another order than the plain
    # version, as e4m3's do: a P code at a tie moves by a step there
    _rows_close(got, want, 2 ** -6 if pv == "bf16" or qk == "bf16" else
                2 ** -7 if qk == "e4m3" else 1e-4)


@pytest.mark.parametrize("qk", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("token", [False, True])
def test_flash_attention_block_d256(dev, qk, token):
    """B9 at D 256 (two blocks a query tile; the first writes m and l) with
    each Q·K kind, bf16 or token-mode P·V, a bool mask with a row hidden
    everywhere."""
    from sdnq_tpu_torch.quant.core import quantize_fp_mm, quantize_int_mm
    g = _gen(95)
    bh, d, n, kn = 4, 256, 136, 1024
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g)
               for s in (n, kn, kn))
    if qk == "bf16":
        args = [q.bfloat16(), k.bfloat16(), v.bfloat16(), None, None, None]
    else:
        quant = quantize_int_mm if qk == "int8" else quantize_fp_mm
        (qq, qs), (kq, ks) = quant(q), quant(k)
        args = [qq, kq, v.bfloat16(), qs[..., 0] * d ** -0.5, ks[..., 0],
                None]
    if token:
        vq, vs = quantize_int_mm(v)
        args[2], args[5] = vq, vs[..., 0]
    mk = torch.rand(1, n, kn, device=dev, generator=g) < 0.5
    mk[..., 0] = True
    mk[0, 9] = False
    args.append(mk)
    kw = dict(quantized=qk != "bf16", quantized_pv=token,
              sm_scale=d ** -0.5)
    before = ka.flash_attention_block.mode_launches["d256"]
    got = ka.flash_attention_block(*args, **kw)
    assert ka.flash_attention_block.mode_launches["d256"] == before + 1
    _block_check(got, ka.flash_attention_block_plain(*args, **kw),
                 token and qk == "int8")


@pytest.mark.parametrize("m,k", [(1, 3072), (37, 200), (300, 3072),
                                 (64, 7681)])
@pytest.mark.parametrize("x_fmt", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_given_scale(dev, m, k, x_fmt, dtype):
    """B1's row quantizer with a given row scale (a row-parallel shard's,
    from the all-reduced absolute maximum), bit-equal to the plain
    version, through the staged kernel and both loops, with a column
    scale and without; a shard's codes against the whole rows' scale
    equal the whole rows' codes."""
    g = _gen(31)
    x = _planted_rows(m, k, x_fmt, dtype, g)
    whole = ks.quantize_rows(x, x_fmt)
    for cs in (None, 2.0 ** torch.randint(-2, 3, (k,), device=dev,
                                          generator=g).float()):
        xf = x.float() if cs is None else x.float() * cs
        scale = ks.row_scale_from_amax(xf.abs().amax(-1), x_fmt).reshape(-1)
        for pad in (0, 11):
            got = ks.quantize_rows(x, x_fmt, k_pad=pad, colscale=cs,
                                   row_scale=scale)
            want = ks.quantize_rows_plain(x, x_fmt, k_pad=pad, colscale=cs,
                                          row_scale=scale)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    assert _equal_bytes(a, b)
    # a second half of the columns against the whole rows' scale
    half = k // 2
    part = ks.quantize_rows(x[:, half:].contiguous(), x_fmt,
                            row_scale=whole[1].reshape(-1))
    assert _equal_bytes(part[0], whole[0][:, half:])
    with pytest.raises(ValueError, match="uint8"):
        ks.quantize_rows(x, "uint8", row_scale=whole[1].reshape(-1))


@pytest.mark.parametrize("n,x", [(3072, 3072), (3072, 12288),
                                 (3072, 21504)])
def test_scaled_gemm_ns_shapes(dev, n, x):
    """B4 nt at Muon's Newton-Schulz shapes of a FLUX leaf (3072 x X):
    the Gram (N, N, K X), its square (N, N, N) and the update (N, X, N)
    with bᵀ copied to (X, N); int8 bit-equal."""
    g = _gen(37)
    for m, nn, k in ((n, n, x), (n, n, n), (n, x, n)):
        a = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (nn, k), device=dev, generator=g,
                          dtype=torch.int8)
        xs = torch.rand(m, 1, device=dev, generator=g) * 1e-3
        ws = torch.rand(nn, 1, device=dev, generator=g) * 1e-3
        got = ks.scaled_mm(a, b, xs, ws, out_dtype=torch.float32)
        want = ks.scaled_gemm_plain(a, b, torch.float32, xs, ws)
        assert torch.equal(got, want)


def _long_codes(shape, g, dev, lines, dim):
    """Random int8 codes with ``lines`` (index, code) rows (dim 0) or
    columns (dim 1) set to one extreme code, so that their sums pass
    2^31."""
    x = torch.randint(-128, 128, shape, device=dev, generator=g,
                      dtype=torch.int8)
    for i, c in lines:
        x.select(dim, i).fill_(c)
    return x


@pytest.mark.parametrize("k", [(1 << 17) + 96, 1 << 18])
@pytest.mark.parametrize("m,n", [(300, 200), (130, 520)])
def test_scaled_gemm_long_contraction_exact(dev, k, m, n):
    """B4 nt and nn over a contraction of 2^17 rows or more (a ragged tail,
    and 2^18): each tile's parts summed in int64, bit-equal to the plain
    version where rows of -128 and 127 make sums past 2^31, every epilogue
    term, call after call on the workspace."""
    g = _gen(41)
    a = _long_codes((m, k), g, dev, ((0, -128), (1, 127), (m - 1, -128)), 0)
    bt = _long_codes((n, k), g, dev, ((0, -128), (1, -128), (n - 1, 127)), 0)
    xs = torch.rand(m, 1, device=dev, generator=g) * 1e-6
    ws = torch.rand(n, device=dev, generator=g) * 0.02
    bias, vz0, vz1 = (torch.randn(n, device=dev, generator=g)
                      for _ in range(3))
    rs, zp = (torch.randn(m, device=dev, generator=g) for _ in range(2))
    assert ks.scaled_gemm_plain(a, bt, torch.float32).abs().max() > 2 ** 31
    for b, layout in ((bt, "nt"), (bt.T.contiguous(), "nn")):
        for args in ((xs, ws, bias, rs, zp, vz0, vz1), ()):
            want = ks.scaled_gemm_plain(a, b, torch.float32, *args,
                                        b_layout=layout)
            for _ in range(2):
                got = ks.scaled_gemm(a, b, torch.float32, *args,
                                     b_layout=layout)
                assert torch.equal(got, want), layout


@pytest.mark.parametrize("m", [(1 << 17) + 96, 1 << 18])
def test_scaled_mm_tn_long_contraction_exact(dev, m):
    """B10 over 2^17 tokens or more, in parts, bit-equal to its plain
    version where columns of -128 and 127 make sums past 2^31, with and
    without the scales; the rank-2 term within ``TN_LOWRANK_TOL``."""
    g = _gen(42)
    n, k = 300, 520
    a = _long_codes((m, n), g, dev, ((0, -128), (1, 127)), 1)
    b = _long_codes((m, k), g, dev, ((0, -128), (1, -128), (k - 1, 127)), 1)
    a_s = torch.rand(n, device=dev, generator=g) * 0.02
    b_s = torch.rand(k, device=dev, generator=g) * 0.02
    before = dict(ks.scaled_mm_tn.mode_launches)
    for sc in ((a_s, b_s), (None, None)):
        want = ks.scaled_mm_tn_plain(a, b, *sc)
        assert want.abs().max() > 2 ** 31 or sc[0] is not None
        for _ in range(2):
            assert torch.equal(ks.scaled_mm_tn(a, b, *sc), want)
    assert ks.scaled_mm_tn.mode_launches["parts"] == before["parts"] + 4
    u = torch.randn(n, 2, device=dev, generator=g)
    v = torch.randn(2, k, device=dev, generator=g)
    got = ks.scaled_mm_tn(a, b, a_s, b_s, lowrank_u=u, lowrank_v=v)
    want = ks.scaled_mm_tn_plain(a, b, a_s, b_s, lowrank_u=u, lowrank_v=v)
    mag = want.abs() + u.abs() @ v.abs()
    assert ((got - want).abs() <= ks.TN_LOWRANK_TOL * mag).all()


@pytest.mark.parametrize("m,k", [(1, 3072), (37, 200), (300, 3072),
                                 (64, 7681)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_given_range(dev, m, k, dtype):
    """B1's uint8 rows against a given range (a row-parallel shard's,
    the all-reduced minima and maxima), bit-equal to the plain version
    through the staged kernel and both loops; against the rows' own range
    they equal the rows' own codes, and a shard's columns against the
    whole rows' range equal the whole rows' codes."""
    g = _gen(32)
    x = _planted_rows(m, k, "uint8", dtype, g)
    rng = (x.float().amin(-1), x.float().amax(-1))
    own = ks.quantize_rows(x, "uint8")
    for pad in (0, 11):
        got = ks.quantize_rows(x, "uint8", k_pad=pad, row_range=rng)
        want = ks.quantize_rows_plain(x, "uint8", k_pad=pad, row_range=rng)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    got = ks.quantize_rows(x, "uint8", row_range=rng)
    for a, b in zip(got, own):
        assert torch.equal(a, b)
    half = k // 2
    part = ks.quantize_rows(x[:, half:].contiguous(), "uint8",
                            row_range=rng)
    assert torch.equal(part[0], own[0][:, half:])
    assert torch.equal(part[2], own[2])


def _dryrun_step_setup(dev, qconfig):
    """The dry run's model quantized by ``qconfig`` on the card and a
    batch of 4 (every quantized-matmul linear at 32 rows or more)."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.models.dit import DiTConfig, init_dit, make_rope_freqs
    from sdnq_tpu_torch.parallel.dryrun import DRYRUN_CONFIG
    cfg = DiTConfig(**DRYRUN_CONFIG)
    g = _gen(33)
    q, _ = T.quantize_model(init_dit(cfg, device=dev, generator=g),
                            T.QuantConfig(**qconfig),
                            arch="FluxTransformer2DModel", device=dev)
    batch = dict(img=torch.randn(4, 16, 8, device=dev, generator=g),
                 txt=torch.randn(4, 8, 64, device=dev, generator=g),
                 timesteps=torch.rand(4, device=dev, generator=g),
                 pooled=torch.randn(4, 32, device=dev, generator=g),
                 target=torch.randn(4, 16, 8, device=dev, generator=g))
    return cfg, q, batch, make_rope_freqs(cfg, 8, (4, 4), device=dev)


@pytest.mark.parametrize("case,limits", [("fsdp", (1e-6, 1e-6)),
                                         ("requant_row", (4e-4, 6.5e-2))])
def test_virtual_rank_training_cases(dev, case, limits):
    """On the card, over virtual ranks (``local_train_step``): the dry
    run's int8 model with its linears fsdp-sharded (fsdp 2), and an int8
    model in groups of 32 whose row-parallel weights are re-quantized for
    the matmul against their whole rows (tensor 2, B1's given scale),
    each against the unsharded step: the loss's relative difference and
    the largest gradient error over its gradient's largest value within
    ``limits`` (as ``tests/test_torch_tp.py``'s gloo cases: fsdp equal,
    the re-quantized rows' codes move at ties)."""
    from sdnq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from sdnq_tpu_torch.models.dit import dit_forward
    from sdnq_tpu_torch.optim import adamw
    from sdnq_tpu_torch.parallel import DIT_TP_RULES, shard_params
    from sdnq_tpu_torch.parallel._collectives import run_virtual
    from sdnq_tpu_torch.parallel.dryrun import local_train_step
    from sdnq_tpu_torch.train import (
        convert_model_to_training, extract_weight_grads,
    )
    from sdnq_tpu_torch.tree import tree_leaves
    qc = dict(weights_dtype="int8", use_quantized_matmul=True,
              dequant_dtype="float32")
    if case == "fsdp":
        shape, rules = {"fsdp": 2}, {k: "fsdp" for k in DIT_TP_RULES}
    else:
        shape, rules = {"tensor": 2}, DIT_TP_RULES
        qc["group_size"] = 32
    cfg, q, batch, freqs = _dryrun_step_setup(dev, qc)
    tp = convert_model_to_training(q)
    out = dit_forward(tp, batch["img"], batch["txt"], batch["timesteps"],
                      batch["pooled"], cfg, freqs=freqs, device=dev)
    loss = torch.nn.functional.mse_loss(out.float(), batch["target"])
    loss.backward()
    want = [g for g in tree_leaves(extract_weight_grads(tp))
            if g is not None]
    trees = run_virtual(lambda m: shard_params(convert_model_to_training(q),
                                               m, rules), shape, "cuda")
    opt = adamw(lr=1e-4)
    states = [opt.init(convert_model_to_training(q)) for _ in trees]
    grads = []
    reset_launch_counts()
    got_loss = local_train_step(trees, opt, states, batch, cfg, shape,
                                freqs=freqs, device=dev, grads_out=grads)
    counts = launch_counts()
    got = [g for g in grads if g is not None]
    assert len(got) == len(want) > 20
    dl = abs(got_loss.item() - loss.item()) / loss.item()
    dg = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
             for a, b in zip(got, want))
    assert dl <= limits[0] and dg <= limits[1], (dl, dg)
    assert counts["scaled_mm_tn"] > 0 and counts["scaled_gemm:nn"] > 0
    if case == "requant_row":
        assert counts["quantize_rows:given_scale"] > 0
