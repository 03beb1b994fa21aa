"""Weight-only and packed-weight quantized matmuls.

Kernels, each beside its plain PyTorch version and a launch counter:

* ``dequant_gemv`` (M <= 32, ``csrc/dequant_gemv.cu``) and ``dequant_mm``
  (any M: ``decode_weight`` then ``wgmma_mm``, below) — B2.  They replace
  ``sdnq_tpu/kernels/dequant_mm.py`` ``_dequant_mm_kernel`` in its
  unpacked modes, on int8, uint8 (with a zero point) and e4m3 codes:

  - rowwise (``row_epi``): rowwise scales commute with the K sum, so

        y = (x @ codesᵀ) * scale[o] + rowsum(x) * zp[o] + bias[o]

    and the codes enter the dot exactly;
  - grouped (scales (O, G), G > 1, as SDNQ's default int8 recipe stores
    every linear: auto groups of 1024): the TPU kernel decodes each weight
    tile into a scratch of x's dtype, so every scaled weight ``code *
    scale + zp`` is ROUNDED TO x's DTYPE (bf16 or fp16 on the card) before
    the product, and the bias is added in fp32.  That rounding point is the
    function; the group-dot algebra of B5 would compute another number.

  - bit-plane (``fmt`` a packed format, B2's packed mode): codes of any
    width in the bit-plane layout, integers or minifloats, decoded in the
    kernel; every scaled weight is rounded to x's dtype, rowwise too.

  The plain version of both is ``dequant_gemv_plain``: the row epilogue in
  fp32, or ``_dequantized_dot`` for grouped scales and bit-plane codes.  At
  M <= 32 the GEMV is bound by the bytes of the weight; above, the GEMM by
  the tensor cores.
* ``groupdot_mm`` — B5.  Replaces ``_groupdot_kernel``: weight-only GEMM on
  half-split packed codes: 1/2/4-bit integers in one field plane, and (its
  general mode, ``fmt``) 3/5/6/7-bit integers in several planes and
  minifloat codes.
* ``decode_weight`` (``csrc/decode_weight.cu``) and ``wgmma_mm``
  (``csrc/wgmma_mm.cu``): the two kernels of B2's tiles, B5 and B7 on the
  card.  Each call decodes the weight once into a W' (x's type, bf16 or
  fp16: scaled and rounded where B2 rounds it, the exact code values for
  B2's row mode and B5; int8: B7's raw codes), and one Hopper GEMM (TMA,
  ``wgmma``)
  multiplies it with the mode's epilogue: the bias, B2's row scales and
  zero point, B5's group fold, or B7's fold of int32 group products.
* ``blockdiag_mm`` — B6, ``csrc/blockdiag_mm.cu``.  Replaces
  ``_blockdiag_kernel``: the same function for a few rows, as a GEMV.
* ``groupdot_i8_mm`` — B7, ``decode_weight`` (int8) then ``wgmma_mm``
  (``fold_i8``).  Replaces ``_groupdot_i8_kernel``: per-row int8
  activations times the raw codes of 1-7-bit integers.
* ``blockdiag_i8_mm`` — B8, ``csrc/blockdiag_i8_mm.cu``.  Replaces
  ``_blockdiag_i8_kernel``: B7's function on 1-7-bit integer codes at any
  group size (down to the 8- and 16-code groups of 1- and 2-bit formats,
  groups that straddle the half-split field boundary included) and at few
  rows: the codes decoded in registers into ``mma.sync`` s8 fragments.

B5, B6 and B7 use the group-dot algebra on half-split codes (``packing``):
the raw codes c (0 .. 2^bits - 1) enter the dot exactly, each group's
partial dot is weighted by its scale, and the zero point together with the
offset-binary minimum of signed formats (``zpc = zp + code_min * scale``)
enters as a rank-G term on the per-row group sums of x:

    y[m, o] = sum_g scale[o, g] * (x_g[m] . c_g[o]) + xsum[m, g] * zpc[o, g]
              (+ bias[o])

B7 and B8 multiply the whole by the row scale of x before the bias.
Minifloat codes enter B5 and B6 as their decoded values (signed), so their
zpc is the zero point alone.  Nothing is rounded below fp32 besides the
inputs, so the plain versions need no rounding points of their own.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.  ``dequant_matmul`` and
``packed_int8_matmul`` route to them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._build import P, I
from .dispatch import is_cuda
from ..packing import (
    decode_float, halfsplit_planes, pad_to_multiple, unpack,
    unpack_codes_halfsplit,
)

__all__ = ["dequant_gemv", "dequant_gemv_plain", "dequant_mm",
           "dequant_mm_plain", "groupdot_mm",
           "groupdot_mm_plain", "blockdiag_mm", "blockdiag_mm_plain",
           "groupdot_i8_mm", "groupdot_i8_mm_plain", "blockdiag_i8_mm",
           "blockdiag_i8_mm_plain", "packed_int8_route_ok", "dequant_matmul",
           "packed_int8_matmul"]

# The GEMV kernel keeps every row's partial sum in registers.
GEMV_MAX_ROWS = 32

# Half-split weight-only products on at most this many rows take the B6
# GEMV (bound by the weight's bytes, x staged in shared memory as fp32);
# more rows take the B5 tensor-core GEMM, whose 128-row tiles would be
# mostly empty below it.
BLOCKDIAG_MAX_ROWS = 8

# code widths whose half-split layout is one field plane: B8, and the
# 1/2/4-bit integer mode of B5 and B6 (their general mode takes the rest)
_KERNEL_BITS = (1, 2, 4)

# From this many rows the quantized matmul on packed codes requantizes the
# weight rowwise instead of calling packed_int8_matmul (the JAX package's
# default SDNQ_TPU_PACKED_MM_MAX_ROWS, kept for the same route).
PACKED_MM_MAX_ROWS = 8192

# Where packed_int8_matmul has a result, at most this many rows take B8
# (the codes decoded in registers into mma.sync fragments, no W' written)
# even where B7 (the decode into int8, then 128-row tensor-core tiles)
# could take the groups; more rows take B7.  On an H100 at uint4 g 64
# (device times by chip_smoke.py's ``b7_b8_crossover``), B8 is the faster
# at 64 rows on each of its four shapes (K 2048 -> 8192, 2048, 512; K 1024
# -> 4096; by 15% or more, the closest 27.8 against 32.9 us at 2048 ->
# 512) and B7 at 128 rows on the widest (48.6 against 65.1 us at 2048 ->
# 8192).  Both compute the same bits.
I8_BLOCKDIAG_MAX_ROWS = 64

# The JAX package's TPU route rule of packed_int8_matmul, kept for parity
# (the int8 route and the rowwise-requantize route give different numbers;
# these numbers follow the TPU, not Hopper): its K cap, the 1024 cap on
# rows x groups of its block-diagonal kernel, and that kernel's resident
# VMEM budget (0.9 of the default 100 MiB limit, 512-column weight blocks).
_MAX_K = 32768
_BLOCKDIAG_MAX_MG = 1024
_BLOCKDIAG_VMEM_BYTES = int(100 * 1024 * 1024 * 0.9)


# ---------------------------------------------------------------------------
# B2: unpacked weight-only products (rowwise and grouped scales)
# ---------------------------------------------------------------------------

# code kinds of csrc/dequant_gemv.cu and csrc/decode_weight.cu
_CODE_KINDS = {torch.int8: 0, torch.uint8: 1, torch.float8_e4m3fn: 2,
               torch.float8_e5m2: 3}
# x's types of the tensor-core tiles (the decode writes W' in x's type)
_TILE_TYPES = (torch.bfloat16, torch.float16)


def _groups(scale) -> int:
    """Groups along K of a (O,), (O, 1) or (O, G) scale."""
    return scale.shape[-1] if scale.dim() == 2 else 1


def dequant_gemv_plain(x, codes, scale, zp, bias, out_dtype, fmt=None):
    """Plain version of ``dequant_gemv`` and ``dequant_mm``.  Rowwise
    (scale (O,) or (O, 1)): in fp32, ``(x @ codesᵀ) * scale [+ rowsum(x) *
    zp] [+ bias]``.  Grouped (scale (O, G), G > 1) and bit-plane codes of
    ``fmt``: ``_dequantized_dot``, the weight rounded to x's dtype before
    the product."""
    groups = _groups(scale)
    if fmt is not None:
        k = x.shape[1]
        vals = unpack(codes, fmt, k, dtype=torch.float32, layout="bitplane")
        return _dequantized_dot(x, vals, scale, zp, bias, k // groups,
                                out_dtype)
    if groups > 1:
        return _dequantized_dot(x, codes.float(), scale, zp, bias,
                                codes.shape[1] // groups, out_dtype)
    xf = x.float()
    out = (xf @ codes.float().T) * scale.reshape(1, -1).float()
    if zp is not None:
        out = out + xf.sum(-1, keepdim=True) * zp.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(out_dtype)


# the tile kernel computes the GEMV's function
dequant_mm_plain = dequant_gemv_plain


def _code_kind(codes, name):
    if codes.dtype not in _CODE_KINDS:
        raise ValueError(f"{name} takes int8 / uint8 / float8_e4m3fn / "
                         f"float8_e5m2 codes, not {codes.dtype}")
    return _CODE_KINDS[codes.dtype]


def _fmt_args(fmt) -> tuple:
    """The arguments of ``sdnq::code_fmt`` (csrc/common.cuh) for a packed
    format: (is_float, code_min, e, m, bias)."""
    if fmt.is_integer:
        return (0, int(fmt.min), 0, 0, 0)
    return (1, 0, fmt.exponent, fmt.mantissa, fmt.bias)


def _bitplane_check(name, x, codes, scale, fmt):
    """(M, K, O, S): the planes of S bytes a row that codes (O, bits*S)
    hold for x (M, K)."""
    m, k = x.shape
    o = codes.shape[0]
    s = pad_to_multiple(k, 8) // 8
    groups = _groups(scale)
    if (codes.dim() != 2 or codes.dtype != torch.uint8
            or codes.shape[1] != fmt.code_bits * s or k % groups
            or scale.shape[0] != o):
        raise ValueError(f"{name}: bit-plane codes {tuple(codes.shape)} "
                         f"{codes.dtype} of {fmt.name} and scale "
                         f"{tuple(scale.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    return m, k, o, s


def _operands(scale, zp, bias):
    """fp32 contiguous (O, G) scale and zero point, (O,) bias."""
    o, groups = scale.shape[0], _groups(scale)
    scale = scale.reshape(o, groups).float().contiguous()
    zp = None if zp is None else zp.reshape(o, groups).float().contiguous()
    bias = None if bias is None else bias.reshape(-1).float().contiguous()
    return scale, zp, bias


def _aligned(t, n: int):
    """``t`` (contiguous) if its data starts on an ``n``-byte boundary, else
    a copy that does (the GEMV's 16-byte x loads and weight copies)."""
    return t if t.data_ptr() % n == 0 else t.clone()


def dequant_gemv(x, codes, scale, zp=None, bias=None,
                 out_dtype=torch.bfloat16, fmt=None):
    """Weight-only GEMV for x (M, K), M <= 32 on the card, fp32 / bf16 /
    fp16; codes (O, K) int8, uint8, e4m3 or e5m2; scale / zp (O,), (O, 1)
    or (O, G) with K / G a multiple of 8; bias (O,).  With ``fmt`` a
    packed format, codes (O, bits * ceil(K/8)) in its bit-plane layout
    (any group dividing K)."""
    if not is_cuda(x):
        return dequant_gemv_plain(x, codes, scale, zp, bias, out_dtype, fmt)
    m, k = x.shape
    o = codes.shape[0]
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(
            f"dequant_gemv takes 1..{GEMV_MAX_ROWS} rows, got {m}")
    if fmt is not None:
        return _bitplane_gemv(x, codes, scale, zp, bias, out_dtype, fmt)
    kind = _code_kind(codes, "dequant_gemv")
    groups = _groups(scale)
    if groups > 1 and (k % groups or (k // groups) % 8):
        raise ValueError(f"dequant_gemv: group {k / groups} of K {k} is not "
                         "a multiple of 8")
    # the kernel streams rows of a multiple of 16 codes: zero codes times
    # zero x add nothing (a grouped pad takes the last group's scale)
    pad = (-k) % 16
    if pad:
        x = F.pad(x, (0, pad))
        codes = F.pad(codes.view(torch.uint8), (0, pad)).view(codes.dtype)
    x, codes = _aligned(x.contiguous(), 16), _aligned(codes.contiguous(), 16)
    scale, zp, bias = _operands(scale, zp, bias)
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    fn = _build.function("dequant_gemv", "sdnq_dequant_gemv",
                         [P] * 6 + [I] * 8 + [P])
    _build.check(fn(*(_build.ptr(t) for t in (x, codes, scale, zp, bias,
                                              out)),
                    m, k + pad, o, groups,
                    k + pad if groups == 1 else k // groups,
                    _build.act_kind(x.dtype), kind,
                    _build.act_kind(out_dtype), _build.stream(x)),
                 "dequant_gemv")
    dequant_gemv.launches += 1
    if groups > 1:
        dequant_gemv.mode_launches["grouped"] += 1
    if kind == _CODE_KINDS[torch.float8_e5m2]:
        dequant_gemv.mode_launches["e5m2"] += 1
    dequant_gemv.mode_launches["fp16"] += x.dtype == torch.float16
    return out


dequant_gemv.launches = 0
dequant_gemv.mode_launches = dict(grouped=0, bitplane=0, e5m2=0, fp16=0)


def _bitplane_gemv(x, codes, scale, zp, bias, out_dtype, fmt):
    m, k, o, s = _bitplane_check("dequant_gemv", x, codes, scale, fmt)
    x, codes = x.contiguous(), codes.contiguous()
    groups = _groups(scale)
    scale, zp, bias = _operands(scale, zp, bias)
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    fn = _build.function("dequant_gemv", "sdnq_dequant_gemv_bitplane",
                         [P] * 6 + [I] * 13 + [P])
    _build.check(fn(*(_build.ptr(t) for t in (x, codes, scale, zp, bias,
                                              out)),
                    m, k, s, o, groups, fmt.code_bits, *_fmt_args(fmt),
                    _build.act_kind(x.dtype), _build.act_kind(out_dtype),
                    _build.stream(x)), "dequant_gemv (bit-plane)")
    dequant_gemv.launches += 1
    dequant_gemv.mode_launches["bitplane"] += 1
    dequant_gemv.mode_launches["fp16"] += x.dtype == torch.float16
    return out


def dequant_mm(x, codes, scale, zp=None, bias=None,
               out_dtype=torch.bfloat16, fmt=None):
    """Weight-only GEMM on tensor-core tiles: x (M, K), bf16 or fp16 on
    the card; codes (O, K) int8, uint8, e4m3 or e5m2; scale / zp (O,) or
    (O, 1) (row mode) or (O, G) (grouped, any group K / G); bias (O,).
    With ``fmt`` a packed format, codes (O, bits * ceil(K/8)) in its
    bit-plane layout.  On the card the weight is decoded once
    (``decode_weight``, in x's type) and multiplied by ``wgmma_mm``."""
    if not is_cuda(x):
        return dequant_mm_plain(x, codes, scale, zp, bias, out_dtype, fmt)
    m, k = x.shape
    o = codes.shape[0]
    if x.dtype not in _TILE_TYPES:
        raise ValueError(f"dequant_mm takes bf16 or fp16 x, not {x.dtype}")
    groups = _groups(scale)
    if fmt is not None:
        _bitplane_check("dequant_mm", x, codes, scale, fmt)
        mode = "bitplane"
    else:
        _code_kind(codes, "dequant_mm")
        if codes.shape[1] != k or k % groups:
            raise ValueError(f"dequant_mm: codes {tuple(codes.shape)} and "
                             f"{groups} groups do not fit x {tuple(x.shape)}")
        mode = "row" if groups == 1 else "grouped"
    if not (m and o):
        return torch.empty((m, o), dtype=out_dtype, device=x.device)
    scale, zp, bias = _operands(scale, zp, bias)
    if mode == "row":   # the codes enter exactly; the scales in the epilogue
        w = decode_weight(codes, k, dtype=x.dtype)
        xsum = None if zp is None else x.sum(-1, dtype=torch.float32)
        out = wgmma_mm(x, w, k, "row", bias, scale.reshape(-1),
                       None if zp is None else zp.reshape(-1), xsum,
                       out_dtype)
    else:
        w = decode_weight(codes, k, scale, zp, fmt,
                          "bitplane" if fmt is not None else "unpacked",
                          dtype=x.dtype)
        out = wgmma_mm(x, w, k, "bias", bias, out_dtype=out_dtype)
    dequant_mm.launches += 1
    dequant_mm.mode_launches[mode] += 1
    if x.dtype == torch.float16:
        dequant_mm.mode_launches["fp16"] += 1
    if codes.dtype == torch.float8_e5m2:
        dequant_mm.mode_launches["e5m2"] += 1
    return out


dequant_mm.launches = 0
dequant_mm.mode_launches = dict(grouped=0, row=0, bitplane=0, fp16=0, e5m2=0)


# ---------------------------------------------------------------------------
# The decode-once design of B2's tiles and B5: decode_weight, then wgmma_mm
# ---------------------------------------------------------------------------

def _padded_k(k: int) -> int:
    """Columns of a decoded weight: K rounded up to 8 (16-byte rows)."""
    return -(-k // 8) * 8


def _scaled(vals, scale, zero_point, g):
    """``vals * scale (+ zero_point)`` groupwise in fp32, the product and
    the sum rounded once (computed in float64, where the product of a code
    and an fp32 scale is exact).  The same lines as the first half of
    ``_dequantized_dot``, which is B2's plain version and is left as it
    is: a change to one is made in both (tests/test_torch_decode_once.py
    holds decode-then-GEMM equal to ``dequant_mm_plain``)."""
    o, kdim = vals.shape
    if zero_point is not None:
        vals = (vals.reshape(o, kdim // g, g).double()
                * scale.reshape(o, -1, 1).double()
                + zero_point.reshape(o, -1, 1).double()).float()
    else:
        vals = vals.reshape(o, kdim // g, g) * scale.reshape(o, -1, 1).float()
    return vals.reshape(o, kdim)


def decode_weight_plain(codes, k, scale=None, zp=None, fmt=None,
                        layout="unpacked", bits=None, dtype=torch.bfloat16):
    """Plain version of ``decode_weight``."""
    if dtype == torch.int8:   # B7: the raw half-split codes, below 2^7
        return unpack_codes_halfsplit(codes, bits or fmt.code_bits,
                                      k).to(torch.int8)
    if layout == "halfsplit":
        vals = _halfsplit_values(codes, bits or fmt.code_bits, k, fmt)
    elif layout == "bitplane":
        vals = unpack(codes, fmt, k, dtype=torch.float32, layout="bitplane")
    else:
        vals = codes.float()
    if scale is not None and layout != "halfsplit":
        vals = _scaled(vals, scale, zp, k // _groups(scale))
    return F.pad(vals.to(dtype), (0, _padded_k(k) - k))


def decode_weight(codes, k, scale=None, zp=None, fmt=None, layout="unpacked",
                  bits=None, dtype=torch.bfloat16):
    """The weight W' (O, K rounded up to 8; the padding columns 0) of a
    weight's codes, in natural k order, for ``wgmma_mm``; ``dtype`` bf16
    or fp16 (x's type), or (B7, ``dtype`` int8) the raw half-split integer
    codes, (O, K):

    * ``unpacked`` (B2): codes (O, K) int8, uint8, e4m3 or e5m2; with
      scale / zp (O, G) each weight ``code * scale (+ zp)`` rounded to
      ``dtype`` (B2's rounding point), without them the code (exact; the
      row mode);
    * ``bitplane`` (B2): codes (O, bits * ceil(K/8)) of ``fmt``, decoded,
      scaled and rounded as above;
    * ``halfsplit`` (B5, B7): codes (O, K * bits / 8) of ``bits`` bits,
      the raw integer code or the minifloat value of ``fmt`` (exact; int8:
      integer codes only)."""
    if not is_cuda(codes):
        return decode_weight_plain(codes, k, scale, zp, fmt, layout, bits,
                                   dtype)
    o = codes.shape[0]
    i8 = dtype == torch.int8
    if i8 and (layout != "halfsplit" or (fmt is not None
                                         and not fmt.is_integer)):
        raise ValueError("decode_weight writes int8 from half-split integer "
                         "codes only")
    if not i8 and dtype not in _TILE_TYPES:
        raise ValueError(f"decode_weight writes bf16, fp16 or int8, not "
                         f"{dtype}")
    kind16 = 0 if i8 else _build.act_kind(dtype)
    out = torch.empty((o, k if i8 else _padded_k(k)), dtype=dtype,
                      device=codes.device)
    codes = codes.contiguous()
    st = _build.stream(codes)
    if layout == "halfsplit":
        bits = bits or fmt.code_bits
        fn = _build.function("decode_weight", "sdnq_decode_halfsplit",
                             [P, P] + [I] * 9 + [P])
        rc = fn(codes.data_ptr(), out.data_ptr(), o, k, bits,
                *_float_args(fmt), int(i8), kind16, st)
        mode = "halfsplit_i8" if i8 else "halfsplit"
    elif layout == "bitplane":
        groups = _groups(scale)
        scale, zp, _ = _operands(scale, zp, None)
        fn = _build.function("decode_weight", "sdnq_decode_bitplane",
                             [P] * 4 + [I] * 11 + [P])
        rc = fn(*(_build.ptr(t) for t in (codes, scale, zp, out)), o, k,
                out.shape[1] // 8, groups, fmt.code_bits, *_fmt_args(fmt),
                kind16, st)
        mode = "bitplane"
    else:
        kind = _code_kind(codes, "decode_weight")
        row = scale is None
        groups = 1 if row else _groups(scale)
        if not row:
            scale, zp, _ = _operands(scale, zp, None)
        fn = _build.function("decode_weight", "sdnq_decode_unpacked",
                             [P] * 4 + [I] * 7 + [P])
        rc = fn(*(_build.ptr(t) for t in (codes.view(torch.uint8),
                                          None if row else scale,
                                          None if row else zp, out)),
                o, k, out.shape[1], groups, kind, int(row), kind16, st)
        mode = "row" if row else "grouped"
    _build.check(rc, f"decode_weight ({mode})")
    decode_weight.launches += 1
    decode_weight.mode_launches[mode] += 1
    return out


decode_weight.launches = 0
decode_weight.mode_launches = dict(grouped=0, row=0, bitplane=0, halfsplit=0,
                                   halfsplit_i8=0)

# epilogues of csrc/wgmma_mm.cu (fold_i8: its int8 kernel)
_EPILOGUES = {"bias": 0, "row": 1, "fold": 2}


def wgmma_mm_plain(x, w, k, epilogue="bias", bias=None, scale=None, zp=None,
                   xsum=None, out_dtype=torch.bfloat16, xs=None):
    """Plain version of ``wgmma_mm``, in fp32 in the kernel's order of
    operations (``fold_i8``: each group's integer product summed in
    float64, exact, as ``groupdot_i8_mm_plain``)."""
    i8 = epilogue == "fold_i8"
    xf = x.double() if i8 else x.float()
    wf = w[:, :k].to(xf.dtype).contiguous()
    if epilogue in ("fold", "fold_i8"):
        g = k // scale.shape[1]
        acc = _groupdot_plain(xf, wf, scale.float(), zp.float(),
                              lambda sl: xsum[:, sl.start // g, None].float())
        if i8:
            acc = acc * xs.reshape(-1, 1).float()
    else:
        acc = xf @ wf.T
        if epilogue == "row":
            acc = acc * scale.reshape(1, -1).float()
            if zp is not None:
                acc = acc + xsum.reshape(-1, 1).float() * zp.reshape(
                    1, -1).float()
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return acc.to(out_dtype)


def wgmma_mm(x, w, k, epilogue="bias", bias=None, scale=None, zp=None,
             xsum=None, out_dtype=torch.bfloat16, xs=None):
    """out (M, O) = x (M, K) @ w[:, :K]ᵀ with x and w both bf16 or both
    fp16 (w (O, >= K), as ``decode_weight`` writes it) and an epilogue in
    fp32:

    * ``bias``: ``+ bias`` (O,) where given;
    * ``row``: ``* scale[o] (+ xsum[m] * zp[o]) (+ bias[o])``, scale / zp
      (O,), xsum (M,) the row sums of x;
    * ``fold``: B5's group-dot algebra, each group's product folded as
      ``acc + part * scale[o, g] + xsum[m, g] * zp[o, g]`` (zp the zpc of
      ``_group_operands``), scale / zp (O, G), xsum (M, G), groups of a
      multiple of 16; then ``+ bias``.  The kernel reads them group-major:
      scale and zp are copied, xsum is read in place where it is the
      transposed view of a (G, M) tensor;
    * ``fold_i8`` (B7): x and w int8, each group's int32 product folded as
      ``fold``'s (groups of a multiple of 64), then ``* xs[m]`` (M,) and
      ``+ bias``.

    fp32, bf16 or fp16 out.  On the card a Hopper wgmma kernel fed by TMA
    (csrc/wgmma_mm.cu)."""
    if not is_cuda(x):
        return wgmma_mm_plain(x, w, k, epilogue, bias, scale, zp, xsum,
                              out_dtype, xs)
    m, o = x.shape[0], w.shape[0]
    kinds = (torch.int8,) if epilogue == "fold_i8" else _TILE_TYPES
    if x.dtype not in kinds or w.dtype != x.dtype:
        raise ValueError(f"wgmma_mm ({epilogue}) takes x and w both of "
                         f"{kinds}, not {x.dtype} and {w.dtype}")
    if x.shape[1] < k or w.shape[1] < k:
        raise ValueError(f"wgmma_mm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not hold K {k}")
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    if not (m and o):
        return out
    x, w = _build.tma_rows(x, k), _build.tma_rows(w, k)

    def f32(t):
        return None if t is None else t.float().contiguous()
    g = 0
    if epilogue in ("fold", "fold_i8"):   # read group-major: (G, O), (G, M)
        if scale is None or zp is None or xsum is None:
            raise ValueError("wgmma_mm: the fold takes scale, zp and xsum")
        g = k // scale.shape[1]
        scale, zp = torch.stack((scale.float().t(), zp.float().t()))
        xsum = xsum.float().t().contiguous()   # a view of (G, M): no copy
    else:
        scale, zp, xsum = (f32(None if t is None else t.reshape(-1))
                           for t in (scale, zp, xsum))
    bias = f32(None if bias is None else bias.reshape(-1))
    if epilogue == "fold_i8":
        if xs is None:
            raise ValueError("wgmma_mm: fold_i8 takes the row scales xs")
        fn = _build.function("wgmma_mm", "sdnq_wgmma_i8_mm",
                             [P, I, P, I, P] + [I] * 3 + [P] * 5 + [I] * 2
                             + [P])
        rc = fn(x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
                out.data_ptr(), m, o, k,
                *(_build.ptr(t) for t in (bias, scale, zp, xsum,
                                          f32(xs.reshape(-1)))),
                g, _build.act_kind(out_dtype), _build.stream(x))
    else:
        fn = _build.function("wgmma_mm", "sdnq_wgmma_mm",
                             [P, I, P, I, P] + [I] * 4 + [P] * 4
                             + [I, I, I, P])
        rc = fn(x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
                out.data_ptr(), m, o, k, _EPILOGUES[epilogue],
                *(_build.ptr(t) for t in (bias, scale, zp, xsum)), g,
                _build.act_kind(x.dtype), _build.act_kind(out_dtype),
                _build.stream(x))
    _build.check(rc, f"wgmma_mm ({epilogue})")
    wgmma_mm.launches += 1
    wgmma_mm.mode_launches[epilogue] += 1
    return out


wgmma_mm.launches = 0
wgmma_mm.mode_launches = dict(bias=0, row=0, fold=0, fold_i8=0)


# ---------------------------------------------------------------------------
# B5 / B6 / B7: group-dot products on half-split codes
# ---------------------------------------------------------------------------

def _group_operands(scale, zero_point, fmt):
    """(O, G) fp32 scale and zpc = zero point + code_min * scale (integer
    codes), or the zero point alone (minifloat values; zeros without
    one)."""
    scale = scale.reshape(scale.shape[0], -1).float().contiguous()
    zpc = (float(fmt.min) * scale if fmt.is_integer
           else torch.zeros_like(scale))
    if zero_point is not None:
        zpc = zpc + zero_point.reshape(scale.shape).float()
    return scale, zpc.contiguous()


def _halfsplit_values(codes, bits, k, fmt):
    """(O, K) fp32 half-split codes: raw integer codes, or the decoded
    values of a minifloat ``fmt``."""
    c = unpack_codes_halfsplit(codes, bits, k)
    if fmt is not None and not fmt.is_integer:
        return decode_float(c, fmt)
    return c.float()


def _groupdot_plain(xf, cf, scale, zpc, xsum_of):
    """sum_g (x_g @ c_gᵀ) * scale[:, g] + xsum_g * zpc[:, g], group by
    group in fp32, in the kernels' order of operations."""
    m, k = xf.shape
    groups = scale.shape[1]
    g = k // groups
    acc = torch.zeros((m, cf.shape[0]), dtype=torch.float32,
                      device=xf.device)
    for gi in range(groups):
        sl = slice(gi * g, (gi + 1) * g)
        part = (xf[:, sl] @ cf[:, sl].T).float()
        acc = acc + part * scale[:, gi]
        acc = acc + xsum_of(sl) * zpc[:, gi]
    return acc


def groupdot_mm_plain(x, codes, scale, zpc, bias=None, bits: int = 4,
                      out_dtype=torch.bfloat16, fmt=None):
    """Plain version of ``groupdot_mm`` (and ``blockdiag_mm``): the
    group-dot product in fp32."""
    xf = x.float()
    cf = _halfsplit_values(codes, bits, x.shape[1], fmt)
    acc = _groupdot_plain(xf, cf, scale.float(), zpc.float(),
                          lambda sl: xf[:, sl].sum(-1, keepdim=True))
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return acc.to(out_dtype)


# B6 computes the same function as B5 (its kernel sums in another order).
blockdiag_mm_plain = groupdot_mm_plain


def groupdot_i8_mm_plain(xq, xs, codes, scale, zpc, bias=None, bits: int = 4,
                         out_dtype=torch.bfloat16):
    """Plain version of ``groupdot_i8_mm``.  Each group's int32 partial is
    summed in float64, exact for any group size (in fp32 it would stay
    exact only up to g of about 8800: 127 * 15 * g < 2^24), so the plain
    version equals the kernel's integer sums and fp32 epilogue bit for
    bit."""
    xd = xq.double()
    cd = unpack_codes_halfsplit(codes, bits, xq.shape[1]).double()
    acc = _groupdot_plain(
        xd, cd, scale.float(), zpc.float(),
        lambda sl: xq[:, sl].to(torch.int32).sum(-1, keepdim=True).float())
    acc = acc * xs.reshape(-1, 1).float()
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return acc.to(out_dtype)


# B8 computes B7's function (its kernel takes any group size).
blockdiag_i8_mm_plain = groupdot_i8_mm_plain


def _general(bits, fmt) -> bool:
    """True where B5 / B6 take their general mode: codes in more than one
    field plane, or minifloat codes."""
    return bits not in _KERNEL_BITS or (fmt is not None
                                        and not fmt.is_integer)


def _check_general(name, x, codes, scale, zpc, bits, align):
    """Shapes and group geometry of the general mode: ``align`` divides
    the group and the narrowest plane's segment K / pmax."""
    if not 1 <= bits <= 7:
        raise ValueError(f"{name}: half-split codes are 1..7 bits, not "
                         f"{bits}")
    m, k = x.shape
    o = codes.shape[0]
    groups = scale.shape[-1]
    pmax = max(8 // w for w, _ in halfsplit_planes(bits))
    if (x.dim() != 2 or codes.dim() != 2 or codes.dtype != torch.uint8
            or k % pmax or codes.shape[1] != k * bits // 8
            or tuple(scale.shape) != (o, groups)
            or tuple(zpc.shape) != (o, groups) or k % groups):
        raise ValueError(f"{name}: codes {tuple(codes.shape)} "
                         f"{codes.dtype}, scale {tuple(scale.shape)}, zpc "
                         f"{tuple(zpc.shape)} do not fit x {tuple(x.shape)}")
    g = k // groups
    if g % align or (k // pmax) % align:
        raise ValueError(f"{name}: group {g} and plane segment {k // pmax} "
                         f"of {bits}-bit codes must be multiples of {align}")
    return m, k, o, g


def _check_halfsplit(name, x, codes, scale, zpc, bits, g_align):
    """Shapes, types and group geometry the 1/2/4-bit kernels take."""
    if bits not in _KERNEL_BITS:
        raise NotImplementedError(
            f"{name}: {bits}-bit codes (multi-plane half-split) are a later "
            "slice of the port; this kernel takes 1, 2 and 4 bits")
    if x.dim() != 2 or codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"{name}: x (M, K) and uint8 codes (O, K*bits/8), "
                         f"got {tuple(x.shape)} and {codes.dtype} "
                         f"{tuple(codes.shape)}")
    m, k = x.shape
    o = codes.shape[0]
    seg = k * bits // 8   # bytes per row = K / (codes per byte)
    groups = scale.shape[-1]
    if codes.shape[1] != seg or tuple(scale.shape) != (o, groups) \
            or tuple(zpc.shape) != (o, groups) or k % groups:
        raise ValueError(f"{name}: codes {tuple(codes.shape)}, scale "
                         f"{tuple(scale.shape)}, zpc {tuple(zpc.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    g = k // groups
    # A group must lie inside one field segment of the half-split row
    # (byte b carries k = b + t*seg), and a kernel step must not straddle
    # two groups.  (g_align None: any group, B8.)
    if g_align is not None and (seg % g or g % g_align):
        raise ValueError(f"{name}: group {g} must divide the field segment "
                         f"{seg} and be a multiple of {g_align}")
    return m, k, o, g


def groupdot_mm(x, codes, scale, zpc, bias=None, bits: int = 4,
                out_dtype=torch.bfloat16, fmt=None):
    """Weight-only group-dot GEMM: x (M, K) bf16 or fp16 on the card;
    codes (O, K*bits/8) half-split uint8 of ``fmt`` (None: integer codes of
    ``bits`` bits); scale, zpc (O, G) fp32; bias (O,) or None.  1/2/4-bit
    integers: 32 divides g and g divides the field segment K*bits/8; the
    general mode (other widths, minifloats): 32 divides g and K / pmax.
    On the card the codes are decoded once (``decode_weight`` in x's type:
    raw codes or minifloat values, exact in bf16 and, but for the two
    largest values of 5-exponent-bit minifloats, in fp16) and ``wgmma_mm``
    folds each group's product with its scale and zero-point term."""
    if not is_cuda(x):
        return groupdot_mm_plain(x, codes, scale, zpc, bias, bits, out_dtype,
                                 fmt)
    if x.dtype not in _TILE_TYPES:
        raise ValueError(f"groupdot_mm takes bf16 or fp16 x, not {x.dtype}")
    general = _general(bits, fmt)
    check = _check_general if general else _check_halfsplit
    m, k, o, g = check("groupdot_mm", x, codes, scale, zpc, bits, 32)
    if not (m and o):
        return torch.empty((m, o), dtype=out_dtype, device=x.device)
    # the row sums of each group, summed group-major into (G, M)
    xsum = torch.empty((k // g, m), dtype=torch.float32, device=x.device)
    torch.sum(x.reshape(m, k // g, g).transpose(0, 1), -1,
              dtype=torch.float32, out=xsum)
    w = decode_weight(codes, k, fmt=fmt, layout="halfsplit", bits=bits,
                      dtype=x.dtype)
    out = wgmma_mm(x, w, k, "fold", bias, scale, zpc, xsum.t(), out_dtype)
    groupdot_mm.launches += 1
    if general:
        groupdot_mm.mode_launches[_general_mode(fmt)] += 1
    if x.dtype == torch.float16:
        groupdot_mm.mode_launches["fp16"] += 1
    return out


groupdot_mm.launches = 0
groupdot_mm.mode_launches = dict(multiplane=0, minifloat=0, fp16=0)


def _general_mode(fmt) -> str:
    return ("minifloat" if fmt is not None and not fmt.is_integer
            else "multiplane")


def _float_args(fmt) -> tuple:
    """(is_float, e, m, bias) of the general modes' entries."""
    a = _fmt_args(fmt) if fmt is not None else (0, 0, 0, 0, 0)
    return (a[0],) + a[2:]


def blockdiag_mm(x, codes, scale, zpc, bias=None, bits: int = 4,
                 out_dtype=torch.bfloat16, fmt=None):
    """Weight-only group-dot GEMV for x (M, K), M <= BLOCKDIAG_MAX_ROWS on
    the card, fp32 / bf16 / fp16; the other operands as ``groupdot_mm``
    (8 in place of 32 in its geometry rules; the general mode's output is
    fp32 or bf16).  One kernel takes every mode: the codes of 1 to 7 bits
    in their field planes, integers raw and minifloats through the table
    of their values (``minifloat_table``)."""
    if not is_cuda(x):
        return blockdiag_mm_plain(x, codes, scale, zpc, bias, bits,
                                  out_dtype, fmt)
    if not 1 <= x.shape[0] <= BLOCKDIAG_MAX_ROWS:
        raise ValueError(f"blockdiag_mm takes 1..{BLOCKDIAG_MAX_ROWS} rows, "
                         f"got {x.shape[0]}")
    general = _general(bits, fmt)
    if general:
        m, k, o, g = _check_general("blockdiag_mm", x, codes, scale, zpc,
                                    bits, 8)
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("blockdiag_mm's general mode gives fp32 / bf16, "
                             f"not {out_dtype}")
    else:
        m, k, o, g = _check_halfsplit("blockdiag_mm", x, codes, scale, zpc,
                                      bits, 8)
    x, codes, scale, zpc, bias = blockdiag_operands(x, codes, scale, zpc,
                                                    bias)
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    ptrs = [_build.ptr(t) for t in (x, codes, scale, zpc, bias)]
    st = _build.stream(x)
    if general:
        table = (minifloat_table(fmt, x.device)
                 if fmt is not None and not fmt.is_integer else None)
        fn = _build.function("blockdiag_mm", "sdnq_blockdiag_mm_gen",
                             [P] * 7 + [I] * 7 + [P])
        _build.check(fn(*ptrs, _build.ptr(table), out.data_ptr(), m, k, o, g,
                        bits, _build.act_kind(x.dtype),
                        _build.act_kind(out_dtype), st),
                     "blockdiag_mm (general mode)")
        blockdiag_mm.mode_launches[_general_mode(fmt)] += 1
    else:
        fn = _build.function("blockdiag_mm", "sdnq_blockdiag_mm",
                             [P] * 6 + [I] * 7 + [P])
        _build.check(fn(*ptrs, out.data_ptr(), m, k, o, g, bits,
                        _build.act_kind(x.dtype), _build.act_kind(out_dtype),
                        st), "blockdiag_mm")
    blockdiag_mm.launches += 1
    return out


blockdiag_mm.launches = 0
blockdiag_mm.mode_launches = dict(multiplane=0, minifloat=0)


def _f32(t):
    """``t`` as a contiguous fp32 tensor: itself where it already is one
    (no call that makes a new tensor object), else a copy."""
    if t is None or (t.dtype == torch.float32 and t.is_contiguous()):
        return t
    return t.float().contiguous()


def blockdiag_operands(x, codes, scale, zpc, bias):
    """B6's operands as its kernel reads them: x fp32 or bf16 (another
    float type as fp32), contiguous, from a 16-byte boundary; the codes
    contiguous from an 8-byte boundary; scale, zpc and bias fp32 and
    contiguous (bias (O,)).  A tensor that already is so comes back as
    itself; only the others are copied."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() % 16:   # a view off a 16-byte boundary: a fresh copy
        x = x.clone()
    if not codes.is_contiguous():
        codes = codes.contiguous()
    if codes.data_ptr() % 8:
        codes = codes.clone()
    if bias is not None and bias.dim() != 1:
        bias = bias.reshape(-1)
    return x, codes, _f32(scale), _f32(zpc), _f32(bias)


_TABLES: dict = {}


def minifloat_table(fmt, device=None):
    """The 2^bits fp32 values of a minifloat format's codes 0 .. 2^bits - 1
    (``packing.decode_float``), on ``device``, made once: B6's kernel
    decodes its minifloat codes through this table in shared memory."""
    key = (fmt.name, str(device))
    t = _TABLES.get(key)
    if t is None:
        codes = torch.arange(1 << fmt.code_bits, dtype=torch.int32)
        t = decode_float(codes, fmt).float().contiguous().to(device)
        _TABLES[key] = t
    return t


def groupdot_i8_mm(xq, xs, codes, scale, zpc, bias=None, bits: int = 4,
                   out_dtype=torch.bfloat16):
    """int8 rows times raw half-split codes: xq (M, K) int8 with row scales
    xs (M, 1); codes (O, K*bits/8) half-split uint8 of 1-7-bit integers;
    scale, zpc (O, G) fp32; bias (O,) or None.  64 divides the group and
    the narrowest plane's segment.  On the card the codes are decoded once
    into int8 (``decode_weight``) and ``wgmma_mm`` folds each group's
    int32 product with its scale and zero-point term."""
    if not is_cuda(xq):
        return groupdot_i8_mm_plain(xq, xs, codes, scale, zpc, bias, bits,
                                    out_dtype)
    m, k, o, g = _check_general("groupdot_i8_mm", xq, codes, scale, zpc,
                                bits, 64)
    if xq.dtype != torch.int8:
        raise ValueError(f"groupdot_i8_mm takes int8 x codes, not "
                         f"{xq.dtype}")
    if not (m and o):
        return torch.empty((m, o), dtype=out_dtype, device=xq.device)
    # per-row group sums of the codes, group-major (G, M): integers below
    # 2^24, exact in fp32 in any order
    xsum = torch.empty((k // g, m), dtype=torch.float32, device=xq.device)
    torch.sum(xq.reshape(m, k // g, g).transpose(0, 1), -1,
              dtype=torch.float32, out=xsum)
    w = decode_weight(codes, k, layout="halfsplit", bits=bits,
                      dtype=torch.int8)
    out = wgmma_mm(xq, w, k, "fold_i8", bias, scale, zpc, xsum.t(),
                   out_dtype, xs=xs)
    groupdot_i8_mm.launches += 1
    if bits not in _KERNEL_BITS:
        groupdot_i8_mm.mode_launches["multiplane"] += 1
    return out


groupdot_i8_mm.launches = 0
groupdot_i8_mm.mode_launches = dict(multiplane=0)


def blockdiag_i8_mm(xq, xs, codes, scale, zpc, bias=None, bits: int = 4,
                    out_dtype=torch.bfloat16):
    """B7's function at any group size g dividing K: xq (M, K) int8 with
    row scales xs (M, 1); codes (O, K*bits/8) half-split uint8 of 1-7-bit
    integers whose narrowest field plane's segment K / pmax is a multiple
    of 64; scale, zpc (O, K/g) fp32."""
    if not is_cuda(xq):
        return blockdiag_i8_mm_plain(xq, xs, codes, scale, zpc, bias, bits,
                                     out_dtype)
    m, k, o, g = _check_general("blockdiag_i8_mm", xq, codes, scale, zpc,
                                bits, 1)
    pmax = max(8 // w for w, _ in halfsplit_planes(bits))
    if xq.dtype != torch.int8 or (k // pmax) % 64:
        raise ValueError(f"blockdiag_i8_mm takes int8 x codes and a field "
                         f"segment K / {pmax} that is a multiple of 64, got "
                         f"{xq.dtype}, K {k}")
    out = torch.empty((m, o), dtype=out_dtype, device=xq.device)
    if not (m and o):
        return out
    # the kernel reads rows at their dense strides (K, K * bits / 8) from
    # 16-byte boundaries
    xq, codes = (_build.tma_rows(t.contiguous()) for t in (xq, codes))
    scale, zpc = (t.float().contiguous() for t in (scale, zpc))
    # per-row group sums of the codes, group-major (G, M): integers below
    # 2^24, exact in fp32 in any order
    xsum = torch.empty((k // g, m), dtype=torch.float32, device=xq.device)
    torch.sum(xq.reshape(m, k // g, g).transpose(0, 1), -1,
              dtype=torch.float32, out=xsum)
    xs = xs.reshape(-1).float().contiguous()
    bias = None if bias is None else bias.reshape(-1).float().contiguous()
    fn = _build.function("blockdiag_i8_mm", "sdnq_blockdiag_i8_mm",
                         [P] * 8 + [I] * 6 + [P])
    _build.check(fn(*(_build.ptr(t) for t in (xq, codes, scale, zpc, xsum,
                                              xs, bias, out)),
                    m, k, o, g, bits, _build.act_kind(out_dtype),
                    _build.stream(xq)), "blockdiag_i8_mm")
    blockdiag_i8_mm.launches += 1
    return out


blockdiag_i8_mm.launches = 0


# ---------------------------------------------------------------------------
# Routing (the JAX package's entry points)
# ---------------------------------------------------------------------------

def _packed_dequant_matmul(x, wq, scale, zero_point, bias, fmt, out_dtype,
                           pack_layout):
    m = x.shape[0]
    if pack_layout == "halfsplit":
        s, zpc = _group_operands(scale, zero_point, fmt)
        if m <= BLOCKDIAG_MAX_ROWS:
            return blockdiag_mm(x, wq, s, zpc, bias, fmt.code_bits,
                                out_dtype, fmt)
        return groupdot_mm(_tile_x(x), wq, s, zpc, bias, fmt.code_bits,
                           out_dtype, fmt)
    if m <= GEMV_MAX_ROWS:
        return dequant_gemv(x, wq, scale, zero_point, bias, out_dtype, fmt)
    return dequant_mm(_tile_x(x), wq, scale, zero_point, bias, out_dtype,
                      fmt)


def _tile_x(x):
    """x as the tensor-core tiles take it: fp32 cast to bf16 on the card,
    as the JAX wrapper casts fp32 x on the chip; bf16 and fp16 as they
    are (an fp16 x multiplies weights rounded to fp16)."""
    if is_cuda(x) and x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    return x


def _dequantized_dot(x, vals, scale, zero_point, bias, g, out_dtype):
    """Scale the (O, K) values groupwise, round the weight to x's dtype,
    one product in fp32 (the JAX package's XLA route, and the function of
    its grouped kernel mode).  ``vals * scale + zero_point`` is rounded to
    fp32 once, as XLA fuses it into one multiply-add (computed here in
    float64, where the product of a code and an fp32 scale is exact).
    Plain torch: the CPU's route, and the plain version of B2's grouped
    mode."""
    o, kdim = vals.shape
    if zero_point is not None:
        vals = (vals.reshape(o, kdim // g, g).double()
                * scale.reshape(o, -1, 1).double()
                + zero_point.reshape(o, -1, 1).double()).float()
    else:
        vals = vals.reshape(o, kdim // g, g) * scale.reshape(o, -1, 1).float()
    w = vals.reshape(o, kdim).to(x.dtype)
    out = x.float() @ w.float().T
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def dequant_matmul(x, wq, scale, zero_point, bias, fmt, group_size: int,
                   out_dtype=torch.bfloat16, pack_layout: str = "bitplane"):
    """y = x @ dequant(wq).T + bias, weight-only.

    x (M, K) float; wq (O, K) int8 / uint8 / e4m3 codes, or packed uint8
    in ``pack_layout``; scale / zero_point (O, G) groupwise along K;
    ``group_size`` the K span of one group.  Unpacked codes take B2 at any
    M, rowwise or grouped: the GEMV (``dequant_gemv``) on up to
    GEMV_MAX_ROWS rows (grouped: where the group is a multiple of 8), the
    tensor-core tiles (``dequant_mm``) otherwise, an fp32 x cast to bf16
    there on the card as the JAX wrapper casts it on the chip (bf16 and
    fp16 x as they are).  Bit-plane codes
    take B2's packed mode, the GEMV or the tiles by the same row rule.
    Half-split codes (integers or minifloats) take B6 on up to
    BLOCKDIAG_MAX_ROWS rows and B5 above."""
    m, kdim = x.shape
    if fmt.is_packed:
        return _packed_dequant_matmul(x, wq, scale, zero_point, bias, fmt,
                                      out_dtype, pack_layout)
    groups = scale.shape[-1]
    if m <= GEMV_MAX_ROWS and (groups == 1 or (kdim // groups) % 8 == 0):
        return dequant_gemv(x, wq, scale, zero_point, bias, out_dtype)
    return dequant_mm(_tile_x(x), wq, scale, zero_point, bias, out_dtype)


def _blockdiag_resident_ok(mg: int, kdim: int, bits: int,
                           bn: int = 512) -> bool:
    """The JAX block-diagonal kernel's resident bytes (its expanded x, a
    decode scratch and a weight block, an R matrix and slack) within
    _BLOCKDIAG_VMEM_BYTES: a TPU rule, kept for parity."""
    resident = (mg * kdim + bn * kdim + bn * kdim * bits // 8
                + mg * mg * 4 + 2 * mg * kdim)
    return resident <= _BLOCKDIAG_VMEM_BYTES


def packed_int8_route_ok(m: int, kdim: int, g: int, fmt,
                         pack_layout: str) -> bool:
    """True exactly where the JAX package's ``packed_int8_matmul`` has a
    result (its group-dot or its block-diagonal kernel) and False where it
    returns None: not half-split, not a packed integer format or K not a
    multiple of g; a field segment not a multiple of 128 (the TPU's lanes)
    or K > 32768; or groups that its group-dot kernel cannot tile (g a
    multiple of 128 that fits a segment, at most 64 groups) while rows x
    groups exceed 1024 or its block-diagonal kernel's VMEM budget."""
    if not (pack_layout == "halfsplit" and fmt.is_integer and fmt.is_packed
            and g > 0 and kdim % g == 0):
        return False
    pmax = max(8 // w for w, _ in halfsplit_planes(fmt.code_bits))
    seg = kdim // pmax
    if not (seg % 128 == 0 and kdim <= _MAX_K):
        return False
    groups = kdim // g
    if g % 128 == 0 and g <= seg and groups <= 64:
        return True
    return (m * groups <= _BLOCKDIAG_MAX_MG
            and _blockdiag_resident_ok(m * groups, kdim, fmt.code_bits))


def packed_int8_matmul(x, wq, scale, zero_point, bias, fmt, group_size: int,
                       out_dtype=torch.bfloat16,
                       pack_layout: str = "bitplane"):
    """Quantized matmul on packed integer codes: x quantizes per row to
    int8 (B1's ``quantize_rows``), the raw codes enter an int8 product and
    the group scales weight each group's partial.

    Returns None exactly where the JAX package's does
    (``packed_int8_route_ok``), and the caller then requantizes the weight
    rowwise.  Elsewhere B7 and B8 compute the same function; B8 takes up
    to I8_BLOCKDIAG_MAX_ROWS rows and every group B7 cannot (B7 needs a
    multiple of 64 that divides the field segment)."""
    from .scaled_mm import quantize_rows
    m, kdim = x.shape
    g = group_size if group_size > 0 else kdim
    if not packed_int8_route_ok(m, kdim, g, fmt, pack_layout):
        return None
    xq, xs = quantize_rows(x.float())[:2]
    s, zpc = _group_operands(scale, zero_point, fmt)
    seg = kdim * fmt.code_bits // 8
    if m > I8_BLOCKDIAG_MAX_ROWS and g % 64 == 0 and seg % g == 0:
        return groupdot_i8_mm(xq, xs, wq, s, zpc, bias, fmt.code_bits,
                              out_dtype)
    return blockdiag_i8_mm(xq, xs, wq, s, zpc, bias, fmt.code_bits,
                           out_dtype)
