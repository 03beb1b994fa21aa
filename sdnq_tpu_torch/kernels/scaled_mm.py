"""Scaled matmuls: B1 (activation-quantizing GEMM), B4 (scaled GEMM) and
B10 (the grad-weight GEMM).

``out = (x_q · w_qᵀ) * x_scale * w_scale + bias [+ rank-1 zero-point terms]
[+ u @ v]`` with x_q (M, K) and w_q (O, K) both K-contiguous ("nt"), or
w_q (K, O) contracting its leading axis ("nn", the grad-input
orientation); and ``aᵀ·b * a_s * b_s`` contracting the leading (token) axis
of a (M, N) and b (M, K) for the grad-weight.

Kernels, each beside its plain PyTorch version and a launch counter:

* ``quantize_rows`` — B1's quantize half, ``csrc/quantize_rows.cu``.
  Replaces the prologue of ``sdnq_tpu/kernels/scaled_mm.py``
  ``_fused_act_mm_kernel``.  The TPU kernel quantizes each row block of x
  inside the GEMM because the full-K block fits VMEM; on Hopper it cannot
  (227 KB of shared memory against 1.9 MB for 64 bf16 rows at K = 15360), so
  the quantize is a separate memory-bound pass: read x once (rows staged
  in shared memory by TMA bulk copies), write int8 (or e4m3) codes and
  one scale per row.
  Its ``colscale`` mode multiplies each column by an fp32 scale first (the
  prologue's ``x_colscale``).
* ``scaled_gemm`` — B4, and B1's GEMM half, ``csrc/scaled_mm.cu``.  Replaces
  ``_mm_kernel`` and the GEMM of ``_fused_act_mm_kernel``: int8 (int32
  accumulate), fp8 e4m3 or bf16 (fp32 accumulate), bound by tensor-core
  operations at the FLUX shapes, with the scale/bias/zero-point epilogue
  fused so the accumulator never reaches device memory.  Its "nt" mode (the
  forward) is a persistent TMA + ``wgmma`` GEMM that reads both operands
  where they lie (``_build.tma_rows``: rows of a multiple of 16 bytes, a
  misaligned or strided view copied); its "nn" mode (B1's grad-input) is
  the same GEMM reading B (K, N) as it lies, each int8 stage of B
  transposed in shared memory for the s8 ``wgmma`` (e4m3: converted to
  fp16 and read MN-major), the contraction split where ``nn_plan`` says
  (its partial sums added in the kernel, bit-equal for int8).  An int8
  contraction of 2^17 rows or more, past what an int32 sum holds exactly,
  splits every tile into parts of fewer (``long_parts``), whose int32 sums
  the tile's last part adds in int64 before one rounding to fp32, so the
  result stays the plain version's bit for bit at any K.
* ``scaled_mm_tn`` — B10, ``csrc/scaled_mm_tn.cu``.  Replaces
  ``_tn_mm_kernel``: int8 (int32 accumulate) or e4m3 (fp32 accumulate), a
  persistent TMA + ``wgmma`` GEMM that reads both operands in their natural
  layout and rewrites each stage in shared memory (int8: transposed for
  the s8 ``wgmma``; e4m3: converted to fp16), the columnwise scales and
  the rank-R term in the epilogue, fp32 out (``tn_plan`` picks its tokens
  a stage and walk order; ``_build.tma_rows`` copies what TMA cannot read;
  past 2^17 int8 tokens each tile is summed in ``long_parts`` parts added
  in int64, as B4's).  The
  JAX package sends the grad-weight GEMM to its kernel only under
  ``SDNQ_TPU_TN_MM_BLOCKS`` (a v5e speed choice); its XLA route computes
  the same int32 sum with the same epilogue order, so the port sends every
  grad-weight GEMM on the card to B10 and no number changes.

``scaled_mm_fused_act`` = ``quantize_rows`` then ``scaled_gemm``: two
launches per linear.  With ``emit_quantized`` it also returns the row
codes and scales that ``quantize_rows`` wrote (the training residual).  On a CUDA tensor the wrappers launch their kernel or
raise; on a CPU tensor they run the plain version.  The plain int8 GEMM
accumulates in float64, which is exact for |acc| < 2^53 (int8 products over
K = 15360 stay below 2^28), so it equals the kernel's int32 sum; its fp32
products need ``torch.backends.cuda.matmul.allow_tf32 = False`` on the card
(the default), which ``chip_smoke.py`` sets.  Its int8 sums are taken in
float64 over chunks of the contraction, each exact, so that a long one
needs no float64 copy of a whole operand.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._build import P, I
from .dispatch import is_cuda
from ..formats import get_format
from ..quant.core import (
    SCALE_EPS, _div, get_scale_symmetric, quantize_fp_mm, quantize_int_mm,
    quantize_uint_mm,
)

__all__ = ["quantize_rows", "quantize_rows_plain", "row_scale_from_amax",
           "quantize_with_scale", "uint8_scale_from_range",
           "quantize_with_range", "scaled_gemm",
           "scaled_gemm_plain", "scaled_mm", "scaled_mm_fused_act",
           "bf16_scaled_mm", "scaled_mm_tn", "scaled_mm_tn_plain",
           "dynamic_mm_tn", "nn_plan", "long_parts"]


# ---------------------------------------------------------------------------
# B1, quantize half
# ---------------------------------------------------------------------------

# activation formats of the row quantize: (code dtype, kernel mode)
_ROW_FORMATS = {"int8": (torch.int8, 0), "uint8": (torch.int8, 1),
                "float8_e4m3fn": (torch.float8_e4m3fn, 2)}


def quantize_rows_plain(x: torch.Tensor, x_fmt: str = "int8",
                        k_pad: int = 0, colscale=None, row_scale=None,
                        row_range=None):
    """Plain version of ``quantize_rows``: x times ``colscale`` (K,) in
    fp32 where given, then ``quant.core.quantize_int_mm`` /
    ``quantize_uint_mm`` / ``quantize_fp_mm`` per row (against
    ``row_scale``, or uint8's ``row_range``, where given), then ``k_pad``
    zero columns."""
    zp = rs = None
    if colscale is not None:
        x = x.float() * colscale.reshape(1, -1).float()
    _given_fmt(x_fmt, row_scale, row_range)
    if row_range is not None:
        s, zp = uint8_scale_from_range(*(v.reshape(-1, 1).float()
                                         for v in row_range))
        q = quantize_with_range(x, s, zp)
        rs = q.to(torch.int32).sum(-1, keepdim=True).float() * s
    elif row_scale is not None:
        q = quantize_with_scale(x, row_scale.reshape(-1, 1), x_fmt)
        s = row_scale.reshape(-1, 1).float()
    elif x_fmt == "uint8":
        q, s, zp = quantize_uint_mm(x, -1)
        rs = q.to(torch.int32).sum(-1, keepdim=True).float() * s
    elif x_fmt == "int8":
        q, s = quantize_int_mm(x, -1)
    else:
        q, s = quantize_fp_mm(x, -1, fmt=x_fmt)
    if k_pad:   # zero bytes are zero values of int8 and e4m3 both
        q = F.pad(q.view(torch.uint8), (0, k_pad)).view(q.dtype)
    return q, s, zp, rs


def _given_scale_fmt(x_fmt):
    if x_fmt == "uint8":
        raise ValueError("a given row scale takes int8 or float8_e4m3fn "
                         "rows (uint8 rows take a given row_range)")


def _given_fmt(x_fmt, row_scale, row_range):
    if row_scale is not None:
        _given_scale_fmt(x_fmt)
    if row_range is not None and (x_fmt != "uint8" or row_scale is not None):
        raise ValueError("a given row_range takes uint8 rows alone")


def uint8_scale_from_range(vmin, vmax):
    """The (scale, zero point) of asymmetric uint8 values whose range is
    [vmin, vmax] (signed codes, x = q*scale + zp), as
    ``quant.core.get_scale_asymmetric`` and the kernel compute them:
    ``max((vmax - vmin) / 255, 2^-126)`` (a true division) and ``vmin +
    128 scale``."""
    f = get_format("int8")
    scale = torch.clamp_min(_div(vmax.float() - vmin.float(), f.max - f.min),
                            SCALE_EPS)
    return scale, vmin.float() - scale * f.min


def quantize_with_range(x, scale, zp):
    """x's signed codes against a given asymmetric (scale, zero point),
    broadcast against x, as ``quantize_uint_mm`` rounds them."""
    f = get_format("int8")
    v = (x.float() - zp.float()) / scale.float()
    return torch.clamp(torch.round(v), f.min, f.max).to(torch.int8)


def row_scale_from_amax(amax: torch.Tensor, x_fmt: str = "int8"):
    """The row scale ``quantize_rows`` takes for rows of absolute maximum
    ``amax``: ``max(amax / qmax, 2^-126)``, the division true, as the
    kernel and ``quant.core`` compute it."""
    _given_scale_fmt(x_fmt)
    return get_scale_symmetric(amax.float().reshape(-1, 1), -1,
                               get_format(x_fmt))


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor,
                        x_fmt: str = "int8"):
    """x's codes against a given scale (broadcast against x: (M, 1) a
    row, (1, K) a column), as ``quantize_int_mm`` / ``quantize_fp_mm``
    round them."""
    f = get_format(x_fmt)
    v = x.float() / scale.float()
    if f.is_integer:
        return torch.clamp(torch.round(v), f.min, f.max).to(torch.int8)
    return torch.nan_to_num(torch.clamp(v, f.min, f.max)).to(
        f.torch_storage)


def quantize_rows(x: torch.Tensor, x_fmt: str = "int8", k_pad: int = 0,
                  colscale=None, row_scale=None, row_range=None):
    """Per-row quantization of x (M, K) float, times ``colscale`` (K,) per
    column where given, to ``x_fmt`` ("int8", "uint8" or "float8_e4m3fn").
    ``row_scale`` (M,) gives each row's scale ("int8" and "float8_e4m3fn"),
    ``row_range`` (the rows' minima (M,), maxima (M,)) each uint8 row's
    range: the kernel skips its statistics pass and quantizes against them
    (a row-parallel layer's rows, whose statistics are all-reduced over
    the tensor axis; ``row_scale_from_amax``).

    Returns ``(x_q (M, K + k_pad), x_scale (M, 1), x_zp, x_rowsum)``; the
    last two are (M, 1) for "uint8" (signed codes with x = x_q*scale + zp,
    rowsum = sum(x_q)*scale) and None otherwise.  Codes are bit-equal
    between the kernel and the plain version."""
    if x_fmt not in _ROW_FORMATS:
        raise ValueError(f"no row quantize to {x_fmt!r}")
    if not is_cuda(x):
        return quantize_rows_plain(x, x_fmt, k_pad, colscale, row_scale,
                                   row_range)
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes (M, K), got {tuple(x.shape)}")
    _given_fmt(x_fmt, row_scale, row_range)
    x = x.contiguous()
    m, k = x.shape
    cs = _vec(colscale, k, "colscale")
    gs = _vec(row_scale, m, "row_scale")
    if row_range is not None:   # the minima, then the maxima
        gs = torch.cat([_vec(v, m, "row_range") for v in row_range])
    dtype, mode = _ROW_FORMATS[x_fmt]
    asym = x_fmt == "uint8"
    xq = torch.empty((m, k + k_pad), dtype=dtype, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    zp = torch.empty_like(xs) if asym else None
    rs = torch.empty_like(xs) if asym else None
    if m:
        fn = _build.function("quantize_rows", "sdnq_quantize_rows",
                             [P] * 7 + [I] * 5 + [P])
        _build.check(fn(_build.ptr(x), _build.ptr(xq), _build.ptr(xs),
                        _build.ptr(zp), _build.ptr(rs), _build.ptr(cs),
                        _build.ptr(gs), m, k, k + k_pad,
                        _build.act_kind(x.dtype), mode, _build.stream(x)),
                     "quantize_rows")
        quantize_rows.launches += 1
        if cs is not None:
            quantize_rows.mode_launches["colscale"] += 1
        if gs is not None:
            quantize_rows.mode_launches["given_scale"] += 1
    return xq, xs, zp, rs


quantize_rows.launches = 0
quantize_rows.mode_launches = dict(colscale=0, given_scale=0)


# ---------------------------------------------------------------------------
# B4: the scaled GEMM
# ---------------------------------------------------------------------------

def _vec(t, n, name):
    if t is None:
        return None
    t = t.reshape(-1)
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} values, expected {n}")
    return t.float().contiguous()


def scaled_gemm_plain(a, b, out_dtype, xs=None, ws=None, bias=None, rs=None,
                      zp=None, vz0=None, vz1=None, b_layout="nt"):
    """Plain version of ``scaled_gemm``, in the kernel's order of
    operations: ((((acc*xs)*ws)+bias)+rs*vz0)+zp*vz1 in fp32."""
    nt = b_layout == "nt"
    if a.dtype == torch.int8:
        acc = _exact_int8_mm(a, b.T if nt else b).float()
    else:
        acc = a.float() @ (b.float().T if nt else b.float())
    out = acc
    if xs is not None:
        out = out * xs.reshape(-1, 1).float()
    if ws is not None:
        out = out * ws.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    if rs is not None:
        out = out + rs.reshape(-1, 1).float() * vz0.reshape(1, -1).float()
    if zp is not None:
        out = out + zp.reshape(-1, 1).float() * vz1.reshape(1, -1).float()
    return out.to(out_dtype)


# contraction rows a float64 chunk of the plain int8 products
_PLAIN_CHUNK = 1 << 14


def _exact_int8_mm(a, b):
    """a (M, K) @ b (K, N) of int8 codes in float64, exact (|sum| < 2^53),
    the contraction taken in chunks."""
    out = None
    for k0 in range(0, max(a.shape[1], 1), _PLAIN_CHUNK):
        part = (a[:, k0:k0 + _PLAIN_CHUNK].double()
                @ b[k0:k0 + _PLAIN_CHUNK].double())
        out = part if out is None else out.add_(part)
    return out


def scaled_gemm(a, b, out_dtype=torch.bfloat16, xs=None, ws=None, bias=None,
                rs=None, zp=None, vz0=None, vz1=None, b_layout="nt"):
    """``(a · bᵀ) * xs[m] * ws[n] + bias[n] + rs[m]*vz0[n] + zp[m]*vz1[n]``.

    a (M, K), b (N, K): both int8 (int32 accumulate; int64 across the
    parts of a contraction of 2^17 or more), both fp8 e4m3 or both bf16
    (fp32 accumulate).  ``b_layout="nn"``: b is (K, N) and the product is
    ``a · b`` (8-bit kinds).  Every epilogue operand is optional; ``rs``
    goes with ``vz0`` and ``zp`` with ``vz1``."""
    if b_layout not in ("nt", "nn"):
        raise ValueError(f"b_layout {b_layout!r}")
    if not is_cuda(a):
        return scaled_gemm_plain(a, b, out_dtype, xs, ws, bias, rs, zp,
                                 vz0, vz1, b_layout)
    nn = b_layout == "nn"
    if a.dtype != b.dtype or a.dtype not in _GEMM_KINDS:
        raise ValueError(f"scaled_gemm takes int8, float8_e4m3fn or bf16 "
                         f"operands, got {a.dtype} x {b.dtype}")
    if nn and a.dtype == torch.bfloat16:
        raise ValueError("the nn layout takes 8-bit operands")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0 if nn else 1]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)} "
                         f"({b_layout})")
    if (rs is None) != (vz0 is None) or (zp is None) != (vz1 is None):
        raise ValueError("rs needs vz0 and zp needs vz1")
    m, k = a.shape
    n = b.shape[1 if nn else 0]
    if k < 1:
        raise ValueError(f"scaled_gemm takes K >= 1, got K {k}")
    a, b = gemm_operands(a, b, nn)
    xs, rs, zp = (_vec(t, m, nm) for t, nm in ((xs, "xs"), (rs, "rs"),
                                                (zp, "zp")))
    ws, bias, vz0, vz1 = (_vec(t, n, nm) for t, nm in (
        (ws, "ws"), (bias, "bias"), (vz0, "vz0"), (vz1, "vz1")))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m and n:
        fn = _build.function("scaled_mm", "sdnq_scaled_mm",
                             [P, I, P, I] + [P] * 8 + [I] * 9 + [P, P, P])
        plan, work = (1, 0, 1), (None, None)
        if nn:
            plan = nn_plan(m, n, k, a.dtype, _sm_count(a.device))
            work = _nn_work(fn, m, n, plan, a)
        elif a.dtype == torch.int8 and k >= LONG_K:
            plan = (1, 0, long_parts(k))
            work = _workspace(fn, *nt_work_ints(m, n, plan[2]), a)
        _build.check(fn(_build.ptr(a), a.stride(0), _build.ptr(b),
                        b.stride(0),
                        *(_build.ptr(t) for t in (out, xs, ws, bias, rs, zp,
                                                  vz0, vz1)),
                        m, n, k, _GEMM_KINDS[a.dtype],
                        _build.act_kind(out_dtype), int(nn), *plan,
                        *(_build.ptr(t) for t in work), _build.stream(a)),
                     "scaled_gemm")
        scaled_gemm.launches += 1
        scaled_gemm.mode_launches["nn" if nn else "nt"] += 1
        scaled_gemm.mode_launches["bf16"] += a.dtype == torch.bfloat16
        scaled_gemm.mode_launches["long"] += (a.dtype == torch.int8
                                              and k >= LONG_K)
    return out


def gemm_operands(a, b, nn: bool):
    """a and b as the kernel reads them: TMA reads the rows where they
    lie and zero-fills the K (nt), or K and N (nn), tails, so each comes
    back as itself unless TMA cannot read it (``_build.tma_rows``: a view
    off a 16-byte boundary or with rows not a multiple of 16 bytes apart),
    then as a copy; nothing is padded to a tile."""
    k = a.shape[1]
    return (_build.tma_rows(a, k),
            _build.tma_rows(b) if nn else _build.tma_rows(b, k))


scaled_gemm.launches = 0
scaled_gemm.mode_launches = dict(nt=0, nn=0, bf16=0, long=0)
_GEMM_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# An int8 sum is exact in int32 while 128 * 128 * K < 2^31: a contraction
# of LONG_K rows or more is split into parts of at most LONG_PART_STAGES
# stages of 128 rows (130,944 rows), whose int32 sums the kernel adds in
# int64 (hopper.cuh's ``part_stages``).
LONG_K = 1 << 17
LONG_PART_STAGES = 1023
# The nn kernel's stages take 128 contraction rows; a split tile's
# contraction is split at most this many ways.
NN_STAGE = 128
NN_MAX_SPLITS = 16
# The plan's costs, in the time of one stage of a 128 x 128 tile (fitted
# to ``chip_smoke.py --b1-probes`` on an H100 80GB HBM3 at 700 W): a 128 x
# 256 tile's stage (its A read once for both halves: 1.63-1.73), a unit's
# start and end (the ring's first stages, the epilogue), and a split
# unit's partial sums written, and read back by its tile's last unit, for
# 128 rows.
_NN_WIDE_STAGE = 1.65
_NN_UNIT = 3.0
_NN_SLAB_WRITE = 8.0
_NN_SLAB_READ = 4.0


def long_parts(k: int) -> int:
    """The parts of an int8 contraction of ``k`` rows: 1 below 2^17, else
    the fewest whose stages of 128 rows each number at most
    LONG_PART_STAGES."""
    if k < LONG_K:
        return 1
    return -(-(-(-k // 128)) // LONG_PART_STAGES)


def nn_plan(m: int, n: int, k: int, dtype, sms: int = 132):
    """B4 nn's plan for a (M, K) x (K, N) product: ``(nb, whole, splits)``:
    tiles 128 x 128 nb, the first ``whole`` computed whole and the
    contraction of the others split ``splits`` ways, so that their units
    fill the round the whole tiles leave part-empty (128 x 128 tiles only:
    the wide tiles' partial sums cost more than they save, in every
    reading of ``chip_smoke.py --b1-probes``).  It minimises the
    busiest SM's time, in stages of a 128 x 128 tile: the whole tiles' full
    rounds of ``stages = ceil(K / 128)`` each, then ``ceil(tail * splits /
    sms)`` rounds of ``ceil(stages / splits)``, where a wide stage costs
    ``_NN_WIDE_STAGE``, a round ``_NN_UNIT`` more, and a split unit its
    partial sums' traffic (in proportion to its rows): written by each,
    read by its tile's last.  e4m3 takes 128 x 128 tiles only.  An int8
    contraction of 2^17 rows or more splits every 128 x 128 tile (``whole``
    0), at least ``long_parts`` ways."""
    stages = -(-k // NN_STAGE)
    mt = -(-m // 128)
    rows = min(m, 128) / 128
    least = long_parts(k) if dtype == torch.int8 else 1
    best = None
    for nb in (1, 2) if dtype == torch.int8 and least == 1 else (1,):
        tiles = mt * -(-n // (128 * nb))
        stage = _NN_WIDE_STAGE if nb == 2 else 1.0
        wholes = {tiles, tiles // sms * sms} if nb == 1 else {tiles}
        if least > 1:
            wholes = {0}
        for whole in sorted(wholes, reverse=True):
            tail = tiles - whole
            for splits in range(least, max(least, min(stages, NN_MAX_SPLITS))
                                + 1 if tail else 2):
                cost = -(-whole // sms) * (stages * stage + _NN_UNIT)
                if tail:
                    per = -(-stages // splits) * stage + _NN_UNIT
                    if splits > 1:
                        per += _NN_SLAB_WRITE * rows
                        cost += _NN_SLAB_READ * rows * (splits - 1)
                    cost += -(-tail * splits // sms) * per
                if best is None or cost < best[0] - 1e-9:
                    best = (cost, nb, whole, splits)
    return best[1:]


def nn_work_ints(m: int, n: int, nb: int, whole: int, splits: int):
    """The nn kernel's workspace in int32 entries, ``(counters, slabs)``:
    an arrival counter a split tile, and a slab of its 128 x 128 nb partial
    sums a split and split tile; none without a split."""
    tail = -(-m // 128) * -(-n // (128 * nb)) - whole
    if splits == 1 or not tail:
        return 0, 0
    return tail, splits * tail * 128 * 128 * nb


def nt_work_ints(m: int, n: int, parts: int):
    """B4 nt's workspace for a contraction in ``parts`` (> 1), in int32
    entries, ``(counters, slabs)``: a counter a tile and a slab of its
    128 x 128 nb sums a part and tile, for either tile width."""
    mt = -(-m // 128)
    return mt * -(-n // 128), parts * mt * -(-n // 256) * 256 * 128


def _nn_work(fn, m, n, plan, a):
    """The workspace of a split call: ``(counters, slabs)``, or ``(None,
    None)``."""
    return _workspace(fn, *nn_work_ints(m, n, *plan), a)


def _workspace(fn, counters, slabs, a):
    """``counters`` and ``slabs`` int32 entries of a split call's
    workspace, or ``(None, None)`` for none.  The counters are one array a
    build of the kernel (``fn``), device and stream, kept between calls and
    grown as needed: zeroed when made, and each call leaves them 0 (a
    tile's last unit resets its own), so no call fills them.  The slabs
    are written before they are read, so each call takes them from the
    caching allocator, which has them back when the call's stream is done
    with them (B10's over 147,456 tokens at linear1's width: 528 MB)."""
    if not slabs:
        return None, None
    cache = getattr(fn, "nn_work", None)
    if cache is None:
        cache = fn.nn_work = {}
    key = (a.device.index, _build.stream(a))
    c = cache.get(key)
    if c is None or c.numel() < counters:
        c = cache[key] = torch.zeros(counters, dtype=torch.int32,
                                     device=a.device)
    return c, torch.empty(slabs, dtype=torch.int32, device=a.device)


_SMS: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


# ---------------------------------------------------------------------------
# B10: the grad-weight GEMM
# ---------------------------------------------------------------------------

def scaled_mm_tn_plain(a_q, b_q, a_scale=None, b_scale=None,
                       out_dtype=torch.float32, lowrank_u=None,
                       lowrank_v=None):
    """Plain version of ``scaled_mm_tn``: ((aᵀ·b) * a_s[n]) * b_s[k] in
    fp32 (the int8 sum exact in float64, rounded once), then ``+ u @ v``."""
    if a_q.dtype == torch.int8:
        acc = _exact_int8_mm(a_q.T, b_q).float()   # exact, rounded once
    else:
        acc = a_q.float().T @ b_q.float()
    out = acc
    if a_scale is not None:
        out = out * a_scale.reshape(-1, 1).float()
    if b_scale is not None:
        out = out * b_scale.reshape(1, -1).float()
    return _add_lowrank(out, lowrank_u, lowrank_v, out_dtype).to(out_dtype)


def scaled_mm_tn(a_q, b_q, a_scale=None, b_scale=None,
                 out_dtype=torch.float32, lowrank_u=None, lowrank_v=None):
    """``out (N, K) = (a_qᵀ @ b_q) * a_scale[:, None] * b_scale[None, :]
    [+ u @ v]``, contracting the leading (M) axis of a_q (M, N) and b_q
    (M, K), both int8 or both fp8 e4m3, any M (M = 1 included); the
    columnwise scales (N,) / (K,) are optional; the rank-R u (N, R) @ v
    (R, K) term is added in the kernel's epilogue (fp32, summed in r
    order).  An int8 sum over 2^17 tokens or more stays exact: each tile
    in ``long_parts`` parts, added in int64."""
    if not is_cuda(a_q):
        return scaled_mm_tn_plain(a_q, b_q, a_scale, b_scale, out_dtype,
                                  lowrank_u, lowrank_v)
    if a_q.dtype != b_q.dtype or a_q.dtype not in _TN_KINDS:
        raise ValueError(f"scaled_mm_tn takes int8 or float8_e4m3fn "
                         f"operands, got {a_q.dtype} x {b_q.dtype}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[0] != b_q.shape[0]:
        raise ValueError(f"shapes {tuple(a_q.shape)} x {tuple(b_q.shape)}")
    if (lowrank_u is None) != (lowrank_v is None):
        raise ValueError("lowrank_u needs lowrank_v")
    m, n = a_q.shape
    k = b_q.shape[1]
    a_s, b_s = _vec(a_scale, n, "a_scale"), _vec(b_scale, k, "b_scale")
    u, v, r = _tn_lowrank(lowrank_u, lowrank_v, n, k)
    out = torch.empty((n, k), dtype=torch.float32, device=a_q.device)
    if not (n and k):
        return out.to(out_dtype)
    if not m:   # an empty sum
        out.zero_()
        if u is not None:
            out += u @ v
        return out.to(out_dtype)
    # TMA reads rows a multiple of 16 bytes apart from a 16-byte boundary:
    # others are copied (the zero columns past N or K reach no output)
    a_q, b_q = _build.tma_rows(a_q), _build.tma_rows(b_q)
    tok, k_fast = tn_plan(m, n, k, a_q.dtype)
    fn = _build.function("scaled_mm_tn", "sdnq_scaled_mm_tn",
                         [P, I, P, I] + [P] * 5 + [I] * 8 + [P] * 3)
    parts = long_parts(m) if a_q.dtype == torch.int8 else 1
    counters, slabs = _workspace(fn, *tn_work_ints(n, k, parts), a_q)
    _build.check(fn(_build.ptr(a_q), a_q.stride(0), _build.ptr(b_q),
                    b_q.stride(0), *(_build.ptr(t) for t in (out, a_s, b_s,
                                                             u, v)),
                    r, m, n, k, _TN_KINDS[a_q.dtype], tok, int(k_fast),
                    parts, _build.ptr(counters), _build.ptr(slabs),
                    _build.stream(a_q)), "scaled_mm_tn")
    scaled_mm_tn.launches += 1
    scaled_mm_tn.mode_launches["parts"] += parts > 1
    return out.to(out_dtype)


scaled_mm_tn.launches = 0
scaled_mm_tn.mode_launches = dict(parts=0)
_TN_KINDS = {torch.int8: 0, torch.float8_e4m3fn: 2}
# The rank-R term against the plain version's torch u @ v: the kernel sums
# it in fp32 in r order and adds it last, so each output may differ by an
# fp32 rounding or two of |out| + |u| @ |v|; the limit on the worst
# |got - want| / (|want| + |u| @ |v|), about twice the sound readings
# (chip_smoke.py phase 3 and the card tests).
TN_LOWRANK_TOL = 2.4e-7


def tn_plan(m: int, n: int, k: int, dtype):
    """B10's stage plan for a (M, N) x (M, K) product: ``(tok, k_fast)``.
    A stage takes ``tok`` tokens: 128 (int8) or 64 (e4m3), or M rounded up
    to 32 where it is smaller (32, 64 or 96; the batch-1 modulation linears
    take one k32 step with 31 zero-filled rows).  ``k_fast``: the K tiles
    are walked fastest when A (M, N) is the larger operand, so that each of
    its column stripes is read once while B's stay in the L2 cache.  The
    tile width (128 x 128 or 128 x 256) is the C entry's, by hopper.cuh's
    ``wide_tiles`` as for B4."""
    tok = min(128 if dtype == torch.int8 else 64, -(-m // 32) * 32)
    return tok, n >= k


def tn_work_ints(n: int, k: int, parts: int):
    """B10's workspace for ``parts`` in int32 entries, ``(counters,
    slabs)``: a counter a tile and a slab of its 128 x 128 nb sums a part
    and tile, for either tile width; none for one part."""
    if parts == 1:
        return 0, 0
    nt = -(-n // 128)
    return nt * -(-k // 128), parts * nt * 128 * -(-k // 256) * 256


def _tn_lowrank(u, v, n, k):
    """(u (N, R), v (R, K), R) as the kernel reads them: fp32, contiguous
    (no copy of a tensor that already is); (None, None, 0) without."""
    if u is None:
        return None, None, 0
    if u.dim() != 2 or v.dim() != 2 or u.shape[0] != n or v.shape[1] != k \
            or u.shape[1] != v.shape[0] or u.shape[1] < 1:
        raise ValueError(f"lowrank u {tuple(u.shape)}, v {tuple(v.shape)} "
                         f"for an ({n}, {k}) output")
    return (u.float().contiguous(), v.float().contiguous(), u.shape[1])


def _add_lowrank(out, u, v, out_dtype):
    if u is None:
        return out
    return (out.float() + u.float() @ v.float()).to(out_dtype)


# ---------------------------------------------------------------------------
# Public entry points (the JAX package's signatures)
# ---------------------------------------------------------------------------

def scaled_mm(x_q, w_q, x_scale=None, w_scale=None, bias=None,
              out_dtype=torch.bfloat16, lowrank_u=None, lowrank_v=None):
    """``(x_q @ w_q.T) * x_scale * w_scale + bias [+ u @ v]`` on already
    quantized int8, fp8 e4m3 or bf16 operands; the rank-R u@v term is
    added after the kernel."""
    out = scaled_gemm(x_q, w_q, out_dtype, x_scale, w_scale, bias)
    return _add_lowrank(out, lowrank_u, lowrank_v, out_dtype)


def scaled_mm_fused_act(x, w_q, w_scale=None, bias=None, *,
                        x_fmt: str = "int8", out_dtype=torch.bfloat16,
                        lowrank_u=None, lowrank_v=None, v_zp0=None,
                        v_zp1=None, b_layout: str = "nt",
                        emit_quantized: bool = False, x_colscale=None,
                        x_row_scale=None, x_row_range=None):
    """``scaled_mm`` with per-row activation quantization of x (M, K) float:
    ``quantize_rows`` then ``scaled_gemm`` (two launches).

    x_fmt "int8" (symmetric), "uint8" (asymmetric; needs v_zp0 / v_zp1,
    the weight-side zero-point rows, which enter the epilogue as the rank-1
    terms rowsum(x_q)*x_scale ⊗ v_zp0 + x_zp ⊗ v_zp1; ``x_row_range``
    gives the rows' (minima, maxima)) or "float8_e4m3fn"
    (with e4m3 weights).  ``b_layout`` "nt": w_q (O, K), out = x @ w_qᵀ;
    "nn": w_q (K, O), out = x @ w_q, the stored (O, K) weight read as it
    lies when the cotangent plays x (the grad-input).  ``x_colscale`` (K,)
    multiplies x's columns before the row statistics; ``x_row_scale``
    (M,) gives the rows' scales ("int8" / e4m3: a shard's row statistics,
    all-reduced).  ``emit_quantized``
    ("nt" only) also returns the row codes and scales, unpadded, as the
    JAX package orders them: ``(y, x_q (M, K), x_scale (M, 1))``, and for
    "uint8" (signed codes with x = x_q*scale + zp) ``(y, x_q, x_scale,
    x_zp (M, 1))``."""
    asym = x_fmt == "uint8"
    if asym and (v_zp0 is None or v_zp1 is None):
        raise ValueError("x_fmt='uint8' needs v_zp0 and v_zp1")
    if emit_quantized and b_layout != "nt":
        raise ValueError("emit_quantized takes the nt layout")
    kdim = x.shape[-1]
    # the codes' rows padded to a multiple of 16 bytes (after the row
    # statistics, so zeros never skew min/max): TMA reads them in place, the
    # first K codes of each (the GEMM's view)
    pad = (-kdim) % 16 if is_cuda(x) else 0
    x_q, x_scale, x_zp, x_rs = quantize_rows(
        x, x_fmt, k_pad=pad, colscale=x_colscale, row_scale=x_row_scale,
        row_range=x_row_range)
    if pad:
        x_q = x_q[:, :kdim]
    out = scaled_gemm(x_q, w_q, out_dtype, x_scale, w_scale, bias,
                      rs=x_rs, zp=x_zp, vz0=v_zp0 if asym else None,
                      vz1=v_zp1 if asym else None, b_layout=b_layout)
    out = _add_lowrank(out, lowrank_u, lowrank_v, out_dtype)
    if not emit_quantized:
        return out
    return (out, x_q, x_scale, x_zp) if asym else (out, x_q, x_scale)


def dynamic_mm_tn(a, b, mm_fmt: str = "int8", out_dtype=torch.float32,
                  saved_b: tuple | None = None, stats=None):
    """aᵀ @ b with both operands quantized **columnwise** in the ``mm_fmt``
    family (per out-row n over M for a, per out-col k over M for b, plain
    torch as in the JAX package) and multiplied by B10: the grad-weight
    GEMM with no transposed copy.  ``saved_b`` replaces the b-side quantize
    with a pre-quantized (q, scale[, zp]) tuple.  The uint8 family's three
    rank-1 cross terms enter B10's epilogue as a rank-2 u @ v in fp32; the
    16-bit family is one bf16-valued product accumulated in fp32 (no
    kernel, as in the JAX package).  ``stats`` ``(a's, b's)`` (8-bit
    families): the columns' statistics to quantize by, where the tokens
    are split over data ranks: absolute maxima (N,) / (K,), or for uint8
    (minima, maxima); b's is None beside ``saved_b``."""
    f = get_format(mm_fmt)
    a = a.float()
    if stats is not None:
        if f.num_bits != 8 or (stats[1] is None) != (saved_b is not None):
            raise ValueError("given column statistics take 8-bit operands, "
                             "b's unless b is saved")
        if f.is_unsigned:
            a_q, b_q, a_s1, b_s1, u, v = uint8_tn_operands(a, b, saved_b,
                                                           stats)
            return scaled_mm_tn(a_q, b_q, a_s1, b_s1, out_dtype=out_dtype,
                                lowrank_u=u, lowrank_v=v)
        name = "int8" if f.is_integer else f.name
        a_s = row_scale_from_amax(stats[0], name).reshape(1, -1)
        if saved_b is None:
            b_s = row_scale_from_amax(stats[1], name).reshape(1, -1)
            b_q = quantize_with_scale(b.float(), b_s, name)
        else:
            b_q, b_s = saved_b
        return scaled_mm_tn(quantize_with_scale(a, a_s, name), b_q,
                            a_s.reshape(-1), b_s.reshape(-1),
                            out_dtype=out_dtype)
    if f.is_integer and not f.is_unsigned:
        a_q, a_s = quantize_int_mm(a, 0)
        b_q, b_s = (quantize_int_mm(b.float(), 0) if saved_b is None
                    else saved_b)
        return scaled_mm_tn(a_q, b_q, a_s.reshape(-1), b_s.reshape(-1),
                            out_dtype=out_dtype)
    if f.is_integer:
        a_q, b_q, a_s1, b_s1, u, v = uint8_tn_operands(a, b, saved_b)
        return scaled_mm_tn(a_q, b_q, a_s1, b_s1, out_dtype=out_dtype,
                            lowrank_u=u, lowrank_v=v)
    if f.num_bits == 8:
        a_q, a_s = quantize_fp_mm(a, 0, fmt=f)
        b_q, b_s = (quantize_fp_mm(b.float(), 0, fmt=f) if saved_b is None
                    else saved_b)
        return scaled_mm_tn(a_q, b_q, a_s.reshape(-1), b_s.reshape(-1),
                            out_dtype=out_dtype)
    # 16-bit family: bf16 values, products exact in fp32, fp32 sums
    acc = a.to(torch.bfloat16).float().T @ b.to(torch.bfloat16).float()
    return acc.to(out_dtype)


def uint8_tn_operands(a, b, saved_b=None, ranges=None):
    """The uint8 family's B10 operands for aᵀ @ b: ``(a_q, b_q, a_s, b_s,
    u, v)``, both quantized columnwise with a zero point (``saved_b`` the
    b side's (q, scale, zp); ``ranges`` the columns' given (minima, maxima)
    of a and of b, b's None beside ``saved_b``).  aᵀb = (a_q s_a +
    z_a)ᵀ(b_q s_b + z_b): colsum(a_q)·s_a ⊗ z_b, z_a ⊗ colsum(b_q)·s_b and
    M·z_a ⊗ z_b, as one rank-2 term u (N, 2) @ v (2, K), each linear in
    the tokens, so that data ranks' terms add up to the whole batch's."""
    mdim = a.shape[0]

    def quantize(x, rng):
        if rng is None:
            return quantize_uint_mm(x.float(), 0)
        s, zp = uint8_scale_from_range(*(r.reshape(1, -1) for r in rng))
        return quantize_with_range(x, s, zp), s, zp
    a_q, a_s, a_zp = quantize(a, None if ranges is None else ranges[0])
    b_q, b_s, b_zp = (quantize(b, None if ranges is None else ranges[1])
                      if saved_b is None else saved_b)
    a_s1, a_zp1 = a_s.reshape(-1), a_zp.reshape(-1)
    b_s1, b_zp1 = b_s.reshape(-1), b_zp.reshape(-1)
    csa = a_q.to(torch.int32).sum(0).float()
    csb = b_q.to(torch.int32).sum(0).float()
    u = torch.stack([csa * a_s1, a_zp1], dim=-1)
    v = torch.stack([b_zp1, csb * b_s1 + float(mdim) * b_zp1], dim=0)
    return a_q, b_q, a_s1, b_s1, u, v


def bf16_scaled_mm(x, w, x_scale=None, w_scale=None, bias=None,
                   out_dtype=torch.bfloat16, lowrank_u=None, lowrank_v=None):
    """16-bit scaled GEMM: bf16 multiplies, fp32 accumulate."""
    return scaled_mm(x.to(torch.bfloat16), w.to(torch.bfloat16), x_scale,
                     w_scale, bias, out_dtype=out_dtype, lowrank_u=lowrank_u,
                     lowrank_v=lowrank_v)
