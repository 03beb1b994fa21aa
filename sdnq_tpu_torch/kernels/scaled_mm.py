"""Scaled matmuls: B1 (activation-quantizing GEMM) and B4 (scaled GEMM).

``out = (x_q · w_qᵀ) * x_scale * w_scale + bias [+ rank-1 zero-point terms]
[+ u @ v]`` with x_q (M, K) and w_q (O, K) both K-contiguous.

Kernels, each beside its plain PyTorch version and a launch counter:

* ``quantize_rows`` — B1's quantize half, ``csrc/quantize_rows.cu``.
  Replaces the prologue of ``sdnq_tpu/kernels/scaled_mm.py``
  ``_fused_act_mm_kernel``.  The TPU kernel quantizes each row block of x
  inside the GEMM because the full-K block fits VMEM; on Hopper it cannot
  (227 KB of shared memory against 1.9 MB for 64 bf16 rows at K = 15360), so
  the quantize is a separate memory-bound pass: read x once, write int8
  (or e4m3) codes and one scale per row.
* ``scaled_gemm`` — B4, and B1's GEMM half, ``csrc/scaled_mm.cu``.  Replaces
  ``_mm_kernel`` and the GEMM of ``_fused_act_mm_kernel``: mma.sync int8
  (int32 accumulate), fp8 e4m3 or bf16 (fp32 accumulate), bound by tensor-core
  operations at the FLUX shapes, with the scale/bias/zero-point epilogue
  fused so the accumulator never reaches device memory.

``scaled_mm_fused_act`` = ``quantize_rows`` then ``scaled_gemm``: two
launches per linear.  On a CUDA tensor the wrappers launch their kernel or
raise; on a CPU tensor they run the plain version.  The plain int8 GEMM
accumulates in float64, which is exact for |acc| < 2^53 (int8 products over
K = 15360 stay below 2^28), so it equals the kernel's int32 sum; its fp32
products need ``torch.backends.cuda.matmul.allow_tf32 = False`` on the card
(the default), which ``chip_smoke.py`` sets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._build import P, I
from .dispatch import is_cuda
from ..quant.core import quantize_fp_mm, quantize_int_mm, quantize_uint_mm

__all__ = ["quantize_rows", "quantize_rows_plain", "scaled_gemm",
           "scaled_gemm_plain", "scaled_mm", "scaled_mm_fused_act",
           "bf16_scaled_mm"]

# The GEMM kernel walks K in 64-byte stages.
_K_BYTES = 64


def _k_pad(k: int, itemsize: int) -> int:
    mult = _K_BYTES // itemsize
    return (-k) % mult


def _pad_k(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` zero columns; for one-byte codes (int8, e4m3) through a
    uint8 view, since zero bytes are zero values in both."""
    if t.element_size() == 1:
        return F.pad(t.view(torch.uint8), (0, pad)).view(t.dtype)
    return F.pad(t, (0, pad))


# ---------------------------------------------------------------------------
# B1, quantize half
# ---------------------------------------------------------------------------

# activation formats of the row quantize: (code dtype, kernel mode)
_ROW_FORMATS = {"int8": (torch.int8, 0), "uint8": (torch.int8, 1),
                "float8_e4m3fn": (torch.float8_e4m3fn, 2)}


def quantize_rows_plain(x: torch.Tensor, x_fmt: str = "int8",
                        k_pad: int = 0):
    """Plain version of ``quantize_rows``: ``quant.core.quantize_int_mm`` /
    ``quantize_uint_mm`` / ``quantize_fp_mm`` per row, then ``k_pad`` zero
    columns."""
    zp = rs = None
    if x_fmt == "uint8":
        q, s, zp = quantize_uint_mm(x, -1)
        rs = q.to(torch.int32).sum(-1, keepdim=True).float() * s
    elif x_fmt == "int8":
        q, s = quantize_int_mm(x, -1)
    else:
        q, s = quantize_fp_mm(x, -1, fmt=x_fmt)
    if k_pad:
        q = _pad_k(q, k_pad)
    return q, s, zp, rs


def quantize_rows(x: torch.Tensor, x_fmt: str = "int8", k_pad: int = 0):
    """Per-row quantization of x (M, K) float to ``x_fmt`` ("int8",
    "uint8" or "float8_e4m3fn").

    Returns ``(x_q (M, K + k_pad), x_scale (M, 1), x_zp, x_rowsum)``; the
    last two are (M, 1) for "uint8" (signed codes with x = x_q*scale + zp,
    rowsum = sum(x_q)*scale) and None otherwise.  Codes are bit-equal
    between the kernel and the plain version."""
    if x_fmt not in _ROW_FORMATS:
        raise ValueError(f"no row quantize to {x_fmt!r}")
    if not is_cuda(x):
        return quantize_rows_plain(x, x_fmt, k_pad)
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes (M, K), got {tuple(x.shape)}")
    x = x.contiguous()
    m, k = x.shape
    dtype, mode = _ROW_FORMATS[x_fmt]
    asym = x_fmt == "uint8"
    xq = torch.empty((m, k + k_pad), dtype=dtype, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    zp = torch.empty_like(xs) if asym else None
    rs = torch.empty_like(xs) if asym else None
    if m:
        fn = _build.function("quantize_rows", "sdnq_quantize_rows",
                             [P, P, P, P, P, I, I, I, I, I, P])
        _build.check(fn(_build.ptr(x), _build.ptr(xq), _build.ptr(xs),
                        _build.ptr(zp), _build.ptr(rs), m, k, k + k_pad,
                        _build.act_kind(x.dtype), mode,
                        _build.stream(x)), "quantize_rows")
        quantize_rows.launches += 1
    return xq, xs, zp, rs


quantize_rows.launches = 0


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
                      zp=None, vz0=None, vz1=None):
    """Plain version of ``scaled_gemm``, in the kernel's order of
    operations: ((((acc*xs)*ws)+bias)+rs*vz0)+zp*vz1 in fp32."""
    if a.dtype == torch.int8:
        acc = (a.double() @ b.double().T).float()  # exact int32 sum
    else:
        acc = a.float() @ b.float().T
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


def scaled_gemm(a, b, out_dtype=torch.bfloat16, xs=None, ws=None, bias=None,
                rs=None, zp=None, vz0=None, vz1=None):
    """``(a · bᵀ) * xs[m] * ws[n] + bias[n] + rs[m]*vz0[n] + zp[m]*vz1[n]``.

    a (M, K), b (N, K): both int8 (int32 accumulate), both fp8 e4m3 or both
    bf16 (fp32 accumulate).  Every epilogue operand is optional; ``rs``
    goes with ``vz0`` and ``zp`` with ``vz1``."""
    if not is_cuda(a):
        return scaled_gemm_plain(a, b, out_dtype, xs, ws, bias, rs, zp,
                                 vz0, vz1)
    if a.dtype != b.dtype or a.dtype not in _GEMM_KINDS:
        raise ValueError(f"scaled_gemm takes int8, float8_e4m3fn or bf16 "
                         f"operands, got {a.dtype} x {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if (rs is None) != (vz0 is None) or (zp is None) != (vz1 is None):
        raise ValueError("rs needs vz0 and zp needs vz1")
    m, k = a.shape
    n = b.shape[0]
    pad = _k_pad(k, a.element_size())
    if pad:  # zeros add nothing to the sums
        a, b = _pad_k(a, pad), _pad_k(b, pad)
    a, b = a.contiguous(), b.contiguous()
    xs, rs, zp = (_vec(t, m, nm) for t, nm in ((xs, "xs"), (rs, "rs"),
                                                (zp, "zp")))
    ws, bias, vz0, vz1 = (_vec(t, n, nm) for t, nm in (
        (ws, "ws"), (bias, "bias"), (vz0, "vz0"), (vz1, "vz1")))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m and n:
        fn = _build.function("scaled_mm", "sdnq_scaled_mm",
                             [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P])
        _build.check(fn(*(_build.ptr(t) for t in (a, b, out, xs, ws, bias,
                                                  rs, zp, vz0, vz1)),
                        m, n, k + pad, _GEMM_KINDS[a.dtype],
                        _build.act_kind(out_dtype), _build.stream(a)),
                     "scaled_gemm")
        scaled_gemm.launches += 1
    return out


scaled_gemm.launches = 0
_GEMM_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


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
                        v_zp1=None):
    """``scaled_mm`` with per-row activation quantization of x (M, K) float:
    ``quantize_rows`` then ``scaled_gemm`` (two launches).

    x_fmt "int8" (symmetric), "uint8" (asymmetric; needs v_zp0 / v_zp1,
    the weight-side zero-point rows, which enter the epilogue as the rank-1
    terms rowsum(x_q)*x_scale ⊗ v_zp0 + x_zp ⊗ v_zp1) or "float8_e4m3fn"
    (with e4m3 weights)."""
    asym = x_fmt == "uint8"
    if asym and (v_zp0 is None or v_zp1 is None):
        raise ValueError("x_fmt='uint8' needs v_zp0 and v_zp1")
    # K is padded after the row statistics, so zeros never skew min/max
    pad = _k_pad(x.shape[-1], 1) if is_cuda(x) else 0
    x_q, x_scale, x_zp, x_rs = quantize_rows(x, x_fmt, k_pad=pad)
    if pad:
        w_q = _pad_k(w_q, pad)
    out = scaled_gemm(x_q, w_q, out_dtype, x_scale, w_scale, bias,
                      rs=x_rs, zp=x_zp, vz0=v_zp0 if asym else None,
                      vz1=v_zp1 if asym else None)
    return _add_lowrank(out, lowrank_u, lowrank_v, out_dtype)


def bf16_scaled_mm(x, w, x_scale=None, w_scale=None, bias=None,
                   out_dtype=torch.bfloat16, lowrank_u=None, lowrank_v=None):
    """16-bit scaled GEMM: bf16 multiplies, fp32 accumulate."""
    return scaled_mm(x.to(torch.bfloat16), w.to(torch.bfloat16), x_scale,
                     w_scale, bias, out_dtype=out_dtype, lowrank_u=lowrank_u,
                     lowrank_v=lowrank_v)
