"""Weight-only quantized matmul: float activations × int8/uint8 codes.

Kernel ``dequant_gemv`` (B2, ``csrc/dequant_gemv.cu``) beside its plain
version and a launch counter.  It replaces ``sdnq_tpu/kernels/dequant_mm.py``
``_dequant_mm_kernel`` in its unpacked rowwise ``row_epi`` mode: rowwise
scales commute with the K sum, so

    y = (x @ codesᵀ) * scale[o] + rowsum(x) * zp[o] + bias[o]

and the codes enter the dot as plain integers.  The layers under the
32-row cut-off take this route (at batch 1 the FLUX modulation linears and
the time / vector / guidance MLPs).  At M <= 32 it is a GEMV bound by the
bytes of the weight: each warp streams one weight row with 8-byte loads
and keeps every row's partial sum in registers.

More than 32 rows, grouped scales and packed codes are later slices: on
the card they raise, on the CPU they run the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._build import P, I
from .dispatch import is_cuda

__all__ = ["dequant_gemv", "dequant_gemv_plain", "dequant_matmul"]

# The GEMV kernel keeps every row's partial sum in registers.
GEMV_MAX_ROWS = 32


def dequant_gemv_plain(x, codes, scale, zp, bias, out_dtype):
    """Plain version of ``dequant_gemv``, in fp32: ``(x @ codesᵀ) * scale
    [+ rowsum(x) * zp] [+ bias]``."""
    xf = x.float()
    out = (xf @ codes.float().T) * scale.reshape(1, -1).float()
    if zp is not None:
        out = out + xf.sum(-1, keepdim=True) * zp.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(out_dtype)


def dequant_gemv(x, codes, scale, zp=None, bias=None,
                 out_dtype=torch.bfloat16):
    """Row-epilogue weight-only product for x (M, K), M <= 32 on the card;
    codes (O, K) int8 or uint8; scale / zp (O,) or (O, 1); bias (O,)."""
    if not is_cuda(x):
        return dequant_gemv_plain(x, codes, scale, zp, bias, out_dtype)
    m, k = x.shape
    o = codes.shape[0]
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(
            f"dequant_gemv takes 1..{GEMV_MAX_ROWS} rows, got {m}")
    if codes.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"dequant_gemv takes int8/uint8 codes, not "
                         f"{codes.dtype}")
    pad = (-k) % 8  # the kernel reads codes 8 at a time
    if pad:
        x = F.pad(x, (0, pad))
        codes = F.pad(codes, (0, pad))
    x, codes = x.contiguous(), codes.contiguous()
    scale = scale.reshape(-1).float().contiguous()
    zp = None if zp is None else zp.reshape(-1).float().contiguous()
    bias = None if bias is None else bias.reshape(-1).float().contiguous()
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    fn = _build.function("dequant_gemv", "sdnq_dequant_gemv",
                         [P, P, P, P, P, P, I, I, I, I, I, I, P])
    _build.check(fn(*(_build.ptr(t) for t in (x, codes, scale, zp, bias,
                                              out)),
                    m, k + pad, o, _build.act_kind(x.dtype),
                    int(codes.dtype == torch.uint8),
                    _build.act_kind(out_dtype), _build.stream(x)),
                 "dequant_gemv")
    dequant_gemv.launches += 1
    return out


dequant_gemv.launches = 0


def dequant_matmul(x, wq, scale, zero_point, bias, fmt, group_size: int,
                   out_dtype=torch.bfloat16):
    """y = x @ dequant(wq).T + bias for unpacked codes.

    x (M, K) float; wq (O, K) int8/uint8; scale / zero_point (O, G)
    groupwise along K; ``group_size`` the K span of one group."""
    if fmt.is_packed:
        raise NotImplementedError(
            f"{fmt.name}: packed weight-only matmul (the B2 packed mode and "
            "B5-B8) is a later slice of the port (ROADMAP queue A item 9)")
    m, kdim = x.shape
    o = wq.shape[0]
    groups = scale.shape[-1]
    if groups == 1:
        if is_cuda(x) and m > GEMV_MAX_ROWS:
            raise NotImplementedError(
                f"weight-only matmul on {m} rows: the card's B2 kernel takes "
                f"at most {GEMV_MAX_ROWS}; more rows are a later slice of "
                "the port (ROADMAP queue B, B2)")
        return dequant_gemv(x, wq, scale, zero_point, bias, out_dtype)
    if is_cuda(x):
        raise NotImplementedError(
            "grouped-scale weight-only matmul (B2 grouped mode) is a later "
            "slice of the port (ROADMAP queue B, B2)")
    g = group_size if group_size > 0 else kdim
    vals = wq.float().reshape(o, kdim // g, g) * scale[..., None]
    if zero_point is not None:
        vals = vals + zero_point[..., None]
    w = vals.reshape(o, kdim).to(x.dtype)
    out = x.float() @ w.float().T
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)
