"""Quantized linear forward.

``qlinear`` dispatches on the QTensor's metadata, as the JAX package's
``layers.qlinear`` does:

* quantized matmul (``meta.use_quantized_matmul`` and at least 32 rows):
  per-row activation quantization and the scaled GEMM
  (``kernels.scaled_mm.scaled_mm_fused_act``) for symmetric int8 and
  asymmetric uint8 weights (the uint8 zero-point algebra as two rank-1
  epilogue terms), fp8 and the 16-bit family.
  Packed integer codes in the half-split layout take the group-dot int8
  product (``kernels.dequant_mm.packed_int8_matmul``) where the JAX
  package's route does, else the weight is requantized rowwise first;
* weight-only (fewer rows, or no quantized matmul): ``kernels.dequant_mm.
  dequant_matmul`` (the row-epilogue GEMV for rowwise codes, the group-dot
  kernels for half-split codes);
* a trainable weight (``train.TrainQTensor``, ``train.DynamicTensor``)
  goes to ``train.train_qlinear`` / ``train.dynamic_qlinear``.

``qembedding`` gathers rows of an embedding table and, for a quantized
table, dequantizes only the gathered rows (no kernel in either package).

``qconv`` is the JAX package's quantized convolution.  Activations are NHWC
as in the JAX package (its TPU-native layout) and weights OIHW (the
checkpoints' order; (C_in, C_out, *k) for a transposed conv).  torch's
convolutions take (N, C, *spatial): ``x.movedim(-1, 1)`` is that view of
the NHWC memory (a channels_last tensor, no copy), cuDNN keeps the output
channels_last, and ``movedim(1, -1)`` returns it to NHWC, again without a
copy.  ``F.conv2d`` / ``F.conv_transpose2d`` stand for
``lax.conv_general_dilated`` / ``lax.conv_transpose``, which the JAX
package runs outside any Pallas kernel; their padding follows JAX's
("SAME", "VALID" or (lo, hi) pairs), with an explicit pad or crop where the
two sides differ.  Routes, as in JAX:

* weight-only (or an unquantized weight, or a transposed conv): the weight
  dequantized to x's dtype, one convolution, the bias added in x's dtype;
* quantized matmul (``meta.use_quantized_matmul``): im2col (``F.unfold``,
  features channel-major C·prod(k) like ``conv_general_dilated_patches``
  and the OIHW flatten), then the quantized-matmul GEMM (B1 + B4) from 32
  patch rows, else the weight-only product (B2); a grouped conv takes a
  batched product over its groups in plain torch (the JAX package's XLA
  batched ``dot_general``), in float64 where its operands are integer
  codes, so the sums are exact.

A Hadamard-rotated weight rotates the input instead.  SVD factors add
``(x @ downᵀ) @ upᵀ`` in plain torch: after the kernel in fp32 on the
quantized-matmul route; on the weight-only route in the factors' dtype,
with the bias folded in and the sum added to the kernel's rounded output,
at the JAX package's rounding points.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .envconfig import env_int
from .formats import torch_dtype
from .kernels.dequant_mm import (
    PACKED_MM_MAX_ROWS, dequant_matmul, packed_int8_matmul,
)
from .kernels import scaled_mm as _smm
from .kernels.scaled_mm import (
    bf16_scaled_mm, row_scale_from_amax, scaled_mm_fused_act,
)
from .quant.core import quantize_fp_mm, quantize_int_mm, quantize_uint_mm
from .quant.hadamard import rotate_hadamard
from .tensor import QTensor, dequantize

__all__ = ["qlinear", "qembedding", "qconv"]


def _min_matmul_rows() -> int:
    return env_int("SDNQ_TPU_MIN_MATMUL_ROWS", 32)


def _weight_as_int8(qt: QTensor):
    """Rowwise int8/uint8 codes -> (w_i8, w_scale (O, 1), w_zp or None).
    uint8 codes become int8 by xor 128, with the shift absorbed in zp."""
    q = qt.qdata
    if q.dim() > 2:
        q = q.reshape(q.shape[0], -1)
    scale = qt.scale.reshape(qt.scale.shape[0], -1)
    zp = (qt.zero_point.reshape(scale.shape)
          if qt.zero_point is not None else None)
    if q.dtype == torch.uint8:
        w_i8 = (q ^ 128).view(torch.int8)
        zp = (torch.zeros_like(scale) if zp is None else zp) + scale * 128.0
        return w_i8, scale, zp
    return q, scale, zp


def _requantize_rowwise(qt: QTensor, reduce=None):
    """Grouped storage -> rowwise matmul operands, dequantized without the
    SVD correction and without undoing the Hadamard rotation.  ``reduce``
    (a row-parallel shard's all-reduce, max, over the tensor axis): each
    row's statistics are taken over the whole row, and B1 quantizes the
    shard's columns against them (its given-scale and given-range modes),
    so that the codes are the whole rows'."""
    wd = dequantize(qt, dtype=torch.float32, with_svd=False,
                    with_hadamard=False)
    if wd.dim() > 2:
        wd = wd.reshape(wd.shape[0], -1)
    mfmt = qt.meta.matmul_format
    if reduce is not None:
        if mfmt.is_integer and mfmt.is_unsigned:
            w_q, s, zp, _ = _smm.quantize_rows(   # looked up at the call
                wd, "uint8", row_range=_given_row_range(wd, reduce))
            return w_q, s, zp
        amax = reduce(wd.abs().amax(-1))
        if mfmt.name in ("int8", "float8_e4m3fn"):
            w_q, s, _, _ = _smm.quantize_rows(
                wd, mfmt.name, row_scale=row_scale_from_amax(amax, mfmt.name))
            return w_q, s, None
        if mfmt.num_bits > 8:
            s = torch.clamp_min(amax.reshape(-1, 1), 2.0 ** -126)
            return (wd / s).to(torch.bfloat16), s, None
        raise ValueError(f"a row-parallel shard re-quantized to "
                         f"{mfmt.name} has no given-scale quantizer")
    if mfmt.is_integer:
        if mfmt.is_unsigned:
            return quantize_uint_mm(wd, -1)
        w_q, s = quantize_int_mm(wd, -1)
        return w_q, s, None
    if mfmt.num_bits == 8:
        w_q, s = quantize_fp_mm(wd, -1, fmt=mfmt)
        return w_q, s, None
    s = torch.clamp_min(wd.abs().amax(-1, keepdim=True), 2.0 ** -126)
    return (wd / s).to(torch.bfloat16), s, None


def _given_row_range(x2d, reduce):
    """The rows' (minima, maxima) over the whole rows where ``reduce`` (as
    ``x_amax_reduce``) is given: one all-reduce of (-min, max), exact."""
    if reduce is None:
        return None
    r = reduce(torch.stack([-x2d.amin(-1), x2d.amax(-1)]).float())
    return -r[0], r[1]


def _given_row_scale(x2d, x_amax_reduce, x_fmt):
    """The rows' scale where ``x_amax_reduce`` is given: the function of
    the rows' absolute maxima (M,) (taken in x's own dtype, exact) that
    returns the maxima to quantize by."""
    if x_amax_reduce is None:
        return None
    return row_scale_from_amax(x_amax_reduce(x2d.abs().amax(-1)), x_fmt)


def _quantized_matmul_2d(x2d, qt: QTensor, bias, out_dtype,
                         emit_quantized: bool = False, x_amax_reduce=None):
    """The quantized GEMM with its folds.  ``emit_quantized`` also returns
    the row-quantized (post-Hadamard) input as the training residual:
    ``(y, x_q, x_scale)``, or ``(y, x_q, x_scale, x_zp)`` for the
    asymmetric uint8 family (see ``scaled_mm_fused_act``).
    ``x_amax_reduce`` (a row-parallel shard's all-reduce, max, over the
    tensor axis) maps the rows' absolute maxima (uint8: their minima and
    maxima) to those the rows are quantized by, so that a shard's codes
    are the whole rows' (the 16-bit family quantizes none); a weight
    re-quantized for the matmul takes its rows' statistics so too."""
    meta = qt.meta
    mfmt = meta.matmul_format
    if meta.use_hadamard:
        x2d = rotate_hadamard(x2d, meta.hadamard_group_size)
    u = v = None
    if qt.svd_up is not None:
        u = x2d.float() @ qt.svd_down.float().T
        v = qt.svd_up.float().T
    if meta.re_quantize_for_matmul:
        if (meta.is_packed and mfmt.is_integer and not emit_quantized
                and x2d.shape[0] < PACKED_MM_MAX_ROWS):
            scale = qt.scale.reshape(qt.scale.shape[0], -1)
            zp = (qt.zero_point.reshape(scale.shape)
                  if qt.zero_point is not None else None)
            out = packed_int8_matmul(
                x2d, qt.qdata, scale, zp, bias, meta.format,
                x2d.shape[-1] // scale.shape[-1], out_dtype=out_dtype,
                pack_layout=meta.pack_layout)
            if out is not None:
                if u is not None:
                    out = (out.float() + u @ v).to(out_dtype)
                return out
        w_q, w_scale, w_zp = _requantize_rowwise(qt, x_amax_reduce)
    elif mfmt.is_integer:
        w_q, w_scale, w_zp = _weight_as_int8(qt)
    else:
        w_q = qt.qdata
        if w_q.dim() > 2:
            w_q = w_q.reshape(w_q.shape[0], -1)
        w_scale = qt.scale.reshape(qt.scale.shape[0], -1)
        w_zp = None

    if mfmt.is_integer:
        if w_zp is not None or mfmt.is_unsigned:
            # y += [rowsum(x_q)*x_s] ⊗ w_zp
            #      + x_zp ⊗ [colsum(w_q)*w_s + K*w_zp]
            kdim = x2d.shape[-1]
            wz = (torch.zeros((1, w_q.shape[0]), dtype=torch.float32,
                              device=w_q.device)
                  if w_zp is None else w_zp.reshape(1, -1))
            w_colsum = w_q.to(torch.int32).sum(-1)[None, :].float()
            return scaled_mm_fused_act(
                x2d, w_q, w_scale, bias, x_fmt="uint8", out_dtype=out_dtype,
                lowrank_u=u, lowrank_v=v, v_zp0=wz,
                v_zp1=w_colsum * w_scale.reshape(1, -1) + float(kdim) * wz,
                emit_quantized=emit_quantized,
                x_row_range=_given_row_range(x2d, x_amax_reduce))
        return scaled_mm_fused_act(
            x2d, w_q, w_scale, bias, x_fmt="int8", out_dtype=out_dtype,
            lowrank_u=u, lowrank_v=v, emit_quantized=emit_quantized,
            x_row_scale=_given_row_scale(x2d, x_amax_reduce, "int8"))
    if mfmt.num_bits == 8:
        return scaled_mm_fused_act(
            x2d, w_q.to(torch.float8_e4m3fn), w_scale, bias,
            x_fmt=mfmt.name, out_dtype=out_dtype, lowrank_u=u, lowrank_v=v,
            emit_quantized=emit_quantized,
            x_row_scale=_given_row_scale(x2d, x_amax_reduce, mfmt.name))
    if emit_quantized:
        raise ValueError("the 16-bit family has no quantized input to emit")
    return bf16_scaled_mm(x2d, w_q, None, w_scale, bias, out_dtype=out_dtype,
                          lowrank_u=u, lowrank_v=v)


def _svd_bias(x2d, qt: QTensor, bias):
    """(x @ downᵀ) @ upᵀ + bias, computed in the factors' dtype (the bias
    rounded to it too)."""
    dt = qt.svd_down.dtype
    corr = (x2d.to(dt) @ qt.svd_down.T) @ qt.svd_up.T
    if bias is not None:
        corr = corr + bias.to(dt)
    return corr


def _weight_only_linear_2d(x2d, qt: QTensor, bias, out_dtype):
    """Weight-only product; with Hadamard the input is rotated,
    x @ W_fullᵀ == (x·(I⊗H)) @ W_storedᵀ.  With SVD factors the kernel
    runs without the bias, and the (M, O) correction, bias folded in, is
    added to its output."""
    meta = qt.meta
    if meta.use_hadamard:
        x2d = rotate_hadamard(x2d, meta.hadamard_group_size)
    extra = _svd_bias(x2d, qt, bias) if qt.svd_up is not None else None
    scale = qt.scale.reshape(qt.scale.shape[0], -1)
    zp = (qt.zero_point.reshape(scale.shape)
          if qt.zero_point is not None else None)
    qd = qt.qdata
    if not meta.is_packed and qd.dim() > 2:
        qd = qd.reshape(qd.shape[0], -1)
    g_eff = x2d.shape[-1] // scale.shape[-1]
    out = dequant_matmul(x2d, qd, scale, zp,
                         None if extra is not None else bias, meta.format,
                         g_eff, out_dtype=out_dtype,
                         pack_layout=meta.pack_layout)
    if extra is not None:
        out = (out.float() + extra.float()).to(out_dtype)
    return out


def qlinear(x: torch.Tensor, w, bias: torch.Tensor | None = None,
            out_dtype=None, x_amax_reduce=None) -> torch.Tensor:
    """y = x @ w.T + bias with w a QTensor, a trainable weight
    (``TrainQTensor``: bf16 out whatever ``out_dtype``, as in the JAX
    package; ``DynamicTensor``) or a plain weight tensor.
    ``x_amax_reduce``: where the quantized matmul quantizes x's rows, the
    function that maps their absolute maxima (M,) to those they are
    quantized by (``_quantized_matmul_2d``; a QTensor's)."""
    kind = type(w).__name__
    if kind == "TrainQTensor":  # (a local import: train imports layers)
        from .train.matmul import train_qlinear
        return train_qlinear(x, w, bias, x_amax_reduce=x_amax_reduce)
    if kind == "DynamicTensor":
        if x_amax_reduce is not None:
            raise ValueError("a dynamic weight quantizes its input rows by "
                             "their own statistics: it takes no given "
                             "row maxima")
        from .train.matmul import dynamic_qlinear
        return dynamic_qlinear(x, w, bias)
    if not isinstance(w, QTensor):
        out_dtype = out_dtype or x.dtype
        out = F.linear(x, w.to(x.dtype)).float()
        if bias is not None:
            out = out + bias.float()
        return out.to(out_dtype)
    meta = w.meta
    out_dtype = out_dtype or torch_dtype(meta.dequant_dtype)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if meta.use_quantized_matmul and x2d.shape[0] >= _min_matmul_rows():
        out = _quantized_matmul_2d(x2d, w, bias, out_dtype,
                                   x_amax_reduce=x_amax_reduce)
    else:
        out = _weight_only_linear_2d(x2d, w, bias, out_dtype)
    return out.reshape(*lead, meta.original_shape[0])


def qembedding(ids: torch.Tensor, w, scale_multiplier: float | None = None,
               out_dtype=None) -> torch.Tensor:
    """Rows ``w[ids]`` of a plain or quantized (V, C) table; a QTensor's
    gathered codes, scales, zero points and SVD rows are dequantized alone,
    not the whole table."""
    if not isinstance(w, QTensor):
        out = w[ids]
        if scale_multiplier is not None:
            out = out * scale_multiplier
        return out
    meta = w.meta
    out_dtype = out_dtype or torch_dtype(meta.dequant_dtype)
    flat = ids.reshape(-1)
    sub = QTensor(
        qdata=w.qdata[flat], scale=w.scale[flat],
        zero_point=None if w.zero_point is None else w.zero_point[flat],
        svd_up=None if w.svd_up is None else w.svd_up[flat],
        svd_down=w.svd_down, meta=_row_meta(meta, flat.shape[0]))
    out = dequantize(sub, dtype=out_dtype)
    if scale_multiplier is not None:
        out = out * scale_multiplier
    return out.reshape(*ids.shape, out.shape[-1])


def _row_meta(meta, rows: int):
    """``meta`` for ``rows`` gathered rows of the table."""
    return dataclasses.replace(
        meta, original_shape=(rows,) + tuple(meta.original_shape[1:]),
        quantized_shape=(rows,) + tuple(meta.quantized_shape[1:]))


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

def _tuple(v, nd: int) -> tuple:
    return (v,) * nd if isinstance(v, int) else tuple(v)


def _conv_pads(padding, in_sizes, kernel, stride, dilation):
    """JAX's padding argument as (lo, hi) per spatial dim of a forward
    convolution ("SAME": out = ceil(in / stride), the odd pixel high)."""
    if not isinstance(padding, str):
        return [tuple(int(v) for v in p) for p in padding]
    mode = padding.upper()
    if mode == "VALID":
        return [(0, 0)] * len(in_sizes)
    if mode != "SAME":
        raise ValueError(f"padding {padding!r}")
    pads = []
    for n, k, st, d in zip(in_sizes, kernel, stride, dilation):
        total = max((-(-n // st) - 1) * st + d * (k - 1) + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_nc(xc, pads):
    """F.pad of an (N, C, *spatial) tensor by (lo, hi) per spatial dim
    (negative values crop)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(xc, flat)


def _padded(xc, pads):
    """(input, torch padding) for JAX's (lo, hi) pads: equal sides go to
    torch's padding argument, others are padded (or cropped) here."""
    if all(lo == hi >= 0 for lo, hi in pads):
        return xc, tuple(lo for lo, _ in pads)
    return _pad_nc(xc, pads), (0,) * len(pads)


def _conv_nhwc(x, wd, stride, padding, dilation, groups=1):
    """lax.conv_general_dilated on NHWC x and an OIHW weight."""
    nd = x.dim() - 2
    xc = x.movedim(-1, 1)
    xc, pad = _padded(xc, _conv_pads(padding, xc.shape[2:], wd.shape[2:],
                                     stride, dilation))
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    return conv(xc, wd, stride=stride, padding=pad, dilation=dilation,
                groups=groups).movedim(1, -1)


def _conv_transpose_nhwc(x, wd, stride, padding, dilation):
    """lax.conv_transpose(transpose_kernel=True) on NHWC x and the stored
    (C_in, C_out, *k) weight, which is torch's own layout for it.  The JAX
    function is a convolution of the stride-dilated x padded by (lo, hi);
    F.conv_transpose computes the one padded by k_eff - 1 on both sides, so
    its edges are cropped (or zero-extended) to JAX's padding."""
    nd = x.dim() - 2
    conv_t = (F.conv_transpose1d, F.conv_transpose2d,
              F.conv_transpose3d)[nd - 1]
    out = conv_t(x.movedim(-1, 1), wd, stride=stride, dilation=dilation)
    keff = [d * (k - 1) + 1 for k, d in zip(wd.shape[2:], dilation)]
    if isinstance(padding, str):
        mode = padding.upper()
        pads = []
        for k, st in zip(keff, stride):
            if mode == "SAME":
                total = k + st - 2
                lo = k - 1 if st > k - 1 else -(-total // 2)
            elif mode == "VALID":
                total, lo = k + st - 2 + max(k - st, 0), k - 1
            else:
                raise ValueError(f"padding {padding!r}")
            pads.append((lo, total - lo))
    else:
        pads = [tuple(int(v) for v in p) for p in padding]
    out = _pad_nc(out, [(lo - (k - 1), hi - (k - 1))
                        for (lo, hi), k in zip(pads, keff)])
    return out.movedim(1, -1)


def _patches(x, kshape, stride, padding, dilation):
    """lax.conv_general_dilated_patches on channels-last x of any spatial
    rank: (N, *out, C·prod(k)), features channel-major (c, *k), as the
    OIHW flatten of the weight.  x is padded (or cropped) as JAX pads it,
    then each spatial axis is cut into its dilated windows by ``unfold``."""
    nd = x.dim() - 2
    xc = _pad_nc(x.movedim(-1, 1), _conv_pads(padding, x.shape[1:-1],
                                              kshape, stride, dilation))
    for i, (k, st, d) in enumerate(zip(kshape, stride, dilation)):
        xc = xc.unfold(2 + i, d * (k - 1) + 1, st)[..., ::d]
    # (N, C, *out, *k) -> (N, *out, C, *k)
    out = xc.permute(0, *range(2, 2 + nd), 1, *range(2 + nd, 2 + 2 * nd))
    return out.reshape(*out.shape[:1 + nd], -1)


def _grouped_quantized_matmul(x2d, qt: QTensor, bias, out_dtype,
                              groups: int):
    """The JAX package's grouped quantized GEMM (M, G·CgK) × (O, CgK) ->
    (M, O), O = G·Og: per-group row quantization and a batched product
    over the groups, the zero-point algebra and SVD factors per group."""
    meta = qt.meta
    mfmt = meta.matmul_format
    m, o = x2d.shape[0], meta.original_shape[0]
    og, cgk = o // groups, x2d.shape[-1] // groups
    if meta.use_hadamard:
        x2d = rotate_hadamard(x2d.reshape(m * groups, cgk),
                              meta.hadamard_group_size).reshape(m, -1)
    xg = x2d.reshape(m, groups, cgk).transpose(0, 1)       # (G, M, CgK)
    if meta.re_quantize_for_matmul:
        w_q, w_scale, w_zp = _requantize_rowwise(qt)
    elif mfmt.is_integer:
        w_q, w_scale, w_zp = _weight_as_int8(qt)
    else:
        w_q = qt.qdata.reshape(qt.qdata.shape[0], -1)
        w_scale, w_zp = qt.scale.reshape(qt.scale.shape[0], -1), None
    wg = w_q.reshape(groups, og, cgk)
    ws = w_scale.reshape(groups, og, 1).transpose(1, 2).float()  # (G,1,Og)
    wz = (None if w_zp is None
          else w_zp.reshape(groups, og, 1).transpose(1, 2).float())

    def exact_bmm(a, b):  # integer codes: exact sums in float64
        return (a.double() @ b.double().transpose(1, 2)).float()

    if mfmt.is_integer:
        if wz is not None or mfmt.is_unsigned:
            x_q, x_scale, x_zp = quantize_uint_mm(xg.float(), -1)
            if wz is None:
                wz = torch.zeros((groups, 1, og), device=x2d.device)
            out = exact_bmm(x_q, wg) * x_scale * ws
            x_rowsum = x_q.to(torch.int32).sum(-1, keepdim=True).float()
            w_colsum = wg.to(torch.int32).sum(-1).float().reshape(
                groups, 1, og)
            out = out + x_rowsum * x_scale * wz
            out = out + x_zp * (w_colsum * ws + float(cgk) * wz)
        else:
            x_q, x_scale = quantize_int_mm(xg.float(), -1)
            out = exact_bmm(x_q, wg) * x_scale * ws
    elif mfmt.num_bits == 8:
        x_q, x_scale = quantize_fp_mm(xg.float(), -1, fmt=mfmt)
        out = (x_q.float() @ wg.to(torch.float8_e4m3fn).float()
               .transpose(1, 2)) * x_scale * ws
    else:
        out = (xg.to(torch.bfloat16).float()
               @ wg.to(torch.bfloat16).float().transpose(1, 2)) * ws
    if qt.svd_up is not None:
        t = xg.float() @ qt.svd_down.float().T                # (G, M, R)
        upg = qt.svd_up.float().reshape(groups, og, -1).transpose(1, 2)
        out = out + t @ upg
    if bias is not None:
        out = out + bias.float().reshape(groups, 1, og)
    return out.transpose(0, 1).reshape(m, o).to(out_dtype)


def _qconv_im2col(x, qt: QTensor, bias, stride, padding, dilation,
                  out_dtype, groups: int = 1):
    """im2col, then the quantized linear routes on the (M, C·prod(k))
    patch rows."""
    kshape = tuple(qt.meta.original_shape[2:])
    patches = _patches(x, kshape, stride, padding, dilation)
    lead = patches.shape[:-1]
    m2d = patches.reshape(-1, patches.shape[-1])
    use_mm = (qt.meta.use_quantized_matmul
              and m2d.shape[0] >= _min_matmul_rows())
    if groups > 1:
        if use_mm:
            out = _grouped_quantized_matmul(m2d, qt, bias, out_dtype, groups)
        else:
            cgk = m2d.shape[-1] // groups
            wd = dequantize(qt, dtype=torch.float32).reshape(groups, -1, cgk)
            xg = m2d.float().reshape(m2d.shape[0], groups, cgk).transpose(
                0, 1)
            out = (xg @ wd.transpose(1, 2)).transpose(0, 1).reshape(
                m2d.shape[0], -1)
            if bias is not None:
                out = out + bias.float()
            out = out.to(out_dtype)
    elif use_mm:
        out = _quantized_matmul_2d(m2d, qt, bias, out_dtype)
    else:
        out = _weight_only_linear_2d(m2d, qt, bias, out_dtype)
    return out.reshape(*lead, qt.meta.original_shape[0])


def qconv(x: torch.Tensor, w, bias: torch.Tensor | None = None, *,
          stride=1, padding="SAME", dilation=1, feature_group_count: int = 1,
          transpose: bool = False, out_dtype=None) -> torch.Tensor:
    """Convolution of NHWC ``x`` with a quantized or plain weight (OIHW;
    (C_in, C_out, *k) when ``transpose``).  A QTensor with
    ``use_quantized_matmul`` takes im2col and the quantized matmul (not
    when transposed); otherwise the weight is dequantized to x's dtype and
    convolved."""
    nd = x.dim() - 2
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    if isinstance(w, QTensor):
        out_dtype = out_dtype or torch_dtype(w.meta.dequant_dtype)
        if w.meta.use_quantized_matmul and not transpose:
            return _qconv_im2col(x, w, bias, stride, padding, dilation,
                                 out_dtype, feature_group_count)
        wd = dequantize(w, dtype=x.dtype)
    else:
        wd = w.to(x.dtype)
        out_dtype = out_dtype or x.dtype
    if transpose:
        out = _conv_transpose_nhwc(x, wd, stride, padding, dilation)
    else:
        out = _conv_nhwc(x, wd, stride, padding, dilation,
                         feature_group_count)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(out_dtype)
