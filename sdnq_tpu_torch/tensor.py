"""QTensor: a quantized parameter as a plain dataclass of tensors.

The same fields and metadata as the JAX package's ``QTensor``: codes in the
layer's natural orientation (linear (O, C)), scales and zero points
broadcast-ready against the grouped view in ``meta.quantized_shape``,
optional SVD factors.  Packed (non-native width) formats keep their codes
flattened to (lead, -1) and packed by ``packing.pack`` in the layout the JAX
package chooses: half-split for code widths below 8 whose row length
divides, else bit-plane.

A stacked QTensor (``models.dit.stack_dit_blocks``) carries a leading layer
axis on every array while ``meta`` describes one layer, as the JAX
package's stacked trees do.  ``layer_count`` tells the two apart by the
arrays' shapes, and ``layer_view(qt, i)`` is layer i: views of the stacked
storage, no copy (layer i of contiguous (L, ...) storage is itself
contiguous, so the kernels read it where it lies).

fp16 weights under a quantized matmul are stored as bf16, as in the JAX
package: the 16-bit GEMM flavour multiplies bf16, so storing what it
multiplies avoids a cast per call and keeps the bytes of both packages
equal.
"""

from __future__ import annotations

import dataclasses

import torch

from .formats import Format, get_format, default_matmul_format, torch_dtype
from .packing import halfsplit_planes, pack, unpack
from .quant.core import quantize_weight, random_bits
from .quant.hadamard import apply_hadamard, rotate_hadamard
from .quant.svd import apply_svdquant

__all__ = ["QuantMeta", "QTensor", "quantize_tensor", "dequantize",
           "auto_group_size", "negotiate_group_count", "qdata_shape",
           "layer_count", "layer_view"]

LINEAR, CONV, CONV_TRANSPOSE, EMBEDDING = (
    "linear", "conv", "conv_transpose", "embedding")


@dataclasses.dataclass(frozen=True)
class QuantMeta:
    """Static metadata for one quantized parameter."""

    fmt: str
    matmul_fmt: str
    layer_kind: str
    original_shape: tuple[int, ...]
    quantized_shape: tuple[int, ...]
    group_axis: int
    group_size: int               # -1 = channel-wise (no sub-groups)
    use_hadamard: bool
    hadamard_group_size: int
    svd_rank: int                 # 0 = no SVD correction
    use_quantized_matmul: bool
    re_quantize_for_matmul: bool  # storage cannot feed the matmul directly
    dequant_dtype: str = "bfloat16"
    pack_layout: str = "bitplane"  # packed formats: "bitplane"/"halfsplit"

    @property
    def format(self) -> Format:
        return get_format(self.fmt)

    @property
    def matmul_format(self) -> Format:
        return get_format(self.matmul_fmt)

    @property
    def is_packed(self) -> bool:
        return self.format.is_packed


@dataclasses.dataclass
class QTensor:
    qdata: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor | None
    svd_up: torch.Tensor | None
    svd_down: torch.Tensor | None
    meta: QuantMeta

    def dequantize(self, dtype=None, *, with_svd: bool = True,
                   with_hadamard: bool = True) -> torch.Tensor:
        return dequantize(self, dtype=dtype, with_svd=with_svd,
                          with_hadamard=with_hadamard)

    def nbytes(self) -> int:
        """Bytes of the stored arrays (codes, scales, zero points, SVD
        factors), as the JAX package's ``QTensor.nbytes``."""
        return sum(a.numel() * a.element_size()
                   for a in (self.qdata, self.scale, self.zero_point,
                             self.svd_up, self.svd_down) if a is not None)


def qdata_shape(meta: QuantMeta) -> tuple[int, ...]:
    """The shape of one layer's stored codes: ``quantized_shape``, or
    (rows, packed bytes) for a packed format in its layout."""
    if not meta.is_packed:
        return tuple(meta.quantized_shape)
    lead = meta.quantized_shape[0]
    flat_c = 1
    for d in meta.quantized_shape[1:]:
        flat_c *= d
    bits = meta.format.code_bits
    if meta.pack_layout == "halfsplit":
        return (lead, flat_c * bits // 8)
    return (lead, bits * ((flat_c + 7) // 8))


def layer_count(qt: QTensor) -> int | None:
    """L where the arrays carry a leading layer axis (a stacked QTensor),
    None where they hold one layer; raises where ``qdata`` fits neither."""
    one = qdata_shape(qt.meta)
    shape = tuple(qt.qdata.shape)
    if shape == one:
        return None
    if len(shape) == len(one) + 1 and shape[1:] == one:
        return shape[0]
    raise ValueError(f"QTensor codes {shape} fit neither one layer {one} "
                     f"nor a stack of them ({qt.meta.fmt}, "
                     f"{qt.meta.pack_layout})")


def layer_view(qt: QTensor, i: int) -> QTensor:
    """Layer i of a stacked QTensor: every array indexed on its leading
    axis, so each is a view of the stacked storage (no copy)."""
    def sel(a):
        return None if a is None else a[i]
    return QTensor(qdata=qt.qdata[i], scale=qt.scale[i],
                   zero_point=sel(qt.zero_point), svd_up=sel(qt.svd_up),
                   svd_down=sel(qt.svd_down), meta=qt.meta)


def auto_group_size(fmt: Format, layer_kind: str, has_svd: bool,
                    use_quantized_matmul: bool,
                    re_quantize_for_matmul: bool) -> int:
    if (use_quantized_matmul and not re_quantize_for_matmul
            and fmt.num_bits >= 6):
        return -1
    if layer_kind == LINEAR:
        return 2 ** ((3 if has_svd else 2) + fmt.num_bits)
    return 2 ** ((2 if has_svd else 1) + fmt.num_bits)


def negotiate_group_count(channel: int, group_size: int) -> tuple[int, int]:
    """Largest divisor-friendly (group_size, num_groups) <= requested."""
    if group_size >= channel:
        return channel, 1
    num = channel // group_size
    while num * group_size != channel:
        num -= 1
        if num <= 1:
            return channel, 1
        group_size = channel // num
    return group_size, num


def _grouped_view(w: torch.Tensor, layer_kind: str, group_size: int):
    """Reshape ``w`` so the reduction runs over a trailing group axis;
    returns (grouped, group_axis, reduction_dims, g, num_groups)."""
    if layer_kind == CONV and w.dim() > 2:
        o, c = w.shape[:2]
        g, num = (negotiate_group_count(c, group_size) if group_size > 0
                  else (c, 1))
        if num > 1:
            grouped = w.reshape(o, num, g, *w.shape[2:])
            return grouped, 2, (2,) + tuple(range(3, grouped.dim())), g, num
        return w, 1, (1,) + tuple(range(2, w.dim())), g, 1
    if layer_kind == CONV_TRANSPOSE and w.dim() > 2:
        c, o = w.shape[:2]
        g, num = (negotiate_group_count(c, group_size) if group_size > 0
                  else (c, 1))
        if num > 1:
            grouped = w.reshape(num, g, o, *w.shape[2:])
            return grouped, 1, (1,) + tuple(range(3, grouped.dim())), g, num
        return w, 0, (0,) + tuple(range(2, w.dim())), g, 1
    c = w.shape[-1]
    g, num = (negotiate_group_count(c, group_size) if group_size > 0
              else (c, 1))
    if num > 1:
        grouped = w.reshape(*w.shape[:-1], num, g)
        return grouped, grouped.dim() - 1, (grouped.dim() - 1,), g, num
    return w, w.dim() - 1, (w.dim() - 1,), g, 1


def quantize_tensor(w: torch.Tensor, fmt: str | Format = "int8",
                    layer_kind: str = LINEAR, *,
                    matmul_fmt: str | None = None, group_size: int = 0,
                    hadamard_group_size: int = 256, svd_rank: int = 32,
                    svd_steps: int = 8, use_svd: bool = False,
                    use_hadamard: bool = False,
                    use_quantized_matmul: bool = False,
                    use_stochastic_rounding: bool = False,
                    dequant_dtype: str = "bfloat16",
                    generator: torch.Generator | None = None,
                    svd_precomputed: bool = False) -> QTensor:
    """Quantize a weight into a QTensor on the weight's device.

    ``generator`` draws the SVD sketch (a generator seeded 0 when omitted)
    and, with ``use_stochastic_rounding``, the rounding noise.
    ``svd_precomputed`` marks a weight whose SVD residual the caller has
    already taken (the dynamic ladder): the automatic group size then
    follows the SVD rule, as the JAX package's does."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    mfmt = get_format(matmul_fmt or default_matmul_format(fmt.name))
    original_shape = tuple(w.shape)
    w = w.float()

    # can the stored representation feed the matmul directly?
    re_quantize = bool(
        fmt.num_bits > mfmt.num_bits
        or fmt.is_integer != mfmt.is_integer
        or (fmt.is_unsigned and not mfmt.is_integer)
        or (fmt.is_packed and not fmt.is_integer and not mfmt.is_integer
            and (fmt.num_bits >= mfmt.num_bits or fmt.max > mfmt.max)))
    if layer_kind == CONV_TRANSPOSE:
        use_quantized_matmul = False
    if use_hadamard:
        is_conv = layer_kind == CONV and w.dim() > 2
        w, use_hadamard, hadamard_group_size = apply_hadamard(
            w, hadamard_group_size, is_conv=is_conv)
    svd_up = svd_down = None
    if use_svd and w.dim() >= 2 and layer_kind != CONV_TRANSPOSE:
        w, svd_up, svd_down = apply_svdquant(
            w, rank=svd_rank, niter=svd_steps, generator=generator)
        svd_up = svd_up.to(torch_dtype(dequant_dtype))
        svd_down = svd_down.to(torch_dtype(dequant_dtype))
    if group_size == 0:
        group_size = auto_group_size(
            fmt, layer_kind, svd_up is not None or svd_precomputed,
            use_quantized_matmul, re_quantize)
    grouped, group_axis, red_dims, g, num = _grouped_view(
        w, layer_kind, group_size)
    re_quantize = re_quantize or num > 1
    sr_gen = generator if use_stochastic_rounding else None
    q, scale, zero_point = quantize_weight(grouped, fmt, dims=red_dims,
                                           generator=sr_gen)
    quantized_shape = tuple(q.shape)
    if (fmt.name == "float16" and use_quantized_matmul and not re_quantize
            and not fmt.is_packed):
        q = q.to(torch.bfloat16)
    pack_layout = "bitplane"
    if fmt.is_packed:
        flat = q.reshape(q.shape[0], -1)
        sr_bits = None
        if sr_gen is not None and not fmt.is_integer:
            sr_bits = random_bits(flat.shape, sr_gen)
        if fmt.code_bits < 8:
            pmax = max(8 // wd for wd, _ in halfsplit_planes(fmt.code_bits))
            if flat.shape[1] % pmax == 0:
                pack_layout = "halfsplit"
        q = pack(flat, fmt, sr_bits=sr_bits, layout=pack_layout)
    meta = QuantMeta(
        fmt=fmt.name, matmul_fmt=mfmt.name, layer_kind=layer_kind,
        original_shape=original_shape, quantized_shape=quantized_shape,
        group_axis=group_axis, group_size=g if num > 1 else -1,
        use_hadamard=bool(use_hadamard),
        hadamard_group_size=hadamard_group_size,
        svd_rank=svd_rank if svd_up is not None else 0,
        use_quantized_matmul=bool(use_quantized_matmul),
        re_quantize_for_matmul=bool(re_quantize),
        dequant_dtype=dequant_dtype, pack_layout=pack_layout)
    return QTensor(qdata=q, scale=scale.float(),
                   zero_point=None if zero_point is None
                   else zero_point.float(),
                   svd_up=svd_up, svd_down=svd_down, meta=meta)


def _unpacked_values(qt: QTensor) -> torch.Tensor:
    """Codes (or minifloat values) in the grouped shape, unpacked."""
    meta = qt.meta
    if not meta.is_packed:
        return qt.qdata
    flat_c = 1
    for d in meta.quantized_shape[1:]:
        flat_c *= d
    vals = unpack(qt.qdata, meta.format, flat_c, dtype=torch.float32,
                  layout=meta.pack_layout)
    return vals.reshape(meta.quantized_shape)


def dequantize(qt: QTensor, dtype=None, *, with_svd: bool = True,
               with_hadamard: bool = True) -> torch.Tensor:
    meta = qt.meta
    if dtype is None:
        dtype = torch_dtype(meta.dequant_dtype)
    w = _unpacked_values(qt).to(qt.scale.dtype) * qt.scale
    if qt.zero_point is not None:
        w = w + qt.zero_point
    w = w.reshape(meta.original_shape)
    if with_svd and qt.svd_up is not None:
        corr = (qt.svd_up.float() @ qt.svd_down.float()).reshape(
            meta.original_shape)
        w = w + corr.to(w.dtype)
    if with_hadamard and meta.use_hadamard:
        if meta.layer_kind == CONV and w.dim() > 2:
            shape = w.shape
            w = rotate_hadamard(w.reshape(shape[0], -1),
                                meta.hadamard_group_size).reshape(shape)
        else:
            w = rotate_hadamard(w, meta.hadamard_group_size)
    return w.to(dtype)
