"""Quantization math on torch tensors.

The same numerics as the JAX package's ``quant.core``: absmax / (max-min)
scales with a 2**-126 floor, true division by the scale, round half to
even (``torch.round``), clip to the format's range.  Stochastic rounding of
integer codes takes an explicit ``torch.Generator``; float formats round
stochastically on uniform 32-bit values, drawn from the generator or fed
in (``sr_bits``), so tests can give both packages the same bits.
"""

from __future__ import annotations

import torch

from ..formats import Format, get_format
from ..packing import decode_float, encode_float

__all__ = [
    "get_scale_symmetric",
    "get_scale_asymmetric",
    "quantize_weight",
    "dequantize_values",
    "quantize_int_mm",
    "quantize_uint_mm",
    "quantize_fp_mm",
]

# Floor for all-zero groups, so that scale == 0 never produces NaN.
SCALE_EPS = 2.0 ** -126


def _fmt(fmt: Format | str) -> Format:
    return get_format(fmt) if isinstance(fmt, str) else fmt


def _amax(w: torch.Tensor, dims) -> torch.Tensor:
    return torch.amax(torch.abs(w), dim=dims, keepdim=True)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as a true division.  (A Python-scalar divisor on a CUDA tensor
    becomes a multiply by its reciprocal, one ulp off on some values; the
    kernels and the JAX package divide.)"""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def get_scale_symmetric(w: torch.Tensor, dims, fmt: Format) -> torch.Tensor:
    """absmax / qmax over ``dims`` (kept)."""
    return torch.clamp_min(_div(_amax(w, dims), fmt.max), SCALE_EPS)


def get_scale_asymmetric(w: torch.Tensor, dims, fmt: Format):
    """(scale, zero_point): scale = (max-min)/(qmax-qmin),
    zero_point = min - scale*qmin."""
    wmin = torch.amin(w, dim=dims, keepdim=True)
    wmax = torch.amax(w, dim=dims, keepdim=True)
    scale = torch.clamp_min(_div(wmax - wmin, fmt.max - fmt.min), SCALE_EPS)
    zero_point = wmin - scale * fmt.min
    return scale, zero_point


def _round(q: torch.Tensor, generator: torch.Generator | None):
    if generator is None:
        return torch.round(q)
    # stochastic rounding: 0.1 * N(0, 1) jitter, then round
    noise = torch.randn(q.shape, generator=generator, device=q.device,
                        dtype=q.dtype)
    return torch.round(q + 0.1 * noise)


def _stochastic_fp(q: torch.Tensor, mantissa: int,
                   sr_bits: torch.Tensor) -> torch.Tensor:
    """fp32 values cut to ``mantissa`` bits after adding the low bits of
    ``sr_bits`` below the cut: stochastic rounding of the mantissa (the
    JAX package's ``quantize_fp_mm`` with a key)."""
    shift = 23 - mantissa
    jitter = (sr_bits.to(torch.int64) & ((1 << shift) - 1)).to(torch.int32)
    iq = (q.float().contiguous().view(torch.int32) + jitter) & -(1 << shift)
    return iq.view(torch.float32)


def quantize_weight(w: torch.Tensor, fmt: Format | str, dims=-1, *,
                    generator: torch.Generator | None = None,
                    sr_bits: torch.Tensor | None = None):
    """Quantize ``w`` to ``fmt`` with per-``dims`` scales.

    Returns ``(q, scale, zero_point)``: integer codes in the format's
    storage dtype (int32 for packed integer widths), fp8 values for the
    native fp8 formats, fp32 values on the format's grid for packed
    minifloats; ``zero_point`` is None for signed formats.  With a
    generator, integer codes round stochastically; float formats round
    stochastically on uniform 32-bit values (``sr_bits`` of w's shape, or
    drawn from the generator): the packed minifloats in their codec, the
    native fp8 formats by cutting the fp32 mantissa after adding the bits
    below the cut (the JAX package's ``quantize_weight`` ignores its key
    for native fp8 and rounds to nearest; its ``quantize_fp_mm`` is the
    rule followed here).
    """
    fmt = _fmt(fmt)
    w = w.float()
    if fmt.is_unsigned:
        scale, zero_point = get_scale_asymmetric(w, dims, fmt)
        q = (w - zero_point) / scale
    else:
        scale = get_scale_symmetric(w, dims, fmt)
        zero_point = None
        q = w / scale
    if fmt.is_integer:
        q = torch.clamp(_round(q, generator), fmt.min, fmt.max)
        q = q.to(torch.int32 if fmt.is_packed else fmt.torch_storage)
    else:
        if sr_bits is None and generator is not None:
            sr_bits = random_bits(q.shape, generator)
        if fmt.is_packed:
            q = torch.nan_to_num(torch.clamp(q, fmt.min, fmt.max))
            q = decode_float(encode_float(q, fmt, sr_bits=sr_bits), fmt)
        else:
            if sr_bits is not None:
                q = _stochastic_fp(q, fmt.mantissa, sr_bits)
            q = torch.nan_to_num(torch.clamp(q, fmt.min, fmt.max))
            q = q.to(fmt.torch_storage)
    return q, scale, zero_point


def dequantize_values(q: torch.Tensor, scale: torch.Tensor,
                      zero_point: torch.Tensor | None = None,
                      dtype=torch.float32) -> torch.Tensor:
    """q * scale (+ zero_point), q taken in the scale's dtype and the
    scales broadcast against q; the result in ``dtype``."""
    out = q.to(scale.dtype) * scale
    if zero_point is not None:
        out = out + zero_point
    return out.to(dtype)


def random_bits(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform 32-bit values (as int64) for stochastic float rounding."""
    return torch.randint(0, 1 << 32, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int64)


def quantize_int_mm(x: torch.Tensor, dims=-1, fmt: Format | str = "int8",
                    generator: torch.Generator | None = None):
    """Symmetric per-row int8 codes and scales for a matmul operand."""
    fmt = _fmt(fmt)
    x = x.float()
    scale = get_scale_symmetric(x, dims, fmt)
    q = torch.clamp(_round(x / scale, generator), fmt.min, fmt.max)
    return q.to(torch.int8), scale


def quantize_uint_mm(x: torch.Tensor, dims=-1, fmt: Format | str = "uint8",
                     generator: torch.Generator | None = None):
    """Asymmetric per-row quantization against the SIGNED range of the same
    width: int8 codes with x = q*scale + zero_point, so the operand feeds a
    signed int8 product."""
    fmt = _fmt(fmt)
    signed_fmt = get_format(f"int{fmt.num_bits}")
    x = x.float()
    scale, zero_point = get_scale_asymmetric(x, dims, signed_fmt)
    q = _round((x - zero_point) / scale, generator)
    q = torch.clamp(q, signed_fmt.min, signed_fmt.max)
    return q.to(torch.int8), scale, zero_point


def quantize_fp_mm(x: torch.Tensor, dims=-1,
                   fmt: Format | str = "float8_e4m3fn"):
    """Symmetric per-row fp8 values and scales for a matmul operand."""
    fmt = _fmt(fmt)
    x = x.float()
    scale = get_scale_symmetric(x, dims, fmt)
    q = torch.nan_to_num(torch.clamp(x / scale, fmt.min, fmt.max))
    return q.to(fmt.torch_storage), scale
