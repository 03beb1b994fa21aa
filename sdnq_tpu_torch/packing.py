"""Bit-packing codecs for sub-byte and non-native-width storage.

The JAX package's ``packing`` over torch tensors, byte for byte: a file
packed by either package unpacks in the other.

Layouts
-------
* **bit-plane** (any width 1..16): the last axis (length C, padded to a
  multiple of 8) is stored as ``num_bits`` planes of C/8 bytes each,
  concatenated, in segment-major order — plane j, byte b, bit i is bit j of
  ``code[..., i * C/8 + b]``.
* **half-split** (widths 1..8, the matmul layout of the packed kernels):
  for a width that divides 8, byte b packs ``p = 8 / num_bits`` codes in
  ascending bit fields, field t of byte b being ``code[t * C/p + b]``.
  Widths 3/5/6/7 store their binary decomposition (6 = 4 + 2: ``code >> 2``
  in a 4-bit plane, ``code & 3`` in a 2-bit plane) as half-split planes
  concatenated along the last axis.

Signed integers are stored offset-binary (``q - fmt.min``).  Float codes go
through the finite-minifloat codec below (sign | exponent | mantissa, RTNE,
subnormals, optional stochastic-rounding bits fed in).

torch has no unsigned 32-bit arithmetic, so codes and float bits live in
int32 (or int64 where a full 32-bit unsigned value must stay positive);
every shift below is either of a non-negative value or masked after it.
"""

from __future__ import annotations

import torch

from .formats import Format

__all__ = [
    "pad_to_multiple",
    "pack_codes",
    "unpack_codes",
    "halfsplit_planes",
    "pack_codes_halfsplit",
    "unpack_codes_halfsplit",
    "encode_float",
    "decode_float",
    "pack",
    "unpack",
    "quantize_to_float_format",
]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pack_codes(codes: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Non-negative integer codes (< 2**num_bits, at most 16 bits) (..., C)
    -> segment-major bit-planes, uint8 (..., num_bits * ceil(C/8))."""
    c = codes.shape[-1]
    cpad = pad_to_multiple(c, 8)
    codes = codes.to(torch.int32)
    if cpad != c:
        codes = torch.nn.functional.pad(codes, (0, cpad - c))
    segs = codes.reshape(*codes.shape[:-1], 8, cpad // 8)
    planes = []
    for j in range(num_bits):
        bits = (segs >> j) & 1                        # (..., 8, C/8)
        byte = torch.zeros(segs.shape[:-2] + (cpad // 8,), dtype=torch.int32,
                           device=codes.device)
        for i in range(8):
            byte = byte | (bits[..., i, :] << i)
        planes.append(byte.to(torch.uint8))
    return torch.cat(planes, dim=-1)


def unpack_codes(packed: torch.Tensor, num_bits: int, c: int,
                 out_dtype=torch.int32) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (..., c) codes."""
    cpad = pad_to_multiple(c, 8)
    nbytes = cpad // 8
    planes = packed.reshape(*packed.shape[:-1], num_bits, nbytes) \
        .to(out_dtype)
    segs = []
    for i in range(8):
        seg = None
        for j in range(num_bits):
            bit = (planes[..., j, :] >> i) & 1
            seg = bit if seg is None else seg | (bit << j)
        segs.append(seg)
    return torch.cat(segs, dim=-1)[..., :c]


def halfsplit_planes(num_bits: int) -> list[tuple[int, int]]:
    """The set bits of ``num_bits`` in {8, 4, 2, 1}, most significant first,
    as ``(width, shift)`` field planes of the half-split layout."""
    planes, shift = [], num_bits
    for w in (8, 4, 2, 1):
        if num_bits & w:
            shift -= w
            planes.append((w, shift))
    return planes


def pack_codes_halfsplit(codes: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Half-split layout for widths 1..8 (module docstring).

    codes: (..., C) non-negative ints < 2**num_bits, C divisible by
    8 / (narrowest plane width).  Returns uint8 (..., C * num_bits / 8)."""
    if not 1 <= num_bits <= 8:
        raise ValueError(f"half-split packs widths 1..8, not {num_bits}")
    c = codes.shape[-1]
    codes = codes.to(torch.int32)
    outs = []
    for w, shift in halfsplit_planes(num_bits):
        field = (codes >> shift) & ((1 << w) - 1)
        p = 8 // w
        if c % p:
            raise ValueError(f"half-split needs C % {p} == 0, got C = {c}")
        seg = c // p
        parts = field.reshape(*codes.shape[:-1], p, seg)
        byte = torch.zeros(codes.shape[:-1] + (seg,), dtype=torch.int32,
                           device=codes.device)
        for t in range(p):
            byte = byte | (parts[..., t, :] << (w * t))
        outs.append(byte.to(torch.uint8))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def unpack_codes_halfsplit(packed: torch.Tensor, num_bits: int, c: int,
                           out_dtype=torch.int32) -> torch.Tensor:
    """Inverse of :func:`pack_codes_halfsplit`."""
    code = None
    off = 0
    for w, shift in halfsplit_planes(num_bits):
        p = 8 // w
        seg = c // p
        b = packed[..., off:off + seg].to(out_dtype)
        off += seg
        mask = (1 << w) - 1
        parts = [(b >> (w * t)) & mask for t in range(p)]
        field = torch.cat(parts, dim=-1)[..., :c] << shift
        code = field if code is None else code | field
    return code


# ---------------------------------------------------------------------------
# Finite minifloat codec (sign | e exponent bits | m mantissa bits)
# ---------------------------------------------------------------------------

def encode_float(x: torch.Tensor, fmt: Format,
                 sr_bits: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 values (already clamped to [fmt.min, fmt.max]) -> int32 codes of
    ``fmt.num_bits`` bits.

    Round to nearest even on the mantissa cut; values below the smallest
    normal go to the scaled-linear subnormal codes; ``sr_bits`` (uniform
    32-bit values, any integer dtype holding them) switch to stochastic
    rounding, as the JAX package's uint32 bits do."""
    e, m, bias = fmt.exponent, fmt.mantissa, fmt.bias
    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    # The sign is bit 31: an arithmetic shift of int32 smears it over the
    # word, the mask keeps one bit (the JAX package shifts a uint32).
    sign = (bits >> 31) & 1
    abs_bits = bits & 0x7FFFFFFF

    shift = 23 - m
    sr = None
    if sr_bits is not None:
        sr = sr_bits.to(torch.int64) & 0xFFFFFFFF     # the uint32 value
        jitter = (sr & ((1 << shift) - 1)).to(torch.int32)
        rounded = (abs_bits + jitter) >> shift
    else:
        lsb = (abs_bits >> shift) & 1
        rounded = (abs_bits + ((1 << (shift - 1)) - 1) + lsb) >> shift
    exp_mant = rounded                # biased-127 exponent in the high bits
    code = exp_mant - ((127 - bias) << m)

    # subnormal / underflow: linear code round(|x| / 2^(1-bias-m))
    sub_rel = x.abs() * (2.0 ** (bias - 1 + m))
    if sr is not None:
        u = (sr >> 8).to(torch.float32) * (2.0 ** -24)
        sub_code = torch.floor(sub_rel + u).to(torch.int32)
    else:
        sub_code = torch.round(sub_rel).to(torch.int32)   # half to even
    is_sub = exp_mant < ((127 - bias + 1) << m)
    code = torch.where(is_sub, sub_code, code)

    max_code = ((1 << e) - 1 << m) | ((1 << m) - 1)
    code = torch.clamp(code, 0, max_code)
    if not fmt.is_unsigned:
        code = code | (sign << (e + m))
    return code


def decode_float(code: torch.Tensor, fmt: Format,
                 dtype=torch.float32) -> torch.Tensor:
    """Integer codes -> floating point values, exactly.

    For e <= 7 the exponent|mantissa field is placed into the fp32 slots
    with one shift and add; the subnormal codes then read as
    ``2^-bias * (1 + mant/2^m)`` and one multiply-add fixes them."""
    e, m, bias = fmt.exponent, fmt.mantissa, fmt.bias
    code = code.to(torch.int32)
    if not fmt.is_unsigned:
        sign = (code >> (e + m)) & 1
        mag = code & ((1 << (e + m)) - 1)
    else:
        sign = None
        mag = code
    if e <= 7:
        raw = ((mag << (23 - m)) + ((127 - bias) << 23)).view(torch.float32)
        val = torch.where(mag < (1 << m),
                          2.0 * raw - 2.0 ** (1 - bias), raw)
    else:
        exp_field = mag >> m
        mant = (mag & ((1 << m) - 1)).to(torch.float32)
        normal = (1.0 + mant * 2.0 ** -m) * torch.exp2(
            (exp_field - bias).to(torch.float32))
        subnormal = mant * 2.0 ** (1 - bias - m)
        val = torch.where(exp_field == 0, subnormal, normal)
    if sign is not None:
        val = torch.where(sign == 1, -val, val)
    return val.to(dtype)


def quantize_to_float_format(x: torch.Tensor, fmt: Format) -> torch.Tensor:
    """fp32 values rounded to the representable set of ``fmt``: encoded,
    then decoded (the JAX package's ``quantize_to_float_format``)."""
    return decode_float(encode_float(x, fmt), fmt)


# ---------------------------------------------------------------------------
# pack / unpack as the quantizer uses them
# ---------------------------------------------------------------------------

def pack(q: torch.Tensor, fmt: Format, sr_bits: torch.Tensor | None = None,
         layout: str = "bitplane") -> torch.Tensor:
    """Quantized values -> packed uint8 storage.  Integers (possibly
    negative) are stored offset-binary; floats (fp32, in range) are encoded
    through the minifloat codec first.  ``layout``: "bitplane" or
    "halfsplit"."""
    if not fmt.is_packed:
        raise ValueError(f"{fmt.name} is not a packed format")
    if fmt.is_integer:
        codes = q.to(torch.int32) - int(fmt.min)
    else:
        codes = encode_float(q, fmt, sr_bits=sr_bits)
    if layout == "halfsplit":
        return pack_codes_halfsplit(codes, fmt.code_bits)
    return pack_codes(codes, fmt.code_bits)


def unpack(packed: torch.Tensor, fmt: Format, c: int, dtype=torch.float32,
           layout: str = "bitplane") -> torch.Tensor:
    """Packed storage -> quantized values: integers as signed values, floats
    decoded, both in ``dtype``."""
    if layout == "halfsplit":
        codes = unpack_codes_halfsplit(packed, fmt.code_bits, c)
    else:
        codes = unpack_codes(packed, fmt.code_bits, c)
    if fmt.is_integer:
        return (codes + int(fmt.min)).to(dtype)
    return decode_float(codes, fmt, dtype=dtype)
