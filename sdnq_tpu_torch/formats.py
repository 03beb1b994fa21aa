"""Numeric format registry, as data, with torch storage dtypes.

The same closed-form rules as the JAX package's registry: every signed and
unsigned integer width 1..16 and 32, and every exponent/mantissa split of
finite (``fn``) signed and unsigned (``fnu``) microfloats from 1 to 16 bits.

  * int k:   [-2^(k-1), 2^(k-1)-1]
  * uint k:  [0, 2^k-1]  (packed uint9..15 advertise max = 2^k)
  * float eXmY "fn": bias = 2^(e-1) - 1, max = (2 - 2^-m) * 2^(2^e - 1 - bias)
  * unsigned float "fnu": same magnitude rule, min = 0.

``storage_dtype`` names the dtype of unpacked codes; ``torch_storage`` maps
it to a torch dtype.  Packed formats (non-native widths) keep their codes in
uint8 carriers laid out by ``packing`` (bit-plane or half-split).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

__all__ = [
    "Format",
    "FORMATS",
    "WEIGHTS_DTYPE_ORDER",
    "ACCEPTED_MATMUL_DTYPES",
    "ACCEPTED_WEIGHT_DTYPES",
    "get_format",
    "resolve_alias",
    "default_matmul_format",
    "torch_dtype",
]

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
}


def torch_dtype(name: str) -> torch.dtype:
    """Storage dtype name -> torch dtype."""
    return _TORCH_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Format:
    """Static description of one storage format."""

    name: str
    num_bits: int
    is_integer: bool
    is_unsigned: bool
    exponent: int  # exponent bits (0 for integers)
    mantissa: int  # mantissa bits (for ints: value bits excl. sign)
    min: float
    max: float
    is_packed: bool  # True -> stored as k-bit codes in bit-plane planes
    storage_dtype: str  # dtype of unpacked codes

    @property
    def bias(self) -> int:
        return (1 << (self.exponent - 1)) - 1 if self.exponent > 0 else 0

    @property
    def code_bits(self) -> int:
        """Bits needed for one code in the packed layout (packed uint9..15
        have 2^k + 1 levels, so they need k+1 bits)."""
        if self.is_integer and self.is_unsigned and self.is_packed:
            levels = int(self.max - self.min) + 1
            return (levels - 1).bit_length()
        return self.num_bits

    @property
    def sign_bits(self) -> int:
        return 0 if self.is_unsigned else 1

    @property
    def torch_storage(self) -> torch.dtype:
        return torch_dtype(self.storage_dtype)

    def __str__(self) -> str:  # pragma: no cover
        return self.name


def _float_max(e: int, m: int) -> float:
    bias = (1 << (e - 1)) - 1
    return float((2.0 - 2.0 ** (-m)) * 2.0 ** ((1 << e) - 1 - bias))


def _mkint(k: int) -> Format:
    native = k in (8, 16, 32)
    storage = f"int{k}" if native else ("int8" if k < 8 else "int32")
    return Format(
        name=f"int{k}", num_bits=k, is_integer=True, is_unsigned=False,
        exponent=0, mantissa=k - 1, min=float(-(1 << (k - 1))),
        max=float((1 << (k - 1)) - 1), is_packed=not native,
        storage_dtype=storage,
    )


def _mkuint(k: int) -> Format:
    native = k in (8, 16, 32)
    qmax = float(1 << k) if (not native and k > 8) else float((1 << k) - 1)
    storage = f"uint{k}" if native else ("uint8" if k < 8 else "int32")
    return Format(
        name=f"uint{k}", num_bits=k, is_integer=True, is_unsigned=True,
        exponent=0, mantissa=k, min=0.0, max=qmax, is_packed=not native,
        storage_dtype=storage,
    )


def _mkfloat(k: int, e: int, unsigned: bool) -> Format:
    m = k - e - (0 if unsigned else 1)
    suffix = "fnu" if unsigned else "fn"
    return Format(
        name=f"float{k}_e{e}m{m}{suffix}", num_bits=k, is_integer=False,
        is_unsigned=unsigned, exponent=e, mantissa=m,
        min=0.0 if unsigned else -_float_max(e, m), max=_float_max(e, m),
        is_packed=True, storage_dtype="int32",
    )


def _build_registry() -> dict[str, Format]:
    fmts: dict[str, Format] = {}

    def add(f: Format):
        fmts[f.name] = f

    # Native hardware formats.
    add(Format("float32", 32, False, False, 8, 23, -3.4028235e38,
               3.4028235e38, False, "float32"))
    add(Format("bfloat16", 16, False, False, 8, 7, -3.3895314e38,
               3.3895314e38, False, "bfloat16"))
    add(Format("float16", 16, False, False, 5, 10, -65504.0, 65504.0, False,
               "float16"))
    add(Format("float8_e4m3fn", 8, False, False, 4, 3, -448.0, 448.0, False,
               "float8_e4m3fn"))
    add(Format("float8_e5m2", 8, False, False, 5, 2, -57344.0, 57344.0,
               False, "float8_e5m2"))

    for k in list(range(2, 17)) + [32]:
        add(_mkint(k))
    for k in list(range(1, 17)) + [32]:
        add(_mkuint(k))
    # Signed microfloats: e in 1..5 with m = k-1-e >= 0.
    for k in range(2, 17):
        for e in range(1, min(5, k - 1) + 1):
            f = _mkfloat(k, e, unsigned=False)
            if f.name == "float8_e4m3fn":  # packed variant, full 480 range
                f = dataclasses.replace(f, name="float8_e4m3fn_sdnq")
            if f.name == "float8_e5m2":
                f = dataclasses.replace(f, name="float8_e5m2fn")
            add(f)
    # Unsigned microfloats: e in 1..5 with m = k-e >= 0.
    for k in range(1, 17):
        for e in range(1, min(5, k) + 1):
            add(_mkfloat(k, e, unsigned=True))
    return fmts


FORMATS: dict[str, Format] = _build_registry()

_ALIASES: dict[str, str] = {
    "fp32": "float32", "bf16": "bfloat16", "fp16": "float16",
    "fp8": "float8_e4m3fn",
    "int1": "uint1", "bool": "uint1", "fp1": "float1_e1m0fnu",
}
for _k, _e in [(15, 5), (14, 5), (13, 5), (12, 5), (11, 5), (10, 5), (9, 4),
               (7, 3), (6, 3), (5, 2), (4, 2), (3, 1), (2, 1)]:
    _ALIASES[f"fp{_k}"] = f"float{_k}_e{_e}m{_k - 1 - _e}fn"
for _k, _e in [(16, 5), (15, 5), (14, 5), (13, 5), (12, 5), (11, 5), (10, 5),
               (9, 4), (8, 4), (7, 3), (6, 3), (5, 2), (4, 2), (3, 1), (2, 1),
               (1, 1)]:
    _ALIASES[f"ufp{_k}"] = f"float{_k}_e{_e}m{_k - _e}fnu"


def resolve_alias(name: str) -> str:
    return _ALIASES.get(name, name)


@lru_cache(maxsize=None)
def get_format(name: str) -> Format:
    resolved = resolve_alias(name)
    if resolved not in FORMATS:
        raise KeyError(f"unknown SDNQ format: {name!r}")
    return FORMATS[resolved]


# Formats a quantized matmul can take as its operand type.
ACCEPTED_MATMUL_DTYPES = frozenset(
    {"int8", "uint8", "fp8", "float8_e4m3fn", "fp16", "float16"}
)


def _build_dtype_order() -> list[str]:
    """Accuracy-ordered ladder for dynamic per-layer format selection: bit
    widths ascending; within a width signed int, signed floats (native
    first, then by ascending exponent), unsigned int, unsigned floats."""
    order: list[str] = ["uint1", "float1_e1m0fnu"]
    for k in range(2, 17):
        order.append(f"int{k}")
        if k == 8:
            order.extend(["float8_e4m3fn", "float8_e5m2"])
        if k == 16:
            order.append("float16")
        for e in range(1, min(5, k - 1) + 1):
            name = f"float{k}_e{e}m{k - 1 - e}fn"
            if name == "float8_e4m3fn":
                name = "float8_e4m3fn_sdnq"
            order.append(name)
        order.append(f"uint{k}")
        for e in range(1, min(5, k) + 1):
            order.append(f"float{k}_e{e}m{k - e}fnu")
    return order


WEIGHTS_DTYPE_ORDER: list[str] = _build_dtype_order()

ACCEPTED_WEIGHT_DTYPES = frozenset(FORMATS.keys()) | frozenset(_ALIASES.keys())


def default_matmul_format(weights_fmt: str) -> str:
    """Default matmul operand format for a storage format."""
    f = get_format(weights_fmt)
    if f.is_integer:
        return "uint8" if f.name == "uint8" else "int8"
    if f.num_bits < 16:
        return "float8_e4m3fn"
    return "float16"
