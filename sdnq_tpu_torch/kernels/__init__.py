"""Hand-written Hopper kernels with their plain PyTorch versions.

Wrappers launch the CUDA kernel on CUDA tensors and run the plain version
on CPU tensors; each counts its launches in ``<wrapper>.launches``, and
``flash_attention``, ``flash_attention_block``, ``quantize_rows``,
``scaled_gemm``, ``dequant_gemv``,
``dequant_mm``, ``groupdot_mm``, ``blockdiag_mm``, ``groupdot_i8_mm``,
``decode_weight``, ``wgmma_mm`` and ``scaled_mm_tn`` also count their
launches per mode in
``<wrapper>.mode_launches``.  ``dequant_mm`` (B2's tiles), ``groupdot_mm``
(B5) and ``groupdot_i8_mm`` (B7) launch ``decode_weight`` and then
``wgmma_mm``.
"""

from . import dequant_mm as _dequant_mm
from .attention import (
    flash_attention, flash_attention_block, quantized_attention,
)
from .dequant_mm import (
    blockdiag_i8_mm, blockdiag_mm, dequant_gemv, dequant_matmul,
    groupdot_i8_mm, groupdot_mm, packed_int8_matmul,
)
# (the functions ``scaled_mm`` and ``dequant_mm`` stay in their modules, so
# that ``kernels.scaled_mm`` and ``kernels.dequant_mm`` name the modules)
from .scaled_mm import (
    bf16_scaled_mm, dynamic_mm_tn, quantize_rows, scaled_gemm,
    scaled_mm_fused_act, scaled_mm_tn,
)

# the launch-counted kernel wrappers of this package
KERNELS = {
    "quantize_rows": quantize_rows,
    "scaled_gemm": scaled_gemm,
    "dequant_gemv": dequant_gemv,
    "dequant_mm": _dequant_mm.dequant_mm,
    "decode_weight": _dequant_mm.decode_weight,
    "wgmma_mm": _dequant_mm.wgmma_mm,
    "flash_attention": flash_attention,
    "flash_attention_block": flash_attention_block,
    "groupdot_mm": groupdot_mm,
    "blockdiag_mm": blockdiag_mm,
    "groupdot_i8_mm": groupdot_i8_mm,
    "blockdiag_i8_mm": blockdiag_i8_mm,
    "scaled_mm_tn": scaled_mm_tn,
}
# the wrappers that also count their launches by mode
_MODED = ("flash_attention", "flash_attention_block", "quantize_rows",
          "scaled_gemm", "dequant_gemv", "dequant_mm", "groupdot_mm",
          "blockdiag_mm", "groupdot_i8_mm", "decode_weight", "wgmma_mm",
          "scaled_mm_tn")


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in _MODED:
        modes = KERNELS[name].mode_launches
        for mode in modes:
            modes[mode] = 0


def launch_counts() -> dict[str, int]:
    """Launches by wrapper, and ``<wrapper>:<mode>`` by mode (B3's masked,
    float_mask, causal, gqa, int8_pv (token mode), head_pv, its Q·K
    kind bf16_qk, int8_qk or e4m3_qk, padded (a head dim padded to the
    kernel's) and d256; B9's e4m3_qk, int8_pv and d256; B1's colscale and
    given_scale; B4's nn, bf16 and long (an int8 contraction of 2^17 or
    more, in parts); B10's parts and drain (its two long designs); B2's grouped and bit-plane GEMV and its e5m2 codes
    and fp16 x, and the grouped, row and bit-plane modes of its tiles and
    their fp16 x and e5m2 codes; B5's fp16 x; B5's and B6's multiplane and
    minifloat modes, B7's
    multiplane mode; the decode's grouped, row, bit-plane, half-split and
    int8 half-split modes and the GEMM's bias, row, fold and int8 fold
    epilogues)."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name in _MODED:
        counts.update({f"{name}:{mode}": n
                       for mode, n in KERNELS[name].mode_launches.items()})
    return counts


__all__ = [
    "KERNELS", "reset_launch_counts", "launch_counts", "quantize_rows",
    "scaled_gemm", "scaled_mm_fused_act", "bf16_scaled_mm",
    "dequant_gemv", "dequant_matmul", "flash_attention",
    "flash_attention_block", "quantized_attention", "groupdot_mm", "blockdiag_mm", "groupdot_i8_mm",
    "blockdiag_i8_mm", "packed_int8_matmul", "scaled_mm_tn",
    "dynamic_mm_tn",
]
