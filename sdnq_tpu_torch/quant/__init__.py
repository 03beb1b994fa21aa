"""Quantization math, the Hadamard rotation and the SVD correction."""

from .core import (
    dequantize_values, get_scale_asymmetric, get_scale_symmetric,
    quantize_fp_mm, quantize_int_mm, quantize_uint_mm, quantize_weight,
)
from .hadamard import apply_hadamard, hadamard_matrix, rotate_hadamard
from .svd import apply_svdquant, svd_lowrank

__all__ = [
    "get_scale_symmetric", "get_scale_asymmetric", "quantize_weight",
    "dequantize_values", "quantize_int_mm", "quantize_uint_mm",
    "quantize_fp_mm",
    "apply_hadamard", "hadamard_matrix", "rotate_hadamard",
    "apply_svdquant", "svd_lowrank",
]
