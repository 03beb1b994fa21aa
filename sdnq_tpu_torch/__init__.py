"""sdnq_tpu_torch: the PyTorch/CUDA port of sdnq_tpu for NVIDIA Hopper.

The JAX package ``sdnq_tpu`` stays the reference; this package keeps its
module names and holds itself to it.  Plain tensor code is PyTorch; every
Pallas kernel of the ported paths is a hand-written CUDA kernel for sm_90a
under ``csrc/``, built on first use (``kernels._build``), with a plain
PyTorch version beside it that runs on CPU tensors.  Importing the package
builds and launches nothing.
"""

__version__ = "0.1.0"

from .formats import (
    ACCEPTED_MATMUL_DTYPES,
    FORMATS,
    WEIGHTS_DTYPE_ORDER,
    Format,
    default_matmul_format,
    get_format,
    resolve_alias,
)
from .config import QuantConfig
from .tensor import QTensor, QuantMeta, dequantize, quantize_tensor
from .dynamic import quantization_loss, quantize_tensor_dynamic
from .apply import dequantize_model, model_memory_footprint, quantize_model
from .layers import qconv, qembedding, qlinear
from .options import apply_options_to_model, requantize_model

__all__ = [
    "FORMATS",
    "WEIGHTS_DTYPE_ORDER",
    "ACCEPTED_MATMUL_DTYPES",
    "Format",
    "get_format",
    "resolve_alias",
    "default_matmul_format",
    "QuantConfig",
    "QTensor",
    "QuantMeta",
    "quantize_tensor",
    "dequantize",
    "quantize_tensor_dynamic",
    "quantization_loss",
    "quantize_model",
    "dequantize_model",
    "model_memory_footprint",
    "qlinear",
    "qconv",
    "qembedding",
    "apply_options_to_model",
    "requantize_model",
    "__version__",
]
