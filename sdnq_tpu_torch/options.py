"""Re-target quantization options on an already-quantized model.

The JAX package's ``options``: ``apply_options_to_model`` changes static
metadata alone (the dequant dtype, whether the quantized matmul runs), so
the stored tensors are shared with the input tree; ``requantize_model``
dequantizes every QTensor and quantizes it again to another storage format
(lossy with respect to the original weights).
"""

from __future__ import annotations

import dataclasses

import torch

from .apply import _map_with_paths
from .tensor import QTensor, dequantize, quantize_tensor

__all__ = ["apply_options_to_model", "requantize_model"]


def apply_options_to_model(params, *, use_quantized_matmul: bool | None = None,
                           dequant_dtype: str | None = None):
    """The tree with each QTensor's meta changed as asked (no data
    moves)."""
    changes = {}
    if use_quantized_matmul is not None:
        changes["use_quantized_matmul"] = bool(use_quantized_matmul)
    if dequant_dtype is not None:
        changes["dequant_dtype"] = dequant_dtype

    def leaf(_, w):
        if not isinstance(w, QTensor) or not changes:
            return w
        return dataclasses.replace(w, meta=dataclasses.replace(w.meta,
                                                               **changes))
    return _map_with_paths(params, leaf)


def requantize_model(params, weights_dtype: str, *,
                     generator: torch.Generator | None = None, **overrides):
    """Every QTensor dequantized to fp32 and quantized to
    ``weights_dtype``, keeping its layer kind, Hadamard, SVD rank, matmul
    and dequant settings unless ``overrides`` name them."""
    def leaf(_, w):
        if not isinstance(w, QTensor):
            return w
        meta = w.meta
        kw = dict(matmul_fmt=None, group_size=0,
                  hadamard_group_size=meta.hadamard_group_size,
                  use_svd=meta.svd_rank > 0, svd_rank=meta.svd_rank or 32,
                  use_hadamard=meta.use_hadamard,
                  use_quantized_matmul=meta.use_quantized_matmul,
                  dequant_dtype=meta.dequant_dtype)
        kw.update(overrides)
        return quantize_tensor(dequantize(w, torch.float32), weights_dtype,
                               meta.layer_kind, generator=generator, **kw)
    return _map_with_paths(params, leaf)
