"""Inference <-> training model conversion.

``convert_model_to_training``: SVD factors are baked back into the
quantized weight (the optimizer's requantization keeps the tree's structure,
and a randomized SVD per step would dominate the step), Hadamard is kept,
conv / embedding QTensors become plain tensors (only linear layers train
quantized), then ``make_train_params``.
``convert_training_model_to_inference`` strips the TrainQTensor wrappers.
"""

from __future__ import annotations

import torch

from ..tensor import QTensor, dequantize, quantize_tensor
from ..tree import tree_map
from .matmul import TrainQTensor, make_train_params

__all__ = ["convert_model_to_training", "convert_training_model_to_inference"]


def convert_model_to_training(params, generator: torch.Generator | None = None):
    def conv(leaf):
        if not isinstance(leaf, QTensor):
            return leaf
        meta = leaf.meta
        if meta.layer_kind != "linear":
            return dequantize(leaf)
        if meta.svd_rank > 0:
            w = dequantize(leaf, torch.float32)
            leaf = quantize_tensor(
                w, meta.fmt, meta.layer_kind, matmul_fmt=meta.matmul_fmt,
                group_size=meta.group_size,
                hadamard_group_size=meta.hadamard_group_size,
                use_svd=False, use_hadamard=meta.use_hadamard,
                use_quantized_matmul=meta.use_quantized_matmul,
                dequant_dtype=meta.dequant_dtype, generator=generator)
        return leaf
    stripped = tree_map(conv, params, is_leaf=lambda x: isinstance(x, QTensor))
    return make_train_params(stripped)


def convert_training_model_to_inference(params):
    def conv(leaf):
        if isinstance(leaf, TrainQTensor):
            return leaf.qt
        if isinstance(leaf, torch.Tensor):
            return leaf.detach()
        return leaf
    return tree_map(conv, params,
                    is_leaf=lambda x: isinstance(x, (TrainQTensor, QTensor)))
