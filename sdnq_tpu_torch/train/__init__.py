"""Quantized training: trainable linears, conversion, checkpointing and the
training loop (the JAX package's ``train``)."""

from .matmul import (
    DynamicTensor, TrainQTensor, apply_weight_updates, dynamic_qlinear,
    extract_weight_grads, grad_carrier, make_train_params, train_qlinear,
)
from .convert import (
    convert_model_to_training, convert_training_model_to_inference,
)
from .loop import fit, latest_checkpoint_step
from .remat import checkpoint_block, dots_saveable_policy

__all__ = [
    "TrainQTensor", "make_train_params", "train_qlinear",
    "extract_weight_grads", "apply_weight_updates", "grad_carrier",
    "DynamicTensor", "dynamic_qlinear",
    "convert_model_to_training", "convert_training_model_to_inference",
    "fit", "latest_checkpoint_step", "checkpoint_block",
    "dots_saveable_policy",
]
