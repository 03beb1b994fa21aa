"""Quantized-state optimizers (the JAX package's ``optim``, without muon,
which is a later slice of the port)."""

from .base import (
    BufferQ, OptConfig, QOptimizer, cast_state_for_transfer,
    cast_state_from_transfer, dequantize_buffer, fetch_opt_state,
    offload_opt_state, quantize_buffer, zero_buffer,
)
from .optimizers import adafactor, adamw, came, lion, make_optimizer

__all__ = [
    "OptConfig", "QOptimizer", "BufferQ", "quantize_buffer",
    "dequantize_buffer", "zero_buffer", "adamw", "lion", "adafactor",
    "came", "make_optimizer", "offload_opt_state", "fetch_opt_state",
    "cast_state_for_transfer", "cast_state_from_transfer",
]
