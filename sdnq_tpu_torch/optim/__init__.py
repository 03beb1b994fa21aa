"""Quantized-state optimizers (the JAX package's ``optim``)."""

from .base import (
    BufferQ, OptConfig, QOptimizer, cast_state_for_transfer,
    cast_state_from_transfer, dequantize_buffer, fetch_opt_state,
    offload_opt_state, quantize_buffer, zero_buffer,
)
from .muon import muon, zeropower_via_newtonschulz5
from .optimizers import adafactor, adamw, came, lion, make_optimizer

__all__ = [
    "OptConfig", "QOptimizer", "BufferQ", "quantize_buffer",
    "dequantize_buffer", "zero_buffer", "adamw", "lion", "adafactor",
    "came", "muon", "zeropower_via_newtonschulz5", "make_optimizer",
    "offload_opt_state", "fetch_opt_state", "cast_state_for_transfer",
    "cast_state_from_transfer",
]
