"""Models over nested dicts of tensors and QTensors."""

from .dit import (
    FLUX_DEV_CONFIG, FLUX_TINY_CONFIG, DiTConfig, dit_forward, init_dit,
    make_rope_freqs,
)

__all__ = ["DiTConfig", "FLUX_DEV_CONFIG", "FLUX_TINY_CONFIG", "init_dit",
           "dit_forward", "make_rope_freqs"]
