"""Samplers and the text-to-image pipelines."""

from .diffusion import flux_generate, sd_generate
from .schedulers import (
    DDIMScheduler, EulerScheduler, FlowMatchScheduler, flux_denoise,
)

__all__ = ["DDIMScheduler", "EulerScheduler", "FlowMatchScheduler",
           "flux_denoise", "flux_generate", "sd_generate"]
