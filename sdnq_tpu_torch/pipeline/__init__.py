"""Samplers and the text-to-image pipelines."""

from .batching import ContinuousBatcher, Request
from .diffusion import flux_generate, sd_generate
from .schedulers import (
    DDIMScheduler, EulerScheduler, FlowMatchScheduler, flux_denoise,
)

__all__ = ["ContinuousBatcher", "Request", "DDIMScheduler", "EulerScheduler", "FlowMatchScheduler",
           "flux_denoise", "flux_generate", "sd_generate"]
