"""Samplers and the text-to-image pipeline."""

from .diffusion import flux_generate
from .schedulers import FlowMatchScheduler, flux_denoise

__all__ = ["FlowMatchScheduler", "flux_denoise", "flux_generate"]
