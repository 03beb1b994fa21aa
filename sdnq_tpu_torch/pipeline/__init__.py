"""Samplers."""

from .schedulers import FlowMatchScheduler, flux_denoise

__all__ = ["FlowMatchScheduler", "flux_denoise"]
