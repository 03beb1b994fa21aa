"""Rectified-flow sampling for the Flux DiT.

``FlowMatchScheduler`` is the JAX package's flow-matching Euler schedule;
``flux_denoise`` is the denoise loop of its ``flux_generate``: it returns
the final packed latents (B, N_img, in_channels), which
``pipeline.diffusion.flux_generate`` unpacks and decodes with the VAE.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dispatch import check_device, resolve_device
from ..models.dit import DiTConfig, dit_forward, make_rope_freqs

__all__ = ["FlowMatchScheduler", "flux_denoise"]


@dataclasses.dataclass(frozen=True)
class FlowMatchScheduler:
    """x_t = (1-t) x0 + t noise; the model predicts v = noise - x0."""
    shift: float = 1.0

    def timesteps(self, steps: int, device=None) -> torch.Tensor:
        t = torch.linspace(1.0, 1.0 / steps, steps, dtype=torch.float32,
                           device=device)
        if self.shift != 1.0:
            t = self.shift * t / (1 + (self.shift - 1) * t)
        return t

    def step(self, v, t, t_prev, latents):
        dt = (t_prev - t).reshape(-1, *([1] * (latents.dim() - 1)))
        return latents + dt * v

    def add_noise(self, x0, noise, t):
        tb = t.reshape(t.shape + (1,) * (x0.dim() - t.dim()))
        return (1 - tb) * x0 + tb * noise


def flux_denoise(params, txt: torch.Tensor, pooled: torch.Tensor,
                 cfg: DiTConfig, *, steps: int = 20, height: int = 64,
                 width: int = 64, guidance: float = 3.5,
                 generator: torch.Generator | None = None,
                 latents: torch.Tensor | None = None,
                 attn_config: dict | None = None, device=None,
                 shift: float = 3.0) -> torch.Tensor:
    """Euler steps of the flow-matching schedule from noise (``latents``,
    or drawn from ``generator``) at t = 1 toward t = 0.  Height and width
    are image pixels: 8x VAE, then 2x2 patches."""
    device = resolve_device(device)
    check_device(txt, device, "txt")
    sched = FlowMatchScheduler(shift=shift)
    b = txt.shape[0]
    lh, lw = height // 16, width // 16
    if latents is None:
        latents = torch.randn((b, lh * lw, cfg.in_channels),
                              generator=generator, device=device,
                              dtype=torch.float32)
    ts = sched.timesteps(steps, device=device)
    freqs = make_rope_freqs(cfg, txt.shape[1], (lh, lw), device=device)
    g = torch.full((b,), guidance, dtype=torch.float32, device=device)
    for i in range(steps):
        t = ts[i].expand(b)
        v = dit_forward(params, latents, txt, t, pooled, cfg, guidance=g,
                        freqs=freqs, attn_config=attn_config, device=device)
        t_prev = ts[i + 1] if i + 1 < steps else torch.zeros_like(ts[i])
        latents = latents + (t_prev - ts[i]) * v.float()
    return latents
