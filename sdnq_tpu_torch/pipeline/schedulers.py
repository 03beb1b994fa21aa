"""Diffusion noise schedulers and FLUX's denoise loop.

``DDIMScheduler`` and ``EulerScheduler`` are the JAX package's schedules
for the epsilon-predicting SD1.5 / SDXL UNet (the scaled-linear betas of
``_sd_alphas``); ``FlowMatchScheduler`` is its flow-matching Euler schedule
and ``flux_denoise`` the denoise loop of its ``flux_generate``: it returns
the final packed latents (B, N_img, in_channels), which
``pipeline.diffusion.flux_generate`` unpacks and decodes with the VAE.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dispatch import check_device, resolve_device
from ..models.dit import DiTConfig, dit_forward, make_rope_freqs

__all__ = ["DDIMScheduler", "EulerScheduler", "FlowMatchScheduler",
           "flux_denoise"]


def _linspace(start: float, stop: float, num: int, device=None):
    """``jnp.linspace`` in float32 in its order of operations (start·(1 −
    i/(num−1)) + stop·i/(num−1), the end point appended as it is), so that
    a schedule and the integers truncated from it match the JAX package's:
    ``torch.linspace`` rounds differently (999 over 4 steps: JAX's second
    point is 665.99994, truncated to 665, torch's 666.0)."""
    f32 = dict(dtype=torch.float32, device=device)
    start_t, stop_t = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    if num == 1:
        return start_t.reshape(1)
    step = torch.arange(num - 1, **f32) / torch.tensor(float(num - 1), **f32)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def _sd_alphas(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
               device=None):
    """The cumulative alphas of SD's scaled-linear beta schedule, fp32."""
    betas = _linspace(beta_start ** 0.5, beta_end ** 0.5,
                      num_train_timesteps, device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def _bcast(a):
    """(B,) -> (B, 1, 1, 1) over NHWC latents."""
    return a[..., None, None, None]


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    """Deterministic DDIM (eta 0) for epsilon prediction."""
    num_train_timesteps: int = 1000

    def timesteps(self, steps: int, device=None) -> torch.Tensor:
        step = self.num_train_timesteps // steps
        return torch.arange(self.num_train_timesteps - 1, -1, -step,
                            device=device)[:steps]

    def step(self, eps, t, t_prev, latents):
        """One step from timestep ``t`` to ``t_prev`` (B,) (-1: the end,
        alpha 1)."""
        alphas = _sd_alphas(self.num_train_timesteps, device=latents.device)
        a_t = _bcast(alphas[t])
        a_prev = _bcast(torch.where(t_prev >= 0,
                                    alphas[t_prev.clamp_min(0)], 1.0))
        x0 = (latents - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps

    def add_noise(self, x0, noise, t):
        a = _bcast(_sd_alphas(self.num_train_timesteps, device=x0.device)[t])
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise


@dataclasses.dataclass(frozen=True)
class EulerScheduler:
    """Karras-style Euler for epsilon prediction."""
    num_train_timesteps: int = 1000

    def sigmas(self, steps: int, device=None) -> torch.Tensor:
        alphas = _sd_alphas(self.num_train_timesteps, device=device)
        all_sig = torch.sqrt((1 - alphas) / alphas)
        idx = self.timesteps(steps, device)
        return torch.cat([all_sig[idx],
                          torch.zeros(1, dtype=torch.float32, device=device)])

    def timesteps(self, steps: int, device=None) -> torch.Tensor:
        # truncated toward zero, as the JAX astype(int32)
        return _linspace(self.num_train_timesteps - 1, 0, steps,
                         device).long()

    def scale_input(self, latents, sigma):
        return latents / torch.sqrt(sigma ** 2 + 1)

    def step(self, eps, sigma, sigma_next, latents):
        return latents + _bcast(sigma_next - sigma) * eps


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
