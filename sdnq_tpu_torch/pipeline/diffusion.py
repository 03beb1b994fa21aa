"""Text-to-image pipelines: the JAX package's ``pipeline.diffusion`` in
torch.

``sd_generate`` is the SD1.5 / SDXL sampler: DDIM with classifier-free
guidance over the UNet (two ``unet_forward`` calls a step, conditional and
unconditional, each at the request batch), then the VAE decode.
``flux_generate`` is FLUX's sampler: the rectified-flow Euler loop over
packed 2x2 latent patches (``flux_denoise``), the patches unpacked into a
latent image, and the VAE decode.  Its text inputs come from
``models.text_encoder`` (T5 states and CLIP's pooled vector).
"""

from __future__ import annotations

import torch

from ..kernels.dispatch import check_device, resolve_device
from ..models.dit import DiTConfig
from ..models.unet import UNetConfig, make_staged_unet_forward
from ..models.vae import VAEConfig, vae_decode
from .schedulers import DDIMScheduler, flux_denoise

__all__ = ["sd_generate", "flux_generate"]


def sd_generate(unet_params, vae_params, text_emb: torch.Tensor,
                uncond_emb: torch.Tensor, *, unet_cfg: UNetConfig,
                vae_cfg: VAEConfig, steps: int = 20, height: int = 64,
                width: int = 64, guidance_scale: float = 7.5,
                generator: torch.Generator | None = None,
                latents: torch.Tensor | None = None,
                added_cond: torch.Tensor | None = None,
                attn_config: dict | None = None,
                device=None) -> torch.Tensor:
    """DDIM with classifier-free guidance, then the VAE: text_emb /
    uncond_emb (B, L, cross_attention_dim) encoder states, added_cond (B,
    addition_embed_dim) for SDXL (given to both calls) -> image (B, height,
    width, out_channels).  The starting noise (B, height/8, width/8,
    in_channels) fp32 is ``latents`` or drawn from ``generator``.  Each
    step runs the UNet twice at batch B, as the JAX package does (not once
    at 2B: the row counts choose the kernels' routes).  Everything runs on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    check_device(text_emb, device, "text_emb")
    sched = DDIMScheduler()
    b = text_emb.shape[0]
    if latents is None:
        latents = torch.randn((b, height // 8, width // 8,
                               unet_cfg.in_channels), generator=generator,
                              device=device, dtype=torch.float32)
    ts = sched.timesteps(steps, device=device)
    forward = make_staged_unet_forward(unet_cfg, attn_config)
    for i in range(steps):
        t = ts[i].expand(b)
        eps_c = forward(unet_params, latents, t.float(), text_emb,
                        added_cond, device=device)
        eps_u = forward(unet_params, latents, t.float(), uncond_emb,
                        added_cond, device=device)
        eps = eps_u + guidance_scale * (eps_c - eps_u)
        t_prev = ts[i + 1].expand(b) if i + 1 < steps else torch.full_like(
            t, -1)
        latents = sched.step(eps.float(), t, t_prev, latents)
    return vae_decode(vae_params, latents, vae_cfg, device=device)


def flux_generate(dit_params, vae_params, txt: torch.Tensor,
                  pooled: torch.Tensor, *, dit_cfg: DiTConfig,
                  vae_cfg: VAEConfig, steps: int = 20, height: int = 64,
                  width: int = 64, guidance: float = 3.5,
                  generator: torch.Generator | None = None,
                  latents: torch.Tensor | None = None,
                  attn_config: dict | None = None,
                  device=None) -> torch.Tensor:
    """txt (B, L, txt_dim) T5 states, pooled (B, vec_dim) CLIP pooled ->
    image (B, height, width, out_channels).  The starting noise (B,
    (height/16)·(width/16), in_channels) is ``latents`` or drawn from
    ``generator``.  Everything runs on ``device`` (the card by
    default)."""
    device = resolve_device(device)
    lat = flux_denoise(dit_params, txt, pooled, dit_cfg, steps=steps,
                       height=height, width=width, guidance=guidance,
                       generator=generator, latents=latents,
                       attn_config=attn_config, device=device)
    # unpack the 2x2 patches -> (B, 2·lh, 2·lw, C/4) latent image
    b = txt.shape[0]
    lh, lw = height // 16, width // 16
    c = dit_cfg.in_channels // 4
    lat = lat.reshape(b, lh, lw, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    lat = lat.reshape(b, 2 * lh, 2 * lw, c)
    return vae_decode(vae_params, lat, vae_cfg, device=device)
