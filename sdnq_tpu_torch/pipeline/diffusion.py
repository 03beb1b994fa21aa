"""Text-to-image pipelines: the JAX package's ``pipeline.diffusion`` in
torch.

``flux_generate`` is FLUX's sampler: the rectified-flow Euler loop over
packed 2x2 latent patches (``flux_denoise``), the patches unpacked into a
latent image, and the VAE decode.  Its text inputs come from
``models.text_encoder`` (T5 states and CLIP's pooled vector).
``sd_generate`` waits for ``models/unet.py`` (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from ..kernels.dispatch import resolve_device
from ..models.dit import DiTConfig
from ..models.vae import VAEConfig, vae_decode
from .schedulers import flux_denoise

__all__ = ["flux_generate"]


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
