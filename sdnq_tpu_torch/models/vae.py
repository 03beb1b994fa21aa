"""The SD / SDXL / FLUX VAE (AutoencoderKL) decoder and encoder over NHWC
tensors: the JAX package's ``models.vae`` in torch.

Parameter names follow diffusers' AutoencoderKL.  Convolutions go through
``layers.qconv`` (OIHW weights on NHWC activations; SDNQ leaves VAE convs
unquantized by default, ``quant_conv`` off); the mid-block attention is the
JAX package's plain fp32 softmax over all pixels (no kernel in either
package), its linears through ``qlinear``.  ``vae_decode`` divides by the
scaling factor and applies no shift factor, as the JAX package does (the
FLUX VAE's shift factor 0.1159 is missing there: ROADMAP queue C).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dispatch import check_device, resolve_device
from ..layers import qconv, qlinear
from .common import Params, conv_init, group_norm, linear_init, silu

__all__ = ["VAEConfig", "VAE_TINY_CONFIG", "SD_VAE_CONFIG", "init_vae",
           "vae_decode", "vae_encode"]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: tuple = (1, 2, 4, 4)
    layers_per_block: int = 2
    out_channels: int = 3
    norm_groups: int = 32
    scaling_factor: float = 0.18215


SD_VAE_CONFIG = VAEConfig()
VAE_TINY_CONFIG = VAEConfig(base_channels=32, channel_mults=(1, 2),
                            layers_per_block=1, norm_groups=8)


def init_vae(cfg: VAEConfig = VAE_TINY_CONFIG, *,
             generator: torch.Generator | None = None, device=None,
             dtype=torch.float32) -> Params:
    """Random decoder and encoder parameters drawn on ``device`` (the card
    by default) from ``generator`` (seeded 0 when omitted)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device, dtype=dtype)

    def norm(ch):
        return {"weight": torch.ones((ch,), device=device, dtype=dtype),
                "bias": torch.zeros((ch,), device=device, dtype=dtype)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv_init(cin, cout, 3, **kw),
             "norm2": norm(cout), "conv2": conv_init(cout, cout, 3, **kw)}
        if cin != cout:
            p["conv_shortcut"] = conv_init(cin, cout, 1, **kw)
        return p

    def attn(ch):
        return {"group_norm": norm(ch),
                **{name: linear_init(ch, ch, **kw)
                   for name in ("to_q", "to_k", "to_v", "to_out")}}

    chs = [cfg.base_channels * m for m in cfg.channel_mults]
    mid = chs[-1]
    dec: Params = {
        "conv_in": conv_init(cfg.latent_channels, mid, 3, **kw),
        "mid_block": {"resnets": [resnet(mid, mid), resnet(mid, mid)],
                      "attentions": [attn(mid)]},
        "up_blocks": [],
        "conv_norm_out": norm(chs[0]),
        "conv_out": conv_init(chs[0], cfg.out_channels, 3, **kw),
    }
    cin = mid
    for ch in reversed(chs):
        blk = {"resnets": []}
        for _ in range(cfg.layers_per_block + 1):
            blk["resnets"].append(resnet(cin, ch))
            cin = ch
        if ch != chs[0]:
            blk["upsamplers"] = [{"conv": conv_init(ch, ch, 3, **kw)}]
        dec["up_blocks"].append(blk)

    enc: Params = {
        "conv_in": conv_init(cfg.out_channels, chs[0], 3, **kw),
        "down_blocks": [],
        "mid_block": {"resnets": [resnet(mid, mid), resnet(mid, mid)],
                      "attentions": [attn(mid)]},
        "conv_norm_out": norm(mid),
        "conv_out": conv_init(mid, 2 * cfg.latent_channels, 3, **kw),
    }
    cin = chs[0]
    for i, ch in enumerate(chs):
        blk = {"resnets": []}
        for _ in range(cfg.layers_per_block):
            blk["resnets"].append(resnet(cin, ch))
            cin = ch
        if i < len(chs) - 1:
            blk["downsamplers"] = [{"conv": conv_init(ch, ch, 3, **kw)}]
        enc["down_blocks"].append(blk)
    return {"decoder": dec, "encoder": enc}


def _conv(p, x, **kw):
    return qconv(x, p["weight"], p.get("bias"), **kw)


def _resnet(p, x, groups):
    h = _conv(p["conv1"], silu(group_norm(x, p["norm1"]["weight"],
                                          p["norm1"]["bias"], groups)))
    h = _conv(p["conv2"], silu(group_norm(h, p["norm2"]["weight"],
                                          p["norm2"]["bias"], groups)))
    if "conv_shortcut" in p:
        x = _conv(p["conv_shortcut"], x)
    return x + h


def _mid_attn(p, x, groups):
    """Single-head attention over all pixels: fp32 scores and softmax, as
    the JAX package's einsums (no kernel)."""
    n, h, w, c = x.shape
    xn = group_norm(x, p["group_norm"]["weight"], p["group_norm"]["bias"],
                    groups)
    flat = xn.reshape(n, h * w, c)
    q, k, v = (qlinear(flat, p[name]["weight"], p[name].get("bias")).float()
               for name in ("to_q", "to_k", "to_v"))
    s = (q @ k.transpose(1, 2)) * (c ** -0.5)
    out = (torch.softmax(s, -1) @ v).to(x.dtype)
    del s
    out = qlinear(out, p["to_out"]["weight"], p["to_out"].get("bias"))
    return x + out.reshape(n, h, w, c)


def _upsample2x(x):
    """Nearest-neighbour x2 (``jax.image.resize`` "nearest" at an exact
    factor of 2): pixel replication."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def vae_decode(params: Params, z: torch.Tensor, cfg: VAEConfig, *,
               device=None):
    """z (N, h, w, latent_channels) -> image (N, 8h, 8w, 3), about [-1, 1].
    ``post_quant_conv`` (diffusers' 1x1 latent conv) applies when the
    parameters carry it.  ``z`` must lie on ``device`` (the card by
    default)."""
    check_device(z, resolve_device(device), "z")
    p = params["decoder"]
    groups = cfg.norm_groups
    z = z / cfg.scaling_factor
    if "post_quant_conv" in params:
        z = _conv(params["post_quant_conv"], z)
    h = _conv(p["conv_in"], z)
    h = _resnet(p["mid_block"]["resnets"][0], h, groups)
    h = _mid_attn(p["mid_block"]["attentions"][0], h, groups)
    h = _resnet(p["mid_block"]["resnets"][1], h, groups)
    for blk in p["up_blocks"]:
        for r in blk["resnets"]:
            h = _resnet(r, h, groups)
        if "upsamplers" in blk:
            h = _conv(blk["upsamplers"][0]["conv"], _upsample2x(h))
    h = group_norm(h, p["conv_norm_out"]["weight"], p["conv_norm_out"]["bias"],
                   groups)
    return _conv(p["conv_out"], silu(h))


def vae_encode(params: Params, x: torch.Tensor, cfg: VAEConfig,
               generator: torch.Generator | None = None, *, device=None):
    """image (N, H, W, 3) -> latent (N, H/2^L, W/2^L, latent_channels)
    times the scaling factor: the mean, or a sample drawn from
    ``generator`` when one is given.  ``x`` must lie on ``device`` (the
    card by default)."""
    check_device(x, resolve_device(device), "x")
    p = params["encoder"]
    groups = cfg.norm_groups
    h = _conv(p["conv_in"], x)
    for blk in p["down_blocks"]:
        for r in blk["resnets"]:
            h = _resnet(r, h, groups)
        if "downsamplers" in blk:
            h = _conv(blk["downsamplers"][0]["conv"], h, stride=2,
                      padding=((1, 1), (1, 1)))
    h = _resnet(p["mid_block"]["resnets"][0], h, groups)
    h = _mid_attn(p["mid_block"]["attentions"][0], h, groups)
    h = _resnet(p["mid_block"]["resnets"][1], h, groups)
    h = group_norm(h, p["conv_norm_out"]["weight"], p["conv_norm_out"]["bias"],
                   groups)
    moments = _conv(p["conv_out"], silu(h))
    if "quant_conv" in params:
        moments = _conv(params["quant_conv"], moments)
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    if generator is not None:
        mean = mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * torch.randn(
            mean.shape, generator=generator, device=mean.device,
            dtype=mean.dtype)
    return mean * cfg.scaling_factor
