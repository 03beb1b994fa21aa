"""SD1.5 / SDXL UNet over NHWC tensors: the JAX package's ``models.unet``
in torch.

BASELINE configs 1-2: "SD 1.5 UNet, INT8 weight-only" and "SDXL UNet, INT8
weights + INT8 quantized matmul".  Parameter names follow diffusers'
UNet2DConditionModel, so the skip-key registry entries "SD15UNet" and
"SDXLUNet" apply.  Structure: conv_in -> down blocks (resnets, transformer
blocks where the level has them, a stride-2 downsampler but on the last
level) -> mid (resnet, transformer, resnet) -> up blocks (each resnet on
the skip concatenated) -> norm / conv_out.  SDXL differs from SD1.5 by its
widths, transformer depth per level and the text-time embedding
(``add_embedding`` of the pooled text and size conditions).

The JAX structure is kept where it departs from diffusers: heads are
``channels // 64`` at every level (``attention_head_dim`` is unused; SD1.5
in diffusers has 8 heads), ``proj_in`` / ``proj_out`` are linear, and the
mid block's transformer depth is ``max(1, transformer_layers[-1] or 1)``.
Convolutions go through ``layers.qconv`` (OIHW weights), linears through
``layers.qlinear``, attention through ``models.common.attention`` (B3 on
the card where the JAX route takes its kernel: the self-attention; the
77-token cross-attention takes the XLA function there, as in JAX).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..kernels.dispatch import check_device, resolve_device
from ..layers import qconv, qlinear
from ..utils import log
from .common import (
    Params, attention, conv_init, gelu, group_norm, layer_norm, linear_init,
    silu, split_heads, timestep_embedding,
)
from .vae import _upsample2x  # jax.image.resize "nearest" at twice the size

__all__ = ["UNetConfig", "SD15_CONFIG", "SDXL_CONFIG", "UNET_TINY_CONFIG",
           "make_staged_unet_forward", "init_unet", "unet_forward"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # transformer blocks per level (0 = a plain resnet level)
    transformer_layers: tuple = (1, 1, 1, 0)
    attention_head_dim: int = 8      # unused: heads are channels // 64
    cross_attention_dim: int = 768
    addition_embed_dim: int = 0      # SDXL: 2816 (pooled 1280 + size embeds)
    norm_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD15_CONFIG = UNetConfig()
SDXL_CONFIG = UNetConfig(
    block_out_channels=(320, 640, 1280),
    transformer_layers=(0, 2, 10),
    cross_attention_dim=2048,
    addition_embed_dim=2816,
)
UNET_TINY_CONFIG = UNetConfig(
    block_out_channels=(32, 64), layers_per_block=1,
    transformer_layers=(0, 1), cross_attention_dim=64, norm_groups=8)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_unet(cfg: UNetConfig = UNET_TINY_CONFIG, *,
              generator: torch.Generator | None = None, device=None,
              dtype=torch.float32) -> Params:
    """Random parameters drawn on ``device`` (the card by default) from
    ``generator`` (seeded 0 when omitted), in the JAX package's tree.  At
    SDXL width build in bf16 (5.1 GB) and quantize with
    ``quantize_model``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device, dtype=dtype)
    chs = cfg.block_out_channels
    temb = cfg.time_embed_dim

    def norm(ch):
        return {"weight": torch.ones((ch,), device=device, dtype=dtype),
                "bias": torch.zeros((ch,), device=device, dtype=dtype)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv_init(cin, cout, 3, **kw),
             "time_emb_proj": linear_init(temb, cout, **kw),
             "norm2": norm(cout), "conv2": conv_init(cout, cout, 3, **kw)}
        if cin != cout:
            p["conv_shortcut"] = conv_init(cin, cout, 1, **kw)
        return p

    def attn(ctx_dim, d):
        return {"to_q": linear_init(d, d, bias=False, **kw),
                "to_k": linear_init(ctx_dim, d, bias=False, **kw),
                "to_v": linear_init(ctx_dim, d, bias=False, **kw),
                "to_out": linear_init(d, d, **kw)}

    def xformer(d):
        return {"norm1": norm(d), "attn1": attn(d, d), "norm2": norm(d),
                "attn2": attn(cfg.cross_attention_dim, d), "norm3": norm(d),
                "ff": {"proj_in": linear_init(d, 8 * d, **kw),
                       "proj_out": linear_init(4 * d, d, **kw)}}

    def spatial(ch, depth):
        return {"norm": norm(ch), "proj_in": linear_init(ch, ch, **kw),
                "transformer_blocks": [xformer(ch) for _ in range(depth)],
                "proj_out": linear_init(ch, ch, **kw)}

    p: Params = {
        "conv_in": conv_init(cfg.in_channels, chs[0], 3, **kw),
        "time_embedding": {"linear_1": linear_init(chs[0], temb, **kw),
                           "linear_2": linear_init(temb, temb, **kw)},
        "down_blocks": [], "up_blocks": [],
        "conv_norm_out": norm(chs[0]),
        "conv_out": conv_init(chs[0], cfg.out_channels, 3, **kw),
    }
    if cfg.addition_embed_dim:
        p["add_embedding"] = {
            "linear_1": linear_init(cfg.addition_embed_dim, temb, **kw),
            "linear_2": linear_init(temb, temb, **kw)}

    cin = chs[0]
    for lvl, ch in enumerate(chs):
        blk = {"resnets": [], "attentions": []}
        for _ in range(cfg.layers_per_block):
            blk["resnets"].append(resnet(cin, ch))
            cin = ch
            if cfg.transformer_layers[lvl]:
                blk["attentions"].append(
                    spatial(ch, cfg.transformer_layers[lvl]))
        if lvl < len(chs) - 1:
            blk["downsamplers"] = [{"conv": conv_init(ch, ch, 3, **kw)}]
        p["down_blocks"].append(blk)

    ch = chs[-1]
    p["mid_block"] = {
        "resnets": [resnet(ch, ch), resnet(ch, ch)],
        "attentions": [spatial(ch, max(1, cfg.transformer_layers[-1] or 1))],
    }

    # the skip widths, as the down path pushes them
    skip_stack = [chs[0]]
    for lvl, ch in enumerate(chs):
        skip_stack += [ch] * cfg.layers_per_block
        if lvl < len(chs) - 1:
            skip_stack.append(ch)
    cin = chs[-1]
    for lvl, ch in reversed(list(enumerate(chs))):
        blk = {"resnets": [], "attentions": []}
        for _ in range(cfg.layers_per_block + 1):
            blk["resnets"].append(resnet(cin + skip_stack.pop(), ch))
            cin = ch
            if cfg.transformer_layers[lvl]:
                blk["attentions"].append(
                    spatial(ch, cfg.transformer_layers[lvl]))
        if lvl > 0:
            blk["upsamplers"] = [{"conv": conv_init(ch, ch, 3, **kw)}]
        p["up_blocks"].append(blk)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _lin(p, x):
    return qlinear(x, p["weight"], p.get("bias"))


def _conv(p, x, **kw):
    return qconv(x, p["weight"], p.get("bias"), **kw)


def _resnet(p, x, temb, groups):
    h = group_norm(x, p["norm1"]["weight"], p["norm1"]["bias"], groups)
    h = _conv(p["conv1"], silu(h), padding="SAME")
    h = h + _lin(p["time_emb_proj"], silu(temb))[:, None, None, :]
    h = group_norm(h, p["norm2"]["weight"], p["norm2"]["bias"], groups)
    h = _conv(p["conv2"], silu(h), padding="SAME")
    if "conv_shortcut" in p:
        x = _conv(p["conv_shortcut"], x, padding="SAME")
    return x + h


def _basic_transformer(p, x, ctx, heads, attn_cfg):
    def attn(ap, xq, kv):
        q = split_heads(_lin(ap["to_q"], xq), heads)
        k = split_heads(_lin(ap["to_k"], kv), heads)
        v = split_heads(_lin(ap["to_v"], kv), heads)
        return _lin(ap["to_out"], attention(q, k, v, attn_cfg))

    xn = layer_norm(x, p["norm1"]["weight"], p["norm1"]["bias"])
    x = x + attn(p["attn1"], xn, xn)
    xn = layer_norm(x, p["norm2"]["weight"], p["norm2"]["bias"])
    x = x + attn(p["attn2"], xn, ctx)
    xn = layer_norm(x, p["norm3"]["weight"], p["norm3"]["bias"])
    a, b = _lin(p["ff"]["proj_in"], xn).chunk(2, dim=-1)   # GEGLU
    return x + _lin(p["ff"]["proj_out"], a * gelu(b))


def _spatial_transformer(p, x, ctx, groups, attn_cfg):
    n, h, w, c = x.shape
    heads = max(1, c // 64)
    xn = group_norm(x, p["norm"]["weight"], p["norm"]["bias"], groups)
    t = _lin(p["proj_in"], xn.reshape(n, h * w, c))
    for blk in p["transformer_blocks"]:
        t = _basic_transformer(blk, t, ctx, heads, attn_cfg)
    return x + _lin(p["proj_out"], t).reshape(n, h, w, c)


def unet_forward(params: Params, x: torch.Tensor, timesteps: torch.Tensor,
                 encoder_hidden_states: torch.Tensor, cfg: UNetConfig,
                 added_cond: torch.Tensor | None = None,
                 attn_config: dict | None = None, *, device=None):
    """x (N, H, W, C_in) NHWC latents; timesteps (N,); encoder_hidden_states
    (N, L, cross_attention_dim); added_cond (N, addition_embed_dim) for
    SDXL.  The inputs must lie on ``device`` (the card by default)."""
    forward = make_staged_unet_forward(cfg, attn_config)
    return forward(params, x, timesteps, encoder_hidden_states, added_cond,
                   device=device)


def make_staged_unet_forward(cfg: UNetConfig,
                             attn_config: dict | None = None,
                             sync: bool = False):
    """The forward as stages (embed, one per down level, mid, one per up
    level, head), as the JAX package's staged forward compiles them apart;
    here each stage runs eagerly, the skips crossing stages as a list.
    ``sync`` synchronises the card and logs after every stage (to place a
    device fault in its stage).  Returns ``forward(params, x, timesteps,
    encoder_hidden_states, added_cond=None, *, device=None)``, which
    computes ``unet_forward``."""
    groups = cfg.norm_groups

    def done(h, name):
        if sync:
            if h.is_cuda:
                torch.cuda.synchronize(h.device)
            log.info("staged-unet stage ok: %s (t=%.1fs)", name,
                     time.perf_counter())

    def embed(p, x, timesteps, added_cond):
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = _lin(p["time_embedding"]["linear_2"],
                    silu(_lin(p["time_embedding"]["linear_1"], temb)))
        if cfg.addition_embed_dim and added_cond is not None:
            a = _lin(p["add_embedding"]["linear_1"], added_cond)
            temb = temb + _lin(p["add_embedding"]["linear_2"], silu(a))
        return _conv(p["conv_in"], x, padding="SAME"), temb

    def down_level(blk, h, temb, ctx):
        skips = []
        for i, res_p in enumerate(blk["resnets"]):
            h = _resnet(res_p, h, temb, groups)
            if blk["attentions"]:
                h = _spatial_transformer(blk["attentions"][i], h, ctx,
                                         groups, attn_config)
            skips.append(h)
        if "downsamplers" in blk:
            h = _conv(blk["downsamplers"][0]["conv"], h, stride=2,
                      padding=((1, 1), (1, 1)))
            skips.append(h)
        return h, skips

    def mid(p, h, temb, ctx):
        h = _resnet(p["resnets"][0], h, temb, groups)
        h = _spatial_transformer(p["attentions"][0], h, ctx, groups,
                                 attn_config)
        return _resnet(p["resnets"][1], h, temb, groups)

    def up_level(blk, h, temb, ctx, skips):
        for i, res_p in enumerate(blk["resnets"]):
            h = _resnet(res_p, torch.cat([h, skips.pop()], dim=-1), temb,
                        groups)
            if blk["attentions"]:
                h = _spatial_transformer(blk["attentions"][i], h, ctx,
                                         groups, attn_config)
        if "upsamplers" in blk:
            h = _conv(blk["upsamplers"][0]["conv"], _upsample2x(h),
                      padding="SAME")
        return h

    def head(p, h):
        h = group_norm(h, p["conv_norm_out"]["weight"],
                       p["conv_norm_out"]["bias"], groups)
        return _conv(p["conv_out"], silu(h), padding="SAME")

    def forward(params, x, timesteps, encoder_hidden_states,
                added_cond=None, *, device=None):
        device = resolve_device(device)
        for name, t in (("x", x), ("timesteps", timesteps),
                        ("encoder_hidden_states", encoder_hidden_states)):
            check_device(t, device, name)
        ctx = encoder_hidden_states
        h, temb = embed(params, x, timesteps, added_cond)
        done(h, "embed")
        skips = [h]
        for i, blk in enumerate(params["down_blocks"]):
            h, new = down_level(blk, h, temb, ctx)
            done(h, f"down{i}")
            skips += new
        h = mid(params["mid_block"], h, temb, ctx)
        done(h, "mid")
        for i, blk in enumerate(params["up_blocks"]):
            n = len(blk["resnets"])
            h = up_level(blk, h, temb, ctx, skips[-n:])
            skips = skips[:-n]
            done(h, f"up{i}")
        out = head(params, h)
        done(out, "head")
        return out

    return forward
