"""Shared building blocks for the models: norms in fp32, embeddings, rope,
attention and activations, over tensors in the JAX package's layouts
((B, H, N, D) attention, (O, C) linear weights, NHWC images with OIHW conv
weights)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.attention import quantized_attention, trainable_attention
from ..layers import qlinear

Params = dict

__all__ = ["linear_init", "conv_init", "layer_norm", "rms_norm",
           "group_norm", "timestep_embedding", "rope", "apply_rope",
           "attention", "split_heads", "gelu", "silu", "mlp_forward"]


def linear_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
                device, dtype=torch.float32, bias: bool = True) -> Params:
    """Normal(0, 1/in_dim) weight and zero bias, drawn on ``device``."""
    w = torch.randn((out_dim, in_dim), generator=generator, device=device,
                    dtype=dtype)
    p = {"weight": w.mul_(1.0 / math.sqrt(in_dim))}
    if bias:
        p["bias"] = torch.zeros((out_dim,), device=device, dtype=dtype)
    return p


def conv_init(in_ch: int, out_ch: int, kernel: int = 3, *,
              generator: torch.Generator, device, dtype=torch.float32,
              bias: bool = True) -> Params:
    """Normal(0, 1/fan_in) OIHW weight and zero bias, drawn on
    ``device``."""
    w = torch.randn((out_ch, in_ch, kernel, kernel), generator=generator,
                    device=device, dtype=dtype)
    p = {"weight": w.mul_(1.0 / math.sqrt(in_ch * kernel * kernel))}
    if bias:
        p["bias"] = torch.zeros((out_ch,), device=device, dtype=dtype)
    return p


def layer_norm(x, weight=None, bias=None, eps=1e-6):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x, weight=None, eps=1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def group_norm(x, weight, bias, groups: int = 32, eps: float = 1e-6):
    """x NHWC; statistics over (H, W, C / groups) in fp32."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h, w, groups, c // groups)
    mean = xf.mean((1, 2, 4), keepdim=True)
    var = xf.var((1, 2, 4), keepdim=True, unbiased=False)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (out * weight.float() + bias.float()).to(x.dtype)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope(pos, dim: int, theta: float = 10000.0):
    """Rotary table: pos (..., n) -> (..., n, dim/2, 2, 2)."""
    scale = torch.arange(0, dim, 2, dtype=torch.float32,
                         device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.float()[..., None] * omega
    cos, sin = torch.cos(out), torch.sin(out)
    return torch.stack([torch.stack([cos, -sin], -1),
                        torch.stack([sin, cos], -1)], -2)


def apply_rope(x, freqs):
    """x (B, H, N, D); freqs (B or 1, 1, N, D/2, 2, 2)."""
    x2 = x.float().reshape(*x.shape[:-1], -1, 2)
    rotated = torch.stack(
        [freqs[..., 0, 0] * x2[..., 0] + freqs[..., 0, 1] * x2[..., 1],
         freqs[..., 1, 0] * x2[..., 0] + freqs[..., 1, 1] * x2[..., 1]],
        dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def attention(q, k, v, attn_config: dict | None = None):
    """q/k/v (B, H, N, D) -> (B, N, H*D); ``attn_config`` selects the
    attention mode (default ``"auto"``).  Where autograd records (a
    training step), the attention is ``trainable_attention``."""
    cfg = attn_config or {}
    grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    fn = trainable_attention if grad else quantized_attention
    out = fn(
        q, k, v,
        matmul_dtype=cfg.get("matmul_dtype", "auto"),
        pv_matmul_dtype=cfg.get("pv_matmul_dtype"),
        smooth_k=cfg.get("smooth_k", False),
        use_hadamard=cfg.get("use_hadamard", False),
        is_causal=cfg.get("is_causal", False),
        out_dtype=q.dtype if q.dtype != torch.int8 else torch.bfloat16)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


def split_heads(x, heads: int):
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def mlp_forward(params: Params, x, act=gelu, out_dtype=None):
    """fc1, the activation, fc2: each a ``qlinear`` of ``params[name]``'s
    weight and optional bias."""
    h = qlinear(x, params["fc1"]["weight"], params["fc1"].get("bias"))
    h = act(h)
    return qlinear(h, params["fc2"]["weight"], params["fc2"].get("bias"),
                   out_dtype=out_dtype)
