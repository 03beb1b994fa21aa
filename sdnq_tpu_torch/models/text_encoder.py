"""Text encoders: CLIP (SD / SDXL, FLUX's pooled vector) and T5 (FLUX's text
states), the JAX package's ``models.text_encoder`` over torch tensors.

Parameter names follow transformers' CLIPTextModel / T5EncoderModel, so the
skip-key policy applies as in the JAX package.  Layers are lists.  T5 feeds
its relative position bias to attention as an additive float mask (1, H,
N, N), read by B3 through its strides; CLIP's causal attention at 77
tokens fails the kernel's route predicate (N % 8) and takes the XLA
function, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.attention import quantized_attention
from ..kernels.dispatch import check_device, resolve_device
from ..layers import qembedding, qlinear
from .common import Params, attention, gelu, layer_norm, linear_init, \
    rms_norm, split_heads

__all__ = ["CLIPConfig", "T5Config", "CLIP_TINY_CONFIG", "T5_TINY_CONFIG",
           "init_clip", "clip_encode", "init_t5", "init_t5_layer",
           "t5_encode"]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Defaults: openai/clip-vit-large-patch14's text model."""
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    intermediate: int = 3072


CLIP_TINY_CONFIG = CLIPConfig(vocab_size=1000, hidden_size=64, num_layers=2,
                              num_heads=4, intermediate=128)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Defaults: google/t5-v1_1-xxl's encoder (FLUX's text encoder)."""
    vocab_size: int = 32128
    hidden_size: int = 4096
    num_layers: int = 24
    num_heads: int = 64
    head_dim: int = 64
    ff_dim: int = 10240
    rel_buckets: int = 32
    rel_max_distance: int = 128


T5_TINY_CONFIG = T5Config(vocab_size=1000, hidden_size=64, num_layers=2,
                          num_heads=4, head_dim=16, ff_dim=128)


def _init_kw(generator, device, dtype):
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return dict(generator=generator, device=device, dtype=dtype)


def _randn(shape, std, kw):
    return torch.randn(shape, **kw).mul_(std)


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

def init_clip(cfg: CLIPConfig = CLIP_TINY_CONFIG, *,
              generator: torch.Generator | None = None, device=None,
              dtype=torch.float32) -> Params:
    """Random parameters drawn on ``device`` (the card by default) from
    ``generator`` (seeded 0 when omitted)."""
    kw = _init_kw(generator, device, dtype)
    d = cfg.hidden_size
    dev = kw["device"]

    def norm():
        return {"weight": torch.ones((d,), device=dev, dtype=dtype),
                "bias": torch.zeros((d,), device=dev, dtype=dtype)}

    p: Params = {
        "embeddings": {
            "token_embedding": {"weight": _randn((cfg.vocab_size, d), 0.02,
                                                 kw)},
            "position_embedding": {"weight": _randn((cfg.max_positions, d),
                                                    0.02, kw)}},
        "layers": [],
        "final_layer_norm": norm(),
    }
    for _ in range(cfg.num_layers):
        p["layers"].append({
            "layer_norm1": norm(),
            "self_attn": {name: linear_init(d, d, **kw) for name in (
                "q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": norm(),
            "mlp": {"fc1": linear_init(d, cfg.intermediate, **kw),
                    "fc2": linear_init(cfg.intermediate, d, **kw)},
        })
    return p


def _lin(p, x):
    return qlinear(x, p["weight"], p.get("bias"))


def clip_encode(params: Params, input_ids: torch.Tensor, cfg: CLIPConfig,
                attn_config: dict | None = None, *, device=None):
    """input_ids (B, N) -> (last_hidden_state (B, N, D), pooled (B, D)),
    pooled at the position of the largest id (the end-of-text token's
    stand-in, as in the JAX package).  The ids must lie on ``device`` (the
    card by default)."""
    check_device(input_ids, resolve_device(device), "input_ids")
    b, n = input_ids.shape
    h = qembedding(input_ids, params["embeddings"]["token_embedding"]
                   ["weight"])
    pos = qembedding(torch.arange(n, device=input_ids.device)[None, :],
                     params["embeddings"]["position_embedding"]["weight"])
    h = h + pos
    cfg_attn = dict(attn_config or {})
    cfg_attn["is_causal"] = True  # CLIP's text model attends causally
    for lyr in params["layers"]:
        hn = layer_norm(h, lyr["layer_norm1"]["weight"],
                        lyr["layer_norm1"]["bias"], eps=1e-5)
        a = lyr["self_attn"]
        q, k, v = (split_heads(_lin(a[name], hn), cfg.num_heads)
                   for name in ("q_proj", "k_proj", "v_proj"))
        h = h + _lin(a["out_proj"], attention(q, k, v, cfg_attn))
        hn = layer_norm(h, lyr["layer_norm2"]["weight"],
                        lyr["layer_norm2"]["bias"], eps=1e-5)
        m = _lin(lyr["mlp"]["fc1"], hn)
        m = m * torch.sigmoid(1.702 * m)  # quick_gelu
        h = h + _lin(lyr["mlp"]["fc2"], m)
    h = layer_norm(h, params["final_layer_norm"]["weight"],
                   params["final_layer_norm"]["bias"], eps=1e-5)
    eos = input_ids.argmax(-1)
    pooled = h[torch.arange(b, device=h.device), eos]
    return h, pooled


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------

def _rel_bucket(rel: torch.Tensor, buckets: int, max_dist: int):
    """T5's bidirectional relative-position buckets of ``rel`` (int).  The
    log bucket is computed in fp32 in the JAX package's order of
    operations: log(rel / max_exact + 1e-6) / log(max_dist / max_exact),
    the denominator a Python float as there."""
    n = buckets // 2
    ret = torch.where(rel > 0, n, 0)
    rel = rel.abs()
    max_exact = n // 2
    ratio = rel.float() / max_exact + 1e-6
    large = max_exact + (torch.log(ratio) / math.log(max_dist / max_exact)
                         * (n - max_exact)).to(torch.int32)
    large = torch.minimum(large, torch.tensor(n - 1, device=rel.device))
    return ret + torch.where(rel < max_exact, rel, large)


def init_t5(cfg: T5Config = T5_TINY_CONFIG, *,
            generator: torch.Generator | None = None, device=None,
            dtype=torch.float32) -> Params:
    """Random parameters drawn on ``device`` (the card by default) from
    ``generator`` (seeded 0 when omitted).  At T5-XXL's size draw the
    blocks one at a time with ``init_t5_layer`` (a config of 0 layers
    here), quantizing each as it comes."""
    kw = _init_kw(generator, device, dtype)
    dev = kw["device"]
    d = cfg.hidden_size
    p: Params = {
        "shared": {"weight": _randn((cfg.vocab_size, d), 1.0, kw)},
        "relative_attention_bias": {"weight": _randn(
            (cfg.rel_buckets, cfg.num_heads), 0.02, kw)},
        "block": [init_t5_layer(cfg, **kw) for _ in range(cfg.num_layers)],
        "final_layer_norm": {"weight": torch.ones((d,), device=dev,
                                                  dtype=dtype)},
    }
    return p


def init_t5_layer(cfg: T5Config, *, generator: torch.Generator, device,
                  dtype=torch.float32) -> Params:
    """One T5 block's random parameters."""
    kw = dict(generator=generator, device=device, dtype=dtype, bias=False)
    d, inner = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    return {
        "layer_norm0": {"weight": torch.ones((d,), device=device,
                                             dtype=dtype)},
        "SelfAttention": {"q": linear_init(d, inner, **kw),
                          "k": linear_init(d, inner, **kw),
                          "v": linear_init(d, inner, **kw),
                          "o": linear_init(inner, d, **kw)},
        "layer_norm1": {"weight": torch.ones((d,), device=device,
                                             dtype=dtype)},
        "DenseReluDense": {"wi_0": linear_init(d, cfg.ff_dim, **kw),
                           "wi_1": linear_init(d, cfg.ff_dim, **kw),
                           "wo": linear_init(cfg.ff_dim, d, **kw)},
    }


def t5_encode(params: Params, input_ids: torch.Tensor, cfg: T5Config,
              attn_config: dict | None = None, *, device=None):
    """input_ids (B, N) -> text states (B, N, hidden).  The ids must lie on
    ``device`` (the card by default)."""
    check_device(input_ids, resolve_device(device), "input_ids")
    n = input_ids.shape[1]
    h = qembedding(input_ids, params["shared"]["weight"])
    pos = torch.arange(n, device=input_ids.device)
    buckets = _rel_bucket(pos[None, :] - pos[:, None], cfg.rel_buckets,
                          cfg.rel_max_distance)
    table = params["relative_attention_bias"]["weight"]
    bias = table[buckets].permute(2, 0, 1)[None]           # (1, H, n, n)
    for lyr in params["block"]:
        hn = rms_norm(h, lyr["layer_norm0"]["weight"])
        a = lyr["SelfAttention"]
        q, k, v = (split_heads(qlinear(hn, a[name]["weight"]), cfg.num_heads)
                   for name in ("q", "k", "v"))
        o = _t5_attention(q, k, v, bias, dict(attn_config or {}))
        h = h + qlinear(o, a["o"]["weight"])
        hn = rms_norm(h, lyr["layer_norm1"]["weight"])
        ff = lyr["DenseReluDense"]
        g0 = gelu(qlinear(hn, ff["wi_0"]["weight"]))
        h = h + qlinear(g0 * qlinear(hn, ff["wi_1"]["weight"]),
                        ff["wo"]["weight"])
    return rms_norm(h, params["final_layer_norm"]["weight"])


def _t5_attention(q, k, v, bias, attn_cfg):
    """T5 attention: the bias as an additive mask and no 1/sqrt(d)."""
    out = quantized_attention(
        q, k, v, attn_mask=bias, scale=1.0,
        matmul_dtype=attn_cfg.get("matmul_dtype", "auto"),
        pv_matmul_dtype=attn_cfg.get("pv_matmul_dtype"), out_dtype=q.dtype)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)
