"""Llama-style decoder LM with quantized weights and a static KV cache.

The JAX package's ``models.llm`` over torch tensors: GQA, rotary
embeddings in the rotate-half convention, SwiGLU, rms norms (eps 1e-6, as
the JAX package fixes it), a static KV cache in bf16 or int8 (int8 rows and
per-token scales, quantized once at insert), and greedy decoding.  Parameter
names follow transformers' LlamaForCausalLM, so the skip-key registry
applies (``lm_head`` stays unquantized).  Blocks are lists.

Differences from the JAX package, same results:
* the 8 KV heads reach attention un-repeated (the kernel groups the query
  heads, ``b // q_per_kv``) where the JAX model repeats them per step;
* caches are updated in place at ``cache_len`` (the JAX model returns new
  arrays), so a decode step copies no cache.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels.attention import quantize_kv, quantized_attention
from ..kernels.dispatch import check_device, resolve_device
from ..layers import qembedding, qlinear
from .common import Params, linear_init, rms_norm, split_heads

__all__ = ["LLMConfig", "LLM_TINY_CONFIG", "LLAMA3_8B_CONFIG", "init_llm",
           "stack_llm_blocks",
           "init_llm_layer", "init_cache", "llm_forward", "generate"]


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    ff_dim: int = 11008
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # "bfloat16" or "int8": int8 stores per-token-quantized K/V rows and
    # their scales, which attention consumes directly
    kv_cache_dtype: str = "bfloat16"


LLM_TINY_CONFIG = LLMConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=32,
                            ff_dim=256)

# meta-llama/Meta-Llama-3-8B config.json: hidden 4096, 32 layers, 32 heads
# and 8 KV heads of 128, intermediate 14336, vocab 128256, rope_theta
# 500000, untied embeddings, no rope scaling
LLAMA3_8B_CONFIG = LLMConfig(vocab_size=128256, hidden_size=4096,
                             num_layers=32, num_heads=32, num_kv_heads=8,
                             head_dim=128, ff_dim=14336, rope_theta=500000.0)


def init_llm_layer(cfg: LLMConfig, *, generator: torch.Generator, device,
                   dtype=torch.float32) -> Params:
    """One decoder layer's random parameters, drawn on ``device``."""
    kw = dict(generator=generator, device=device, dtype=dtype, bias=False)
    d = cfg.hidden_size
    inner = cfg.num_heads * cfg.head_dim
    kv_inner = cfg.num_kv_heads * cfg.head_dim

    def ones():
        return {"weight": torch.ones((d,), device=device, dtype=dtype)}

    return {
        "input_layernorm": ones(),
        "self_attn": {"q_proj": linear_init(d, inner, **kw),
                      "k_proj": linear_init(d, kv_inner, **kw),
                      "v_proj": linear_init(d, kv_inner, **kw),
                      "o_proj": linear_init(inner, d, **kw)},
        "post_attention_layernorm": ones(),
        "mlp": {"gate_proj": linear_init(d, cfg.ff_dim, **kw),
                "up_proj": linear_init(d, cfg.ff_dim, **kw),
                "down_proj": linear_init(cfg.ff_dim, d, **kw)},
    }


def init_llm(cfg: LLMConfig = LLM_TINY_CONFIG, *,
             generator: torch.Generator | None = None, device=None,
             dtype=torch.float32) -> Params:
    """Random parameters drawn on ``device`` (the card by default) from
    ``generator`` (seeded 0 when omitted).  Llama-3-8B is 16 GB in bf16:
    build it layer by layer (``init_llm_layer``) and quantize each layer
    as it is made."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = cfg.hidden_size
    emb = torch.randn((cfg.vocab_size, d), generator=generator, device=device,
                      dtype=dtype).mul_(0.02)
    p: Params = {"embed_tokens": {"weight": emb}, "layers": [],
                 "norm": {"weight": torch.ones((d,), device=device,
                                               dtype=dtype)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = linear_init(d, cfg.vocab_size, generator=generator,
                                   device=device, dtype=dtype, bias=False)
    for _ in range(cfg.num_layers):
        p["layers"].append(init_llm_layer(cfg, generator=generator,
                                          device=device, dtype=dtype))
    return p


def _rope_tables(positions, head_dim: int, theta: float):
    """cos, sin (B, N, head_dim / 2) in fp32 at integer ``positions``."""
    scale = torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=positions.device) / head_dim
    inv = 1.0 / (theta ** scale)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    """Rotate-half convention (transformers' LlamaRotaryEmbedding): the
    head dim splits in two halves.  x (B, H, N, D); cos / sin (B or 1, N,
    D/2)."""
    xf = x.float()
    d2 = xf.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _put(cache_t, new, at: int):
    cache_t[:, :, at:at + new.shape[2]] = new.to(cache_t.dtype)


def _attn_with_cache(a, x, cfg, positions, cache, attn_cfg):
    b, n, _ = x.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    q = split_heads(qlinear(x, a["q_proj"]["weight"]), h)
    k = split_heads(qlinear(x, a["k_proj"]["weight"]), kvh)
    v = split_heads(qlinear(x, a["v_proj"]["weight"]), kvh)
    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)

    kv_scales = mask = new_cache = None
    if cache is not None:
        if len(cache) == 5:  # int8 rows + per-token scales
            ck, cks, cv, cvs, cache_len = cache
            k_q, k_s, v_q, v_s = quantize_kv(k, v)
            for c, new in ((ck, k_q), (cks, k_s), (cv, v_q), (cvs, v_s)):
                _put(c, new, cache_len)
            kv_scales = (cks, cvs)
            new_cache = (ck, cks, cv, cvs, cache_len + n)
        else:
            ck, cv, cache_len = cache
            _put(ck, k, cache_len)
            _put(cv, v, cache_len)
            new_cache = (ck, cv, cache_len + n)
        k, v = ck, cv
        key_pos = torch.arange(ck.shape[2], device=x.device)
        mask = (key_pos[None, None, :] <= positions[..., None])[:, None]

    acfg = attn_cfg or {}
    out = quantized_attention(
        q, k, v, attn_mask=mask, is_causal=cache is None,
        matmul_dtype=acfg.get("matmul_dtype", "auto"),
        pv_matmul_dtype=acfg.get("pv_matmul_dtype"), out_dtype=x.dtype,
        kv_scales=kv_scales)
    out = out.transpose(1, 2).reshape(b, n, h * cfg.head_dim)
    return qlinear(out, a["o_proj"]["weight"]), new_cache


def _block(blk, x, cfg, positions, cache, attn_cfg):
    xa = rms_norm(x, blk["input_layernorm"]["weight"])
    attn_out, cache = _attn_with_cache(blk["self_attn"], xa, cfg, positions,
                                       cache, attn_cfg)
    x = x + attn_out
    xm = rms_norm(x, blk["post_attention_layernorm"]["weight"])
    m = blk["mlp"]
    g = F.silu(qlinear(xm, m["gate_proj"]["weight"]))
    u = qlinear(xm, m["up_proj"]["weight"])
    x = x + qlinear(g * u, m["down_proj"]["weight"])
    return x, cache


def llm_forward(params: Params, input_ids, cfg: LLMConfig, *,
                positions=None, caches=None, attn_config=None, device=None):
    """Returns (logits (B, N, vocab), new_caches).  ``caches``: a list per
    layer of (k (B, KVH, MAX, D), v, length) or the int8 5-tuples of
    ``init_cache``, updated in place; None for the cache-free causal
    forward (new_caches is then None).  ``input_ids`` must lie on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    check_device(input_ids, device, "input_ids")
    b, n = input_ids.shape
    if positions is None:
        positions = torch.arange(n, device=device)[None].expand(b, n)
    x = qembedding(input_ids, params["embed_tokens"]["weight"])
    new_caches = []
    for i, blk in enumerate(params["layers"]):
        cache = caches[i] if caches is not None else None
        x, cache = _block(blk, x, cfg, positions, cache, attn_config)
        new_caches.append(cache)
    x = rms_norm(x, params["norm"]["weight"])
    head = params["lm_head"] if "lm_head" in params else params[
        "embed_tokens"]
    logits = qlinear(x, head["weight"])
    return logits, (new_caches if caches is not None else None)


def init_cache(cfg: LLMConfig, batch: int, max_len: int, dtype=None, *,
               device=None):
    """Static KV cache per layer.  ``dtype`` None follows
    ``cfg.kv_cache_dtype``; "int8" caches are 5-tuples (k_q, k_scale, v_q,
    v_scale, len) of int8 rows and fp32 per-token scales, others 3-tuples
    (k, v, len)."""
    device = resolve_device(device)
    dtype = cfg.kv_cache_dtype if dtype is None else dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    if dtype == torch.int8:
        return [(z(shape, torch.int8), z(shape[:3], torch.float32),
                 z(shape, torch.int8), z(shape[:3], torch.float32), 0)
                for _ in range(cfg.num_layers)]
    return [(z(shape, dtype), z(shape, dtype), 0)
            for _ in range(cfg.num_layers)]


@torch.no_grad()
def generate(params, prompt_ids, cfg: LLMConfig, *, max_new_tokens: int = 16,
             attn_config=None, device=None):
    """Greedy decoding with a static KV cache of prompt + max_new_tokens
    positions: one prefill, then one single-token step per new token.
    Returns the new tokens (B, max_new_tokens)."""
    device = resolve_device(device)
    b, n0 = prompt_ids.shape
    caches = init_cache(cfg, b, n0 + max_new_tokens, device=device)
    logits, caches = llm_forward(params, prompt_ids, cfg, caches=caches,
                                 attn_config=attn_config, device=device)
    tok = torch.argmax(logits[:, -1], dim=-1)
    toks = [tok]
    for pos in range(n0, n0 + max_new_tokens - 1):
        logits, caches = llm_forward(
            params, tok[:, None], cfg,
            positions=torch.full((b, 1), pos, device=device),
            caches=caches, attn_config=attn_config, device=device)
        tok = torch.argmax(logits[:, -1], dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def stack_llm_blocks(params: Params) -> Params:
    """The JAX package's ``stack_llm_blocks``: decoder layers of one
    structure stacked into one tree whose leaves carry a leading layer
    axis (a copy, once; QTensors component by component under one layer's
    meta), the layout ``parallel.pipeline`` stages over.  Layers of
    different structures stay a list; ``llm_forward`` takes the list."""
    from .dit import _stack, _structure
    out = dict(params)
    layers = params.get("layers")
    if isinstance(layers, list) and layers:
        defs = [_structure(b) for b in layers]
        if all(d == defs[0] for d in defs[1:]):
            out["layers"] = _stack(layers)
    return out
