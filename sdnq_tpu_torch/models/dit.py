"""Flux-style multimodal diffusion transformer (MMDiT).

The JAX package's ``models.dit`` over torch tensors: double-stream blocks
with separate image/text QKV and joint attention, then single-stream
blocks over the joined sequence, AdaLN-Zero modulation from timestep ⊕
guidance ⊕ pooled text, rope over (id, h, w).  Parameter names follow
diffusers' FluxTransformer2DModel, so the skip-key registry entry
"FluxTransformer2DModel" applies.

Blocks are lists, or stacked by ``stack_dit_blocks`` as the JAX package
stacks them for its scan (and as ``__graft_entry__`` runs the model): every
leaf gains a leading layer axis, QTensors component by component under one
layer's meta, and a first block whose structure differs (the Flux skip keys
leave block 0's modulation unquantized) stays apart as {"first", "rest"}.
``dit_forward`` walks a stack layer by layer through ``_index_stacked``,
whose leaves are views of the stacked storage: layer l of contiguous (L,
O, K) codes is itself contiguous, so the kernels read it where it lies and
no layer's weight is copied.  ``unstack_dit_blocks`` gives the block lists
back as such views.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dispatch import check_device, resolve_device
from ..layers import qlinear
from ..parallel.sharding import is_sharded
from ..tensor import QTensor, layer_view
from ..train.matmul import TrainQTensor
from .common import (
    Params, apply_rope, attention, gelu, layer_norm, linear_init, rms_norm,
    rope, silu, split_heads, timestep_embedding,
)

__all__ = ["DiTConfig", "init_dit", "dit_forward", "make_rope_freqs",
           "make_staged_dit_forward", "stack_dit_blocks",
           "unstack_dit_blocks", "FLUX_DEV_CONFIG", "FLUX_TINY_CONFIG"]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 64          # packed 2x2 latent patches
    hidden_size: int = 3072
    num_heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    txt_dim: int = 4096            # T5 features
    vec_dim: int = 768             # CLIP pooled
    mlp_ratio: float = 4.0
    guidance_embed: bool = True
    axes_dims: tuple = (16, 56, 56)  # rope dims per (id, h, w) axis
    theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# black-forest-labs/FLUX.1-dev transformer/config.json
FLUX_DEV_CONFIG = DiTConfig()
FLUX_TINY_CONFIG = DiTConfig(
    in_channels=16, hidden_size=256, num_heads=4, depth_double=2,
    depth_single=4, txt_dim=64, vec_dim=32, axes_dims=(16, 24, 24))


def init_dit(cfg: DiTConfig = FLUX_TINY_CONFIG, *,
             generator: torch.Generator | None = None, device=None,
             dtype=torch.float32) -> Params:
    """Random parameters drawn on ``device`` (the card by default) from
    ``generator`` (seeded 0 when omitted).  At FLUX.1-dev width build in
    bf16 (about 24 GB) and quantize with ``quantize_model``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device, dtype=dtype)
    d = cfg.hidden_size
    mlp_hidden = int(d * cfg.mlp_ratio)

    def mlp(i, hdn, o):
        return {"fc1": linear_init(i, hdn, **kw),
                "fc2": linear_init(hdn, o, **kw)}

    def ones(n):
        return {"weight": torch.ones((n,), device=device, dtype=dtype)}

    p: Params = {
        "x_embedder": linear_init(cfg.in_channels, d, **kw),
        "context_embedder": linear_init(cfg.txt_dim, d, **kw),
        "time_in": mlp(256, d, d),
        "vector_in": mlp(cfg.vec_dim, d, d),
        "norm_out": {"linear": linear_init(d, 2 * d, **kw)},
        "proj_out": linear_init(d, cfg.in_channels, **kw),
        "transformer_blocks": [],
        "single_transformer_blocks": [],
    }
    if cfg.guidance_embed:
        p["guidance_in"] = mlp(256, d, d)
    for _ in range(cfg.depth_double):
        p["transformer_blocks"].append({
            "img_mod": {"linear": linear_init(d, 6 * d, **kw)},
            "txt_mod": {"linear": linear_init(d, 6 * d, **kw)},
            "img_attn": {"qkv": linear_init(d, 3 * d, **kw),
                         "norm_q": ones(cfg.head_dim),
                         "norm_k": ones(cfg.head_dim),
                         "proj": linear_init(d, d, **kw)},
            "txt_attn": {"qkv": linear_init(d, 3 * d, **kw),
                         "norm_q": ones(cfg.head_dim),
                         "norm_k": ones(cfg.head_dim),
                         "proj": linear_init(d, d, **kw)},
            "img_mlp": mlp(d, mlp_hidden, d),
            "txt_mlp": mlp(d, mlp_hidden, d),
        })
    for _ in range(cfg.depth_single):
        p["single_transformer_blocks"].append({
            "norm": {"linear": linear_init(d, 3 * d, **kw)},
            "linear1": linear_init(d, 3 * d + mlp_hidden, **kw),
            "linear2": linear_init(d + mlp_hidden, d, **kw),
            "norm_q": ones(cfg.head_dim),
            "norm_k": ones(cfg.head_dim),
        })
    return p


def _lin(p, x, out_dtype=None, gather=False):
    """The layer ``p`` on x; a tensor-parallel shard (``parallel.tp``)
    runs its collectives, and with ``gather`` returns the whole output."""
    tp = p.get("tp")
    if tp is not None:
        return tp(p, x, out_dtype, gather)
    return qlinear(x, p["weight"], p.get("bias"), out_dtype=out_dtype)


def _heads(cfg, p) -> int:
    """The heads this rank holds: all of them, or their share over the
    ranks that the layer ``p`` (qkv or linear1) is split over."""
    tp = p.get("tp")
    t = 1 if tp is None else tp.size
    if cfg.num_heads % t:
        raise ValueError(f"{cfg.num_heads} heads do not divide over {t} "
                         "tensor ranks")
    return cfg.num_heads // t


def _modulation(params, vec, n_chunks):
    out = _lin(params["linear"], silu(vec), gather=True)
    return torch.chunk(out[:, None, :], n_chunks, dim=-1)


def _norm_weight(n):
    tp = n.get("tp")   # on sharded heads: the gradient summed over them
    return n["weight"] if tp is None else tp.comm.copy(n["weight"])


def _qk_norm(q, k, nq, nk):
    return rms_norm(q, _norm_weight(nq)), rms_norm(k, _norm_weight(nk))


def _gelu_mlp(mlp, x):
    return _lin(mlp["fc2"], gelu(_lin(mlp["fc1"], x)))


def _double_block(blk, img, txt, vec, freqs, cfg, attn_cfg):
    h = _heads(cfg, blk["img_attn"]["qkv"])
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = \
        _modulation(blk["img_mod"], vec, 6)
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = \
        _modulation(blk["txt_mod"], vec, 6)
    img_n = layer_norm(img) * (1 + i_scale1) + i_shift1
    txt_n = layer_norm(txt) * (1 + t_scale1) + t_shift1
    img_qkv = _lin(blk["img_attn"]["qkv"], img_n)
    txt_qkv = _lin(blk["txt_attn"]["qkv"], txt_n)
    iq, ik, iv = (split_heads(t, h) for t in torch.chunk(img_qkv, 3, -1))
    tq, tk, tv = (split_heads(t, h) for t in torch.chunk(txt_qkv, 3, -1))
    iq, ik = _qk_norm(iq, ik, blk["img_attn"]["norm_q"],
                      blk["img_attn"]["norm_k"])
    tq, tk = _qk_norm(tq, tk, blk["txt_attn"]["norm_q"],
                      blk["txt_attn"]["norm_k"])
    # joint attention over [txt ; img]
    q = apply_rope(torch.cat([tq, iq], dim=2), freqs)
    k = apply_rope(torch.cat([tk, ik], dim=2), freqs)
    v = torch.cat([tv, iv], dim=2)
    out = attention(q, k, v, attn_cfg)
    txt_len = txt.shape[1]
    txt_attn, img_attn = out[:, :txt_len], out[:, txt_len:]
    img = img + i_gate1 * _lin(blk["img_attn"]["proj"], img_attn)
    txt = txt + t_gate1 * _lin(blk["txt_attn"]["proj"], txt_attn)
    img = img + i_gate2 * _gelu_mlp(
        blk["img_mlp"], layer_norm(img) * (1 + i_scale2) + i_shift2)
    txt = txt + t_gate2 * _gelu_mlp(
        blk["txt_mlp"], layer_norm(txt) * (1 + t_scale2) + t_shift2)
    return img, txt


def _single_block(blk, x, vec, freqs, cfg, attn_cfg):
    h = _heads(cfg, blk["linear1"])
    d = h * cfg.head_dim
    shift, scale, gate = _modulation(blk["norm"], vec, 3)
    xn = layer_norm(x) * (1 + scale) + shift
    proj = _lin(blk["linear1"], xn)
    qkv, mlp_h = proj[..., :3 * d], proj[..., 3 * d:]
    q, k, v = (split_heads(t, h) for t in torch.chunk(qkv, 3, -1))
    q, k = _qk_norm(q, k, blk["norm_q"], blk["norm_k"])
    attn_out = attention(apply_rope(q, freqs), apply_rope(k, freqs), v,
                         attn_cfg)
    out = _lin(blk["linear2"], torch.cat([attn_out, gelu(mlp_h)], -1))
    return x + gate * out


def make_rope_freqs(cfg: DiTConfig, txt_len: int, img_hw: tuple[int, int],
                    device=None):
    """Position ids: text tokens at (i, 0, 0), image tokens at (0, y, x).
    Returns (1, 1, N, D/2, 2, 2)."""
    device = resolve_device(device)
    h, w = img_hw
    txt_ids = torch.zeros((txt_len, 3), dtype=torch.int32, device=device)
    txt_ids[:, 0] = torch.arange(txt_len, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    img_ids = torch.stack([torch.zeros_like(ys), ys, xs],
                          dim=-1).reshape(-1, 3)
    ids = torch.cat([txt_ids, img_ids.to(torch.int32)], dim=0)
    freqs = torch.cat([rope(ids[:, i], cfg.axes_dims[i], cfg.theta)
                       for i in range(3)], dim=-3)
    return freqs[None, None]


def _vec_mlp(p, x):
    return _lin(p["fc2"], silu(_lin(p["fc1"], x)))


# ---------------------------------------------------------------------------
# Stacked blocks
# ---------------------------------------------------------------------------

def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _structure(tree):
    """The tree's shape as JAX's tree_structure sees it: containers, and
    a QTensor's meta and which of its arrays are present."""
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(v) for v in tree)
    if isinstance(tree, QTensor):
        return ("QTensor", tree.meta, tree.zero_point is None,
                tree.svd_up is None)
    return "leaf"


def _stack(blocks):
    """Blocks of one structure -> one tree whose leaves carry a leading
    layer axis (a copy, once)."""
    def stack(*xs):
        x = xs[0]
        if isinstance(x, dict):
            return {k: stack(*(b[k] for b in xs)) for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(stack(*vs) for vs in zip(*xs))
        if isinstance(x, QTensor):
            def arr(name):
                a = getattr(x, name)
                return None if a is None else torch.stack(
                    [getattr(b, name) for b in xs])
            return QTensor(qdata=arr("qdata"), scale=arr("scale"),
                           zero_point=arr("zero_point"),
                           svd_up=arr("svd_up"), svd_down=arr("svd_down"),
                           meta=x.meta)
        return torch.stack(xs)
    return stack(*blocks)


def stack_dit_blocks(params: Params) -> Params:
    """The JAX package's ``stack_dit_blocks``: each block list of one
    structure becomes one stacked tree; where only block 0 differs, it
    stays apart ({"first": block 0, "rest": the stack}); otherwise (layers
    of different formats, e.g. after dynamic quantization) the list
    stays."""
    out = dict(params)
    for key in ("transformer_blocks", "single_transformer_blocks"):
        blocks = params.get(key)
        if not isinstance(blocks, list) or not blocks:
            continue
        structs = [_structure(b) for b in blocks]
        if all(st == structs[0] for st in structs[1:]):
            out[key] = _stack(blocks)
        elif len(blocks) > 2 and all(st == structs[1] for st in structs[2:]):
            out[key] = {"first": blocks[0], "rest": _stack(blocks[1:])}
    return out


def _index_stacked(tree, i: int):
    """Layer i of a stacked block tree: QTensors as ``layer_view``s, other
    leaves indexed; every leaf a view of the stacked storage."""
    def one(x):
        if isinstance(x, QTensor):
            return layer_view(x, i)
        if isinstance(x, TrainQTensor):
            return TrainQTensor(qt=layer_view(x.qt, i), delta=x.delta[i])
        return x[i] if isinstance(x, torch.Tensor) else x
    return _map(tree, one)


def _stack_len(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return (tree.qdata if isinstance(tree, QTensor) else tree).shape[0]


def _block_list(blocks) -> list:
    """A list of blocks, stacked ones as views of their layer."""
    if isinstance(blocks, list):
        return blocks
    first = []
    if isinstance(blocks, dict) and "first" in blocks:
        first, blocks = [blocks["first"]], blocks["rest"]
    return first + [_index_stacked(blocks, i)
                    for i in range(_stack_len(blocks))]


def unstack_dit_blocks(params: Params) -> Params:
    """Stacked block trees back as lists whose leaves are views of the
    stacked storage (no copy)."""
    out = dict(params)
    for key in ("transformer_blocks", "single_transformer_blocks"):
        if key in params:
            out[key] = _block_list(params[key])
    return out


def dit_forward(params: Params, img: torch.Tensor, txt: torch.Tensor,
                timesteps: torch.Tensor, pooled: torch.Tensor,
                cfg: DiTConfig, guidance: torch.Tensor | None = None,
                freqs: torch.Tensor | None = None,
                attn_config: dict | None = None, *, device=None):
    """img (B, N_img, in_channels) packed latent patches; txt (B, L,
    txt_dim); timesteps (B,) in [0, 1]; pooled (B, vec_dim).  The inputs
    must lie on ``device`` (the card by default)."""
    forward = make_staged_dit_forward(cfg, attn_config)
    return forward(params, img, txt, timesteps, pooled, guidance, freqs,
                   device=device)


def make_staged_dit_forward(cfg: DiTConfig, attn_config: dict | None = None):
    """The forward as four stages (embed, the double blocks, the single
    blocks, the head), as the JAX package's staged forward for its
    separately compiled programs; here each stage runs eagerly, and the
    block stages take lists or stacked trees.  Returns ``forward(params,
    img, txt, timesteps, pooled, guidance=None, freqs=None, *,
    device=None)``, which computes ``dit_forward``."""

    def embed(p, img, txt, timesteps, pooled, guidance):
        img = _lin(p["x_embedder"], img)
        txt = _lin(p["context_embedder"], txt)
        vec = _vec_mlp(p["time_in"], timestep_embedding(timesteps * 1000.0,
                                                        256))
        if cfg.guidance_embed and guidance is not None:
            vec = vec + _vec_mlp(p["guidance_in"],
                                 timestep_embedding(guidance * 1000.0, 256))
        vec = vec + _vec_mlp(p["vector_in"], pooled)
        return img, txt, vec.to(img.dtype)

    def run_double(blocks, img, txt, vec, freqs):
        for blk in _block_list(blocks):
            img, txt = _double_block(blk, img, txt, vec, freqs, cfg,
                                     attn_config)
        return img, txt

    def run_single(blocks, x, vec, freqs):
        for blk in _block_list(blocks):
            x = _single_block(blk, x, vec, freqs, cfg, attn_config)
        return x

    def head(p, x, txt, vec):
        img = x[:, txt.shape[1]:]
        shift, scale = _modulation(p["norm_out"], vec, 2)
        img = layer_norm(img) * (1 + scale) + shift
        return _lin(p["proj_out"], img)

    def forward(params, img, txt, timesteps, pooled, guidance=None,
                freqs=None, *, device=None):
        device = resolve_device(device)
        if is_sharded(params):   # shard_params' tree: this rank's shards
            from ..parallel.tp import local_tree
            params = local_tree(params)
        for name, t in (("img", img), ("txt", txt),
                        ("timesteps", timesteps), ("pooled", pooled)):
            check_device(t, device, name)
        img, txt, vec = embed(params, img, txt, timesteps, pooled, guidance)
        if freqs is None:
            n_img = img.shape[1]
            side = int(round(n_img ** 0.5))
            freqs = make_rope_freqs(cfg, txt.shape[1], (side, n_img // side),
                                    device=device)
        img, txt = run_double(params["transformer_blocks"], img, txt, vec,
                              freqs)
        x = run_single(params["single_transformer_blocks"],
                       torch.cat([txt, img], dim=1), vec, freqs)
        return head(params, x, txt, vec)

    return forward
