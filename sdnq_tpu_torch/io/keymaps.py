"""HF checkpoint key maps into the models' parameter trees, and loaders.

The JAX package's ``io.keymaps``: each ``*_key_map`` maps one
architecture's safetensors keys (transformers' LlamaForCausalLM,
CLIPTextModel and T5EncoderModel; diffusers' UNet2DConditionModel,
FluxTransformer2DModel and AutoencoderKL) to the dotted paths of the trees
in ``models/``; each ``*_config_from_hf`` reads ``config.json``; each
``load_*`` streams a checkpoint directory to the device (the card unless
the CPU is asked for), quantizing the eligible weights there.  Under
``strict`` (the default) a key that nothing consumes, or a tree that does
not match the model's structure, raises.  The structure comes from the
model's init on the meta device: shapes only, nothing drawn or stored.
"""

from __future__ import annotations

import json
import os

import torch

from ..apply import quantize_model
from ..config import QuantConfig
from ..kernels.dispatch import resolve_device
from .hf import (assemble_params, check_tree_coverage,
                 load_and_quantize_state_dict, raise_unconsumed,
                 stream_state_dict)

__all__ = ["llama_key_map", "clip_text_key_map", "sd_unet_key_map",
           "flux_key_map", "fuse_flux_params", "flux_config_from_hf",
           "llama_config_from_hf", "clip_config_from_hf",
           "load_llama", "load_clip_text", "load_flux",
           "t5_key_map", "t5_config_from_hf", "load_t5",
           "vae_key_map", "vae_config_from_hf", "load_vae"]


class _ShapesOnly(torch.overrides.TorchFunctionMode):
    """``torch.randn`` as ``torch.empty``: a seeded draw on the meta
    device goes through Python decompositions, whose first use imports
    ``torch._dynamo`` (seconds), where the structure needs shapes only."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.randn:
            kwargs.pop("generator", None)
            return torch.empty(*args, **kwargs)
        return func(*args, **kwargs)


def _structure(init, cfg):
    """The model's parameter tree on the meta device: its paths and
    shapes, no storage."""
    with _ShapesOnly():
        return init(cfg, device="meta", generator=torch.Generator())


def llama_key_map(key: str) -> str | None:
    """transformers LlamaForCausalLM -> models/llm.py tree: ``model.``
    goes, ``lm_head`` stays, rotary buffers are dropped."""
    if "rotary_emb" in key:
        return None
    if key.startswith("model."):
        return key[len("model."):]
    if key.startswith("lm_head."):
        return key
    return None


def clip_text_key_map(key: str) -> str | None:
    """transformers CLIPTextModel -> models/text_encoder.py CLIP tree."""
    if "position_ids" in key:
        return None
    if key.startswith("text_model."):
        key = key[len("text_model."):]
    if key.startswith("encoder.layers."):
        return key[len("encoder."):]
    if key.startswith(("embeddings.", "final_layer_norm.")):
        return key
    return None


def sd_unet_key_map(key: str) -> str | None:
    """diffusers UNet2DConditionModel -> the UNet tree (diffusers' names,
    so an identity that drops the norms' running statistics)."""
    if key.endswith((".running_mean", ".running_var", ".num_batches_tracked")):
        return None
    return key


def _read_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def llama_config_from_hf(path: str):
    from ..models.llm import LLMConfig
    c = _read_hf_config(path)
    heads = c["num_attention_heads"]
    return LLMConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=c.get("num_key_value_heads", heads),
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        ff_dim=c["intermediate_size"],
        rope_theta=c.get("rope_theta", 10000.0),
        tie_embeddings=c.get("tie_word_embeddings", False),
    )


def clip_config_from_hf(path: str):
    from ..models.text_encoder import CLIPConfig
    c = _read_hf_config(path)
    if "text_config" in c:
        c = c["text_config"]
    return CLIPConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        max_positions=c["max_position_embeddings"],
        intermediate=c["intermediate_size"],
    )


def load_llama(path: str, config: QuantConfig | None = None,
               dtype=torch.bfloat16, generator=None, strict: bool = True,
               device=None):
    """Stream and quantize a transformers Llama checkpoint directory.
    Returns (params, LLMConfig, QuantConfig)."""
    from ..models.llm import init_llm
    llm_cfg = llama_config_from_hf(path)
    params, config = load_and_quantize_state_dict(
        path, config, arch="llama", key_map=llama_key_map,
        kinds={"embed_tokens.weight": "embedding"}, dtype=dtype,
        generator=generator, known_skips=("rotary_emb",), strict=strict,
        device=device)
    if strict:
        check_tree_coverage(params, _structure(init_llm, llm_cfg),
                            what="llama")
    if llm_cfg.tie_embeddings and "lm_head" not in params:
        params["lm_head"] = {"weight": params["embed_tokens"]["weight"]}
    return params, llm_cfg, config


def load_clip_text(path: str, config: QuantConfig | None = None,
                   dtype=torch.bfloat16, generator=None, strict: bool = True,
                   device=None):
    """Stream and quantize a transformers CLIPTextModel checkpoint
    directory.  Returns (params, CLIPConfig, QuantConfig)."""
    from ..models.text_encoder import init_clip
    clip_cfg = clip_config_from_hf(path)
    params, config = load_and_quantize_state_dict(
        path, config, arch="clip", key_map=clip_text_key_map,
        kinds={"embeddings.token_embedding.weight": "embedding",
               "embeddings.position_embedding.weight": "embedding"},
        dtype=dtype, generator=generator,
        known_skips=("position_ids", "text_projection", "logit_scale"),
        strict=strict, device=device)
    if strict:
        check_tree_coverage(params, _structure(init_clip, clip_cfg),
                            what="clip")
    return params, clip_cfg, config


# ---------------------------------------------------------------------------
# Flux (diffusers FluxTransformer2DModel -> models/dit.py tree)
# ---------------------------------------------------------------------------

_FLUX_TOP = {
    "time_text_embed.timestep_embedder.linear_1": "time_in.fc1",
    "time_text_embed.timestep_embedder.linear_2": "time_in.fc2",
    "time_text_embed.text_embedder.linear_1": "vector_in.fc1",
    "time_text_embed.text_embedder.linear_2": "vector_in.fc2",
    "time_text_embed.guidance_embedder.linear_1": "guidance_in.fc1",
    "time_text_embed.guidance_embedder.linear_2": "guidance_in.fc2",
}

_FLUX_DOUBLE = {
    "norm1.linear": "img_mod.linear",
    "norm1_context.linear": "txt_mod.linear",
    "attn.to_q": "img_attn.q", "attn.to_k": "img_attn.k",
    "attn.to_v": "img_attn.v",
    "attn.norm_q": "img_attn.norm_q", "attn.norm_k": "img_attn.norm_k",
    "attn.add_q_proj": "txt_attn.q", "attn.add_k_proj": "txt_attn.k",
    "attn.add_v_proj": "txt_attn.v",
    "attn.norm_added_q": "txt_attn.norm_q",
    "attn.norm_added_k": "txt_attn.norm_k",
    "attn.to_out.0": "img_attn.proj", "attn.to_add_out": "txt_attn.proj",
    "ff.net.0.proj": "img_mlp.fc1", "ff.net.2": "img_mlp.fc2",
    "ff_context.net.0.proj": "txt_mlp.fc1", "ff_context.net.2": "txt_mlp.fc2",
}

_FLUX_SINGLE = {
    "norm.linear": "norm.linear",
    "attn.to_q": "q", "attn.to_k": "k", "attn.to_v": "v",
    "attn.norm_q": "norm_q", "attn.norm_k": "norm_k",
    "proj_mlp": "mlp_in",
    "proj_out": "linear2",
}


def flux_key_map(key: str) -> str | None:
    """diffusers FluxTransformer2DModel -> models/dit.py tree.

    The separate to_q / to_k / to_v (and the single blocks' proj_mlp) land
    on staging names that ``fuse_flux_params`` concatenates into the fused
    qkv / linear1 operands of the forward."""
    leaf = key.rsplit(".", 1)[-1]            # weight / bias
    stem = key[: -(len(leaf) + 1)]
    if stem in ("x_embedder", "context_embedder", "proj_out",
                "norm_out.linear"):
        return key
    if stem in _FLUX_TOP:
        return f"{_FLUX_TOP[stem]}.{leaf}"
    for prefix, table in (("transformer_blocks.", _FLUX_DOUBLE),
                          ("single_transformer_blocks.", _FLUX_SINGLE)):
        if stem.startswith(prefix):
            rest = stem[len(prefix):]
            idx, sub = rest.split(".", 1)
            if sub in table:
                return f"{prefix}{idx}.{table[sub]}.{leaf}"
            return None
    return None


def _concat_linear(parts, names):
    out = {"weight": torch.cat([parts[n]["weight"] for n in names], 0)}
    if "bias" in parts[names[0]]:
        out["bias"] = torch.cat([parts[n]["bias"] for n in names], 0)
    return out


def fuse_flux_params(params: dict) -> dict:
    """After ``flux_key_map``'s assembly: fuse q / k / v (and mlp_in) into
    the qkv / linear1 operands, and swap norm_out's rows from diffusers'
    [scale, shift] (AdaLayerNormContinuous) to the tree's [shift, scale]."""
    for blk in params.get("transformer_blocks", []):
        for attn_name in ("img_attn", "txt_attn"):
            attn = blk[attn_name]
            attn["qkv"] = _concat_linear(attn, ("q", "k", "v"))
            for n in ("q", "k", "v"):
                del attn[n]
    for blk in params.get("single_transformer_blocks", []):
        blk["linear1"] = _concat_linear(blk, ("q", "k", "v", "mlp_in"))
        for n in ("q", "k", "v", "mlp_in"):
            del blk[n]
    no = params["norm_out"]["linear"]
    h = no["weight"].shape[0] // 2
    no["weight"] = torch.cat([no["weight"][h:], no["weight"][:h]], 0)
    if "bias" in no:
        no["bias"] = torch.cat([no["bias"][h:], no["bias"][:h]], 0)
    return params


def flux_config_from_hf(path: str):
    from ..models.dit import DiTConfig
    c = _read_hf_config(path)
    heads = c.get("num_attention_heads", 24)
    hd = c.get("attention_head_dim", 128)
    return DiTConfig(
        in_channels=c.get("in_channels", 64),
        hidden_size=heads * hd,
        num_heads=heads,
        depth_double=c.get("num_layers", 19),
        depth_single=c.get("num_single_layers", 38),
        txt_dim=c.get("joint_attention_dim", 4096),
        vec_dim=c.get("pooled_projection_dim", 768),
        axes_dims=tuple(c.get("axes_dims_rope", (16, 56, 56))),
        guidance_embed=c.get("guidance_embeds", True),
    )


def load_flux(path: str, config: QuantConfig | None = None,
              dtype=torch.bfloat16, generator=None, strict: bool = True,
              device=None):
    """Stream a diffusers Flux transformer checkpoint to ``device`` in
    ``dtype``, fuse q / k / v into the forward's operands, then quantize
    (fusing must come first, so the tree is assembled and then handed to
    ``quantize_model``).  Returns (qparams, DiTConfig, QuantConfig)."""
    from ..models.dit import init_dit
    device = resolve_device(device)
    dit_cfg = flux_config_from_hf(path)
    if config is None:
        config = QuantConfig()
    unmapped: list[str] = []

    def items():
        for key, tensor in stream_state_dict(path):
            mapped = flux_key_map(key)
            if mapped is None:
                unmapped.append(key)
                continue
            yield mapped, tensor.to(device=device, dtype=dtype)

    params = assemble_params(items())
    if strict:   # before the fuse, which would fail on a renamed key
        raise_unconsumed(unmapped, "flux", "flux_key_map")
    params = fuse_flux_params(params)
    if strict:
        check_tree_coverage(params, _structure(init_dit, dit_cfg),
                            what="flux")
    qparams, config = quantize_model(params, config,
                                     arch="FluxTransformer2DModel",
                                     generator=generator, device=device)
    return qparams, dit_cfg, config


# ---------------------------------------------------------------------------
# T5 encoder (transformers T5EncoderModel -> models/text_encoder.py T5 tree)
# ---------------------------------------------------------------------------

def t5_key_map(key: str) -> str | None:
    """transformers T5EncoderModel -> models/text_encoder.py T5 tree.

    ``encoder.block.N.layer.0.*`` (self-attention and its layer_norm) and
    ``layer.1.*`` (the gated-gelu DenseReluDense) flatten into one block;
    the relative-attention bias table of block 0 moves to the root."""
    if key == "shared.weight":
        return key
    if key == "encoder.embed_tokens.weight":
        return None                      # the same table as shared.weight
    if key == "encoder.final_layer_norm.weight":
        return "final_layer_norm.weight"
    if key.startswith("encoder.block."):
        rest = key[len("encoder.block."):]
        idx, sub = rest.split(".", 1)
        if sub == "layer.0.SelfAttention.relative_attention_bias.weight":
            return "relative_attention_bias.weight"
        if sub.startswith("layer.0.SelfAttention."):
            return f"block.{idx}.SelfAttention." \
                   f"{sub[len('layer.0.SelfAttention.'):]}"
        if sub == "layer.0.layer_norm.weight":
            return f"block.{idx}.layer_norm0.weight"
        if sub.startswith("layer.1.DenseReluDense."):
            return f"block.{idx}.DenseReluDense." \
                   f"{sub[len('layer.1.DenseReluDense.'):]}"
        if sub == "layer.1.layer_norm.weight":
            return f"block.{idx}.layer_norm1.weight"
    return None


def t5_config_from_hf(path: str):
    from ..models.text_encoder import T5Config
    c = _read_hf_config(path)
    return T5Config(
        vocab_size=c["vocab_size"],
        hidden_size=c["d_model"],
        num_layers=c["num_layers"],
        num_heads=c["num_heads"],
        head_dim=c.get("d_kv", c["d_model"] // c["num_heads"]),
        ff_dim=c["d_ff"],
        rel_buckets=c.get("relative_attention_num_buckets", 32),
        rel_max_distance=c.get("relative_attention_max_distance", 128),
    )


def load_t5(path: str, config: QuantConfig | None = None,
            dtype=torch.bfloat16, generator=None, strict: bool = True,
            device=None):
    """Stream and quantize a transformers T5EncoderModel checkpoint
    directory.  Returns (params, T5Config, QuantConfig)."""
    from ..models.text_encoder import init_t5
    t5_cfg = t5_config_from_hf(path)
    params, config = load_and_quantize_state_dict(
        path, config, arch="t5", key_map=t5_key_map,
        kinds={"shared.weight": "embedding",
               "relative_attention_bias.weight": "embedding"},
        dtype=dtype, generator=generator,
        known_skips=("encoder.embed_tokens.weight",), strict=strict,
        device=device)
    if strict:
        check_tree_coverage(params, _structure(init_t5, t5_cfg), what="t5")
    return params, t5_cfg, config


# ---------------------------------------------------------------------------
# VAE (diffusers AutoencoderKL -> models/vae.py tree)
# ---------------------------------------------------------------------------

def vae_key_map(key: str) -> str | None:
    """diffusers AutoencoderKL -> models/vae.py tree: the attention blocks'
    ``to_out.0`` becomes ``to_out``, and pre-0.19 diffusers'
    ``.query/.key/.value/.proj_attn`` become ``to_q/to_k/to_v/to_out``;
    ``quant_conv`` / ``post_quant_conv`` stay at the root."""
    if key.endswith((".running_mean", ".running_var",
                     ".num_batches_tracked")):
        return None
    key = key.replace(".to_out.0.", ".to_out.")
    for old, new in ((".query.", ".to_q."), (".key.", ".to_k."),
                     (".value.", ".to_v."), (".proj_attn.", ".to_out.")):
        key = key.replace(old, new)
    return key


def vae_config_from_hf(path: str):
    from ..models.vae import VAEConfig
    c = _read_hf_config(path)
    mults = [bc // c["block_out_channels"][0]
             for bc in c["block_out_channels"]]
    return VAEConfig(
        latent_channels=c.get("latent_channels", 4),
        base_channels=c["block_out_channels"][0],
        channel_mults=tuple(mults),
        layers_per_block=c.get("layers_per_block", 2),
        out_channels=c.get("out_channels", 3),
        norm_groups=c.get("norm_num_groups", 32),
        scaling_factor=c.get("scaling_factor", 0.18215),
    )


def load_vae(path: str, config: QuantConfig | None = None,
             dtype=torch.bfloat16, generator=None, strict: bool = True,
             device=None):
    """Stream and quantize a diffusers AutoencoderKL checkpoint directory
    (OIHW conv weights; left unquantized under the VAE skip keys unless
    the QuantConfig says otherwise).  Returns (params, VAEConfig,
    QuantConfig)."""
    from ..models.vae import init_vae
    vae_cfg = vae_config_from_hf(path)
    params, config = load_and_quantize_state_dict(
        path, config, arch="vae", key_map=vae_key_map, dtype=dtype,
        generator=generator,
        known_skips=(".running_mean", ".running_var",
                     ".num_batches_tracked"),
        strict=strict, device=device)
    if strict:
        check_tree_coverage(params, _structure(init_vae, vae_cfg),
                            what="vae",
                            optional=("quant_conv", "post_quant_conv"))
    return params, vae_cfg, config
