"""Name/shape quantization policy.

Parameter-name matching, the eligibility gates, and the per-architecture
skip-key registry carried over as data: the modules that must never be
quantized (embedders, modulation/AdaLN, proj_out, lm_head, ...).  The same
rules as the JAX package's ``policy`` module, over dotted parameter paths.
"""

from __future__ import annotations

import re

from .config import QuantConfig
from .formats import get_format

__all__ = [
    "check_param_name_in",
    "get_minimum_dtype",
    "quant_allowed",
    "quantized_matmul_allowed",
    "COMMON_SKIP_KEYS",
    "MODEL_SKIP_KEYS",
    "add_model_skip_keys",
    "layer_quant_kwargs",
]


def check_param_name_in(param_name: str, param_list) -> str | None:
    """Match semantics (reference utils.py:29-43):
    - ``.prefix`` entries match name prefixes;
    - exact matches;
    - bare component names match any dot-separated component;
    - ``*`` entries are glob patterns."""
    if not param_list:
        return None
    parts = param_name.split(".")
    for pat in param_list:
        if pat.startswith("."):
            if param_name.startswith(pat[1:]):
                return pat
            continue
        if param_name == pat or pat in parts:
            return pat
        glob = pat.replace(".*", "\\.*").replace("*", ".*")
        if "*" in pat and re.match(glob, param_name):
            return pat
    return None


def get_minimum_dtype(weights_dtype: str, param_name: str,
                      modules_dtype_dict: dict[str, list[str]]) -> str:
    """Per-module dtype override incl. ``minimum_6bit``-style floors
    (reference utils.py:98-119)."""
    for key, names in (modules_dtype_dict or {}).items():
        if check_param_name_in(param_name, names) is None:
            continue
        low = key.lower()
        if low.startswith("minimum") or low.endswith(("bit", "bits")):
            s = (low.removeprefix("minimum").removeprefix("-")
                 .removeprefix("_").removesuffix("bits").removesuffix("bit")
                 .removesuffix("-").removesuffix("_"))
            if s.startswith("uint"):
                unsigned, s = True, s.removeprefix("uint")
            else:
                unsigned, s = False, s.removeprefix("int")
            bits = int(s)
            if get_format(weights_dtype).num_bits < bits:
                if unsigned or bits <= 4:
                    return f"uint{bits}"
                return f"int{bits}"
        else:
            return key
    return weights_dtype


def quant_allowed(layer_kind: str, shape: tuple[int, ...],
                  config: QuantConfig) -> bool:
    """Eligibility gate (reference utils.py:46-63)."""
    if layer_kind == "embedding" and not config.quant_embedding:
        return False
    if layer_kind in ("conv", "conv_transpose") and not config.quant_conv:
        return False
    if layer_kind == "conv":
        channel = shape[1]
    elif layer_kind == "conv_transpose":
        channel = shape[0]
    else:
        channel = shape[-1]
    numel = 1
    for d in shape:
        numel *= d
    return (channel >= config.minimum_allowed_channel_size
            and numel >= config.minimum_allowed_numel)


def quantized_matmul_allowed(use_quantized_matmul: bool, out_ch: int,
                             in_ch: int) -> bool:
    """reference utils.py:66-71."""
    return bool(use_quantized_matmul and out_ch >= 32 and in_ch >= 32
                and out_ch % 16 == 0 and in_ch % 16 == 0)


# ---------------------------------------------------------------------------
# Architecture registry (data carried over from common.py:371-514; each row
# is the list of module name patterns to skip for that architecture).
# ---------------------------------------------------------------------------

COMMON_SKIP_KEYS = (
    ".time_embed", ".context_embedder", ".condition_embedder", ".x_embedder",
    ".t_embedder", ".y_embedder", ".emb_in", ".txt_in", ".img_in", ".vid_in",
    ".proj_out", ".norm_out", ".emb_out", ".txt_out", ".img_out", ".vid_out",
    ".final_layer", "multi_modal_projector", "time_text_embed",
    "patch_embedding", "patch_embed", "patch_emb", "lm_head", "wte",
)

MODEL_SKIP_KEYS: dict[str, list[str]] = {
    "FluxTransformer2DModel": [
        "single_transformer_blocks.0.norm.linear.weight", "time_text_embed",
        "time_embed", "context_embedder", "x_embedder", ".proj_out",
        "norm_out"],
    "Flux2Transformer2DModel": [
        "double_stream_modulation_img", "double_stream_modulation_txt",
        "single_stream_modulation", "time_guidance_embed",
        "context_embedder", "x_embedder", ".proj_out", "norm_out"],
    "ChromaTransformer2DModel": [
        "distilled_guidance_layer", "time_text_embed", "context_embedder",
        "x_embedder", ".proj_out", "norm_out"],
    "QwenImageTransformer2DModel": [
        "transformer_blocks.0.img_mod.1.weight", "time_text_embed", "txt_in",
        "img_in", "proj_out", "norm_out"],
    "WanTransformer3DModel": [
        "scale_shift_table", "patch_embedding", "condition_embedder",
        "proj_out", "norm_out"],
    "LongCatVideoTransformer3DModel": [
        "blocks.0.adaLN_modulation.1.weight", "x_embedder", "t_embedder",
        "y_embedder", "final_layer"],
    "LTX2VideoTransformer3DModel": [
        "audio_time_embed", "time_embed", "audio_caption_projection",
        "caption_projection", "proj_in", "audio_proj_in", "proj_out",
        "audio_proj_out", "av_cross_attn_audio_scale_shift",
        "av_cross_attn_audio_v2a_gate", "av_cross_attn_video_a2v_gate",
        "av_cross_attn_video_scale_shift"],
    "Lumina2Transformer2DModel": [
        "layers.0.norm1.linear.weight", "time_caption_embed", "x_embedder",
        "norm_out"],
    "ZImageTransformer2DModel": [
        "layers.0.adaLN_modulation.0.weight", "t_embedder", "cap_embedder",
        "siglip_embedder", "all_x_embedder", "all_final_layer"],
    "Ideogram4Transformer2DModel": [
        "layers.0.adaln_modulation.weight", "input_proj", "llm_cond_proj",
        "llm_cond_norm", "final_layer", "t_embedding", "adaln_proj",
        "embed_image_indicator"],
    "CosmosTransformer3DModel": [
        "transformer_blocks.0.norm*", "patch_embed", "time_embed",
        "norm_out", "proj_out", "crossattn_proj"],
    "GlmImageTransformer2DModel": [
        "transformer_blocks.0.norm1.linear.weight", "image_projector",
        "glyph_projector", "prior_projector", "time_condition_embed",
        "norm_out", "proj_out"],
    "GlmImageForConditionalGeneration": [
        "lm_head", "patch_embed", "embeddings", "embed_tokens", "vqmodel"],
    "HunyuanImage3ForCausalMM": [
        "lm_head", "patch_embed", "time_embed", "time_embed_2",
        "final_layer", "wte", "ln_f", "timestep_emb", "vae",
        "vision_aligner", "head", "post_layernorm", "embeddings"],
    "Emu3ForCausalLM": ["lm_head", "vq_model", "tokenizer"],
    "Gemma3nForCausalLM": [
        "lm_head", "correction_coefs", "prediction_coefs",
        "embedding_projection"],
    "Gemma4ForConditionalGeneration": [
        "lm_head", "embed_audio", "embed_vision", "patch_embedder",
        "embed_tokens", "subsample_conv_projection", "output_proj"],
    "MoondreamModel": [
        "lm_head", "region", "wte", "post_ln", "proj_mlp", "patch_emb",
        "pos_emb"],
    "NaDiT": [
        ".emb_in", ".txt_in", ".vid_in", ".emb_scale", ".vid_out",
        ".vid_out_norm", ".vid_out_ada"],
    "HiDreamO1Qwen3VLTransformer": [
        "lm_head", "embed_tokens", "x_embedder", "t_embedder1",
        "final_layer2", "patch_embed", "pos_embed"],
}
MODEL_SKIP_KEYS["LongCatImageTransformer2DModel"] = MODEL_SKIP_KEYS["FluxTransformer2DModel"]
MODEL_SKIP_KEYS["ChronoEditTransformer3DModel"] = MODEL_SKIP_KEYS["WanTransformer3DModel"]
MODEL_SKIP_KEYS["Gemma3nForConditionalGeneration"] = MODEL_SKIP_KEYS["Gemma3nForCausalLM"]
MODEL_SKIP_KEYS["HfMoondream"] = MODEL_SKIP_KEYS["MoondreamModel"]
MODEL_SKIP_KEYS["NaDiTUpscaler"] = MODEL_SKIP_KEYS["NaDiT"]
# Our own model zoo shares the generic skip keys.
MODEL_SKIP_KEYS["SD15UNet"] = list(COMMON_SKIP_KEYS)
MODEL_SKIP_KEYS["SDXLUNet"] = list(COMMON_SKIP_KEYS)


def add_model_skip_keys(config: QuantConfig, arch: str | None) -> QuantConfig:
    """Merge architecture skip keys into the config (reference
    utils.py:188-220)."""
    if not config.add_skip_keys:
        return config
    keys = MODEL_SKIP_KEYS.get(arch) if arch else None
    if keys is None:
        keys = list(COMMON_SKIP_KEYS)
    config.modules_to_not_convert = sorted(
        set(config.modules_to_not_convert) | set(keys))
    return config


def layer_quant_kwargs(config: QuantConfig, param_name: str,
                       layer_kind: str) -> dict:
    """Resolve the effective per-layer quantization kwargs
    (reference utils.py:122-171)."""
    kw = dict(
        fmt=config.weights_dtype,
        matmul_fmt=config.quantized_matmul_dtype,
        group_size=config.group_size,
        hadamard_group_size=config.hadamard_group_size,
        svd_rank=config.svd_rank,
        svd_steps=config.svd_steps,
        use_svd=config.use_svd,
        use_hadamard=config.use_hadamard,
        use_quantized_matmul=(
            config.use_quantized_matmul_conv
            if layer_kind in ("conv", "conv_transpose")
            else config.use_quantized_matmul),
        use_stochastic_rounding=config.use_stochastic_rounding,
        dequant_dtype=("float32" if config.dequantize_fp32
                       and config.dequant_dtype == "float32"
                       else config.dequant_dtype),
    )
    key = check_param_name_in(param_name, list(config.modules_quant_config))
    if key is not None:
        for k, v in config.modules_quant_config[key].items():
            if k == "weights_dtype":
                k = "fmt"
            if k == "quantized_matmul_dtype":
                k = "matmul_fmt"
            if k in kw:
                kw[k] = v
    kw["fmt"] = get_minimum_dtype(kw["fmt"], param_name,
                                  config.modules_dtype_dict)
    if check_param_name_in(param_name, config.modules_to_not_use_matmul):
        kw["use_quantized_matmul"] = False
    return kw
