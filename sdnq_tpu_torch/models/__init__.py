"""Models over nested dicts of tensors and QTensors."""

from .dit import (
    FLUX_DEV_CONFIG, FLUX_TINY_CONFIG, DiTConfig, dit_forward, init_dit,
    make_rope_freqs, make_staged_dit_forward, stack_dit_blocks,
    unstack_dit_blocks,
)
from .llm import (
    LLAMA3_8B_CONFIG, LLM_TINY_CONFIG, LLMConfig, generate, init_cache,
    init_llm, init_llm_layer, llm_forward, stack_llm_blocks,
)
from .moe import (
    MOE_TINY_CONFIG, MoEConfig, init_moe, moe_ffn, qlinear_batched,
    quantize_moe, shard_moe,
)
from .text_encoder import (
    CLIP_TINY_CONFIG, T5_TINY_CONFIG, CLIPConfig, T5Config, clip_encode,
    init_clip, init_t5, init_t5_layer, t5_encode,
)
from .unet import (
    SD15_CONFIG, SDXL_CONFIG, UNET_TINY_CONFIG, UNetConfig, init_unet,
    make_staged_unet_forward, unet_forward,
)
from .vae import (
    SD_VAE_CONFIG, VAE_TINY_CONFIG, VAEConfig, init_vae, vae_decode,
    vae_encode,
)

__all__ = ["DiTConfig", "FLUX_DEV_CONFIG", "FLUX_TINY_CONFIG", "init_dit",
           "dit_forward", "make_rope_freqs", "make_staged_dit_forward",
           "stack_dit_blocks", "unstack_dit_blocks", "LLMConfig", "LLM_TINY_CONFIG",
           "LLAMA3_8B_CONFIG", "init_llm", "init_llm_layer", "init_cache",
           "llm_forward", "generate", "CLIPConfig", "T5Config",
           "CLIP_TINY_CONFIG", "T5_TINY_CONFIG", "init_clip", "clip_encode",
           "init_t5", "init_t5_layer", "t5_encode", "VAEConfig",
           "SD_VAE_CONFIG", "VAE_TINY_CONFIG", "init_vae", "vae_decode",
           "vae_encode", "UNetConfig", "SD15_CONFIG", "SDXL_CONFIG",
           "UNET_TINY_CONFIG", "init_unet", "unet_forward",
           "make_staged_unet_forward", "MoEConfig", "MOE_TINY_CONFIG",
           "init_moe", "quantize_moe", "qlinear_batched", "moe_ffn",
           "shard_moe", "stack_llm_blocks"]
