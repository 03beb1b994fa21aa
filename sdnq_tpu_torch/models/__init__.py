"""Models over nested dicts of tensors and QTensors."""

from .dit import (
    FLUX_DEV_CONFIG, FLUX_TINY_CONFIG, DiTConfig, dit_forward, init_dit,
    make_rope_freqs,
)
from .llm import (
    LLAMA3_8B_CONFIG, LLM_TINY_CONFIG, LLMConfig, generate, init_cache,
    init_llm, init_llm_layer, llm_forward,
)

__all__ = ["DiTConfig", "FLUX_DEV_CONFIG", "FLUX_TINY_CONFIG", "init_dit",
           "dit_forward", "make_rope_freqs", "LLMConfig", "LLM_TINY_CONFIG",
           "LLAMA3_8B_CONFIG", "init_llm", "init_llm_layer", "init_cache",
           "llm_forward", "generate"]
