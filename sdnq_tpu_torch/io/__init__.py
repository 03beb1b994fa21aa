"""Model files: pre-quantized safetensors in the JAX package's layout, HF
checkpoints streamed and quantized on the device, and training
checkpoints.  The safetensors format is read and written by the port's own
code (``_safetensors``); neither the ``safetensors`` package nor
``transformers`` is imported."""

from .safetensors_io import save_quantized, load_quantized
from .checkpoint import save_checkpoint, restore_checkpoint
from .hf import (
    stream_state_dict, assemble_params, load_and_quantize_state_dict,
)
from .keymaps import (
    llama_key_map, clip_text_key_map, sd_unet_key_map,
    flux_key_map, fuse_flux_params, flux_config_from_hf,
    llama_config_from_hf, clip_config_from_hf, load_llama, load_clip_text,
    load_flux, t5_key_map, t5_config_from_hf, load_t5,
    vae_key_map, vae_config_from_hf, load_vae,
)

__all__ = ["save_quantized", "load_quantized", "save_checkpoint",
           "restore_checkpoint", "stream_state_dict", "assemble_params",
           "load_and_quantize_state_dict",
           "llama_key_map", "clip_text_key_map", "sd_unet_key_map",
           "flux_key_map", "fuse_flux_params", "flux_config_from_hf",
           "llama_config_from_hf", "clip_config_from_hf",
           "load_llama", "load_clip_text", "load_flux",
           "t5_key_map", "t5_config_from_hf", "load_t5",
           "vae_key_map", "vae_config_from_hf", "load_vae"]
