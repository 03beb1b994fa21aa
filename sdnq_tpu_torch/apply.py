"""Model-level quantization: every eligible weight of a nested dict/list of
tensors becomes a QTensor, under the skip-key registry and the eligibility
gates of ``policy`` (the JAX package's ``apply.quantize_model`` over the
same dotted parameter paths, e.g. ``single_transformer_blocks.0.norm.
linear.weight``).  Weights are quantized one at a time, so a model built in
bf16 never needs a float32 copy of more than one weight.  Under
``use_dynamic_quantization`` each weight climbs the format ladder
(``dynamic``) and the config records the choices, as in the JAX package:
``modules_dtype_dict`` (format -> paths), ``modules_to_not_convert`` (the
layers no format passed) and ``modules_to_not_use_matmul``.
"""

from __future__ import annotations

import torch

from .config import QuantConfig
from .envconfig import env_bool
from .kernels.dispatch import check_device, resolve_device
from .policy import (
    add_model_skip_keys, check_param_name_in, layer_quant_kwargs,
    quant_allowed, quantized_matmul_allowed,
)
from .dynamic import quantize_tensor_dynamic
from .tensor import QTensor, quantize_tensor

__all__ = ["quantize_model", "dequantize_model", "infer_layer_kind",
           "model_memory_footprint"]


def infer_layer_kind(path: str, leaf) -> str | None:
    """Layer kind from the path name and the weight's rank."""
    if not isinstance(leaf, torch.Tensor):
        return None
    name = path.lower()
    if leaf.dim() >= 3:
        if "transpose" in name or "conv_t" in name:
            return "conv_transpose"
        return "conv"
    if leaf.dim() == 2:
        parts = name.split(".")
        owner = parts[-2] if len(parts) >= 2 else name
        if ("embedding" in owner or owner in ("wte", "embed_tokens", "tok_emb")
                or owner.endswith("_emb")):
            return "embedding"
        return "linear"
    return None


def _map_with_paths(tree, fn, prefix=""):
    """``tree`` with every leaf replaced by ``fn(dotted path, leaf)``; a
    QTensor is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(v, fn, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(v, fn, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def quantize_model(params, config: QuantConfig | dict | None = None, *,
                   arch: str | None = None,
                   kinds: dict[str, str] | None = None,
                   generator: torch.Generator | None = None, device=None):
    """Quantize every eligible weight of ``params``; returns (new_params,
    config).  The params must lie on ``device`` (the card by default)."""
    device = resolve_device(device)
    if config is None:
        config = QuantConfig()
    elif isinstance(config, dict):
        config = QuantConfig.from_dict(config)
    config = add_model_skip_keys(config, arch)

    def leaf(path, w):
        if isinstance(w, torch.Tensor):
            check_device(w, device, path)
        return _maybe_quantize_leaf(path, w, config, kinds, generator)

    return _map_with_paths(params, leaf), config


def _maybe_quantize_leaf(path, leaf, config, kinds, generator):
    if isinstance(leaf, QTensor) or not isinstance(leaf, torch.Tensor):
        return leaf
    if not path.endswith(("weight", "kernel")):
        return leaf
    if leaf.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return leaf
    kind = None
    if kinds:
        match = check_param_name_in(path, list(kinds))
        if match is not None:
            kind = kinds[match]
    if kind is None:
        kind = infer_layer_kind(path, leaf)
    if kind is None:
        return leaf
    if check_param_name_in(path, config.modules_to_not_convert) is not None:
        return leaf
    if not quant_allowed(kind, tuple(leaf.shape), config):
        return leaf
    kw = layer_quant_kwargs(config, path, kind)
    force_mm = env_bool("SDNQ_TPU_USE_QUANTIZED_MATMUL")
    if force_mm is not None:
        kw["use_quantized_matmul"] = force_mm
    if kind == "linear":
        kw["use_quantized_matmul"] = quantized_matmul_allowed(
            kw["use_quantized_matmul"], leaf.shape[-2], leaf.shape[-1])
    elif kind == "conv":
        kw["use_quantized_matmul"] = quantized_matmul_allowed(
            kw["use_quantized_matmul"], leaf.shape[0], leaf.shape[1])
    else:
        kw["use_quantized_matmul"] = False
    if config.use_dynamic_quantization:
        qt = quantize_tensor_dynamic(leaf, layer_kind=kind, config=config,
                                     param_name=path, generator=generator,
                                     **kw)
        if qt is None:
            config.modules_to_not_convert.append(path)
            return leaf
        config.modules_dtype_dict.setdefault(qt.meta.fmt, []).append(path)
        return qt
    return quantize_tensor(leaf, layer_kind=kind, generator=generator, **kw)


def dequantize_model(params, dtype=None):
    """The tree with every QTensor dequantized (to its ``dequant_dtype``
    unless ``dtype`` is given)."""
    return _map_with_paths(params, lambda _, w: w.dequantize(dtype=dtype)
                           if isinstance(w, QTensor) else w)


def model_memory_footprint(params) -> int:
    """Bytes of every tensor and QTensor array in the tree."""
    total = 0

    def leaf(_, w):
        nonlocal total
        if isinstance(w, QTensor):
            total += w.nbytes()
        elif isinstance(w, torch.Tensor):
            total += w.numel() * w.element_size()
        return w
    _map_with_paths(params, leaf)
    return total
