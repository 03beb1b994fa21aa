"""HF checkpoint interop: stream diffusers / transformers safetensors into
the models' nested parameter trees, quantizing as the tensors arrive.

The JAX package's ``io.hf``.  Tensors are read one at a time from a file,
a directory or a sharded index (the port's own reader, no ``safetensors``
package), renamed by a key map, moved to the device and quantized there if
eligible, so the model is never held in full precision.  Dotted keys nest
and integer components become list indices.  Coverage checks make a key
that nothing consumes, or a tree that does not match the model, fail
loudly.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from ..apply import infer_layer_kind
from ..config import QuantConfig
from ..dynamic import quantize_tensor_dynamic
from ..kernels.dispatch import resolve_device
from ..policy import (add_model_skip_keys, check_param_name_in,
                      layer_quant_kwargs, quant_allowed,
                      quantized_matmul_allowed)
from ..tensor import quantize_tensor
from ._safetensors import checkpoint_files, iter_file
from .safetensors_io import insert_path, listify

__all__ = ["stream_state_dict", "assemble_params",
           "load_and_quantize_state_dict", "tree_leaf_paths",
           "check_tree_coverage", "CheckpointCoverageError"]


class CheckpointCoverageError(ValueError):
    """A checkpoint key that nothing consumed, or an assembled tree with
    leaves missing or beyond those the model structure expects."""


def tree_leaf_paths(tree, prefix: str = "") -> set:
    """Dotted leaf paths of a nested dict / list tree; a tensor, QTensor
    or any other non-container is a leaf."""
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= tree_leaf_paths(v, f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = set()
        for i, v in enumerate(tree):
            out |= tree_leaf_paths(v, f"{prefix}{i}.")
        return out
    return {prefix[:-1]}


def check_tree_coverage(params, expected, *, what: str = "checkpoint",
                        optional: tuple = ()):
    """Raise :class:`CheckpointCoverageError`, naming the missing and the
    unexpected paths, unless ``params`` has exactly the leaf paths of
    ``expected`` (a tree of the same layout, e.g. the model's init on the
    meta device).  Paths under an ``optional`` prefix may be present or
    absent on either side."""
    got = tree_leaf_paths(params)
    exp = tree_leaf_paths(expected)

    def _req(paths):
        return {p for p in paths
                if not any(p.startswith(o) for o in optional)}

    missing = sorted(_req(exp) - got)
    extra = sorted(_req(got) - exp)
    if missing or extra:
        msg = [f"{what}: assembled param tree does not match the model "
               f"structure ({len(missing)} missing, {len(extra)} "
               "unexpected)"]
        if missing:
            msg.append("  missing: " + ", ".join(missing[:20])
                       + (" ..." if len(missing) > 20 else ""))
        if extra:
            msg.append("  unexpected: " + ", ".join(extra[:20])
                       + (" ..." if len(extra) > 20 else ""))
        raise CheckpointCoverageError("\n".join(msg))


def stream_state_dict(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(key, CPU tensor) of every tensor of a file, of a directory's
    ``*.safetensors`` files, or of the shards a sharded index lists."""
    for fname in checkpoint_files(path):
        yield from iter_file(fname)


def assemble_params(items, key_map: Callable[[str], str | None] = None):
    """A nested dict / list tree from (dotted key, value) pairs; a key the
    ``key_map`` maps to None is dropped."""
    tree: dict = {}
    for key, value in items:
        if key_map is not None:
            key = key_map(key)
            if key is None:
                continue
        insert_path(tree, key, value)
    return listify(tree)


def raise_unconsumed(unknown: list[str], what: str, by: str) -> None:
    if unknown:
        raise CheckpointCoverageError(
            f"{what}: {len(unknown)} checkpoint key(s) not consumed by "
            f"{by}: " + ", ".join(unknown[:20])
            + (" ..." if len(unknown) > 20 else ""))


def load_and_quantize_state_dict(
    path: str,
    config: QuantConfig | None = None,
    *,
    arch: str | None = None,
    key_map: Callable[[str], str | None] = None,
    kinds: dict[str, str] | None = None,
    dtype=torch.bfloat16,
    generator: torch.Generator | None = None,
    known_skips: tuple = (),
    strict: bool = True,
    device=None,
):
    """Stream a checkpoint to ``device`` (the card unless the CPU is asked
    for) and quantize each eligible weight there as it arrives; the other
    floating tensors are cast to ``dtype``.  Returns (params, config).

    ``strict``: a checkpoint key that the key map drops and no
    ``known_skips`` substring names raises :class:`CheckpointCoverageError`
    (a renamed or extra key must not vanish)."""
    device = resolve_device(device)
    if config is None:
        config = QuantConfig()
    config = add_model_skip_keys(config, arch)
    unmapped: list[str] = []

    def items():
        for key, tensor in stream_state_dict(path):
            mapped = key_map(key) if key_map else key
            if mapped is None:
                unmapped.append(key)
                continue
            yield mapped, _maybe_quantize(mapped, tensor.to(device), config,
                                          kinds, dtype, generator)

    params = assemble_params(items())
    if strict:
        raise_unconsumed([k for k in unmapped
                          if not any(s in k for s in known_skips)],
                         arch or path, "the key map and not in its "
                         "known-skip list")
    return params, config


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype) if t.is_floating_point() else t


def _maybe_quantize(path: str, arr: torch.Tensor, config: QuantConfig,
                    kinds, dtype, generator):
    if not path.endswith(("weight", "kernel")) or arr.dim() < 2:
        return _cast(arr, dtype)
    kind = None
    if kinds:
        m = check_param_name_in(path, list(kinds))
        if m is not None:
            kind = kinds[m]
    if kind is None:
        kind = infer_layer_kind(path, arr)
    if kind is None or not quant_allowed(kind, tuple(arr.shape), config) \
            or check_param_name_in(path, config.modules_to_not_convert):
        return _cast(arr, dtype)
    kw = layer_quant_kwargs(config, path, kind)
    if kind == "linear":
        kw["use_quantized_matmul"] = quantized_matmul_allowed(
            kw["use_quantized_matmul"], arr.shape[-2], arr.shape[-1])
    elif kind == "conv":
        kw["use_quantized_matmul"] = quantized_matmul_allowed(
            kw["use_quantized_matmul"], arr.shape[0], arr.shape[1])
    else:
        kw["use_quantized_matmul"] = False
    if config.use_dynamic_quantization:
        qt = quantize_tensor_dynamic(arr, layer_kind=kind, config=config,
                                     param_name=path, generator=generator,
                                     **kw)
        return qt if qt is not None else arr.to(dtype)
    return quantize_tensor(arr, layer_kind=kind, generator=generator, **kw)
