"""Save and load pre-quantized models as safetensors, in the JAX package's
files.

One ``model.safetensors`` holds each QTensor's components under the
reference's key scheme (``<layer>.weight/.scale/.zero_point/.svd_up/
.svd_down``) and every plain tensor under its dotted path (dict keys in
order, list indices as digits); ``sdnq_tpu_meta.json`` holds each layer's
QuantMeta as a dict (``metas``) and each stored tensor's dtype name
(``dtypes``); ``quantization_config.json`` holds the QuantConfig.  bf16 is
stored as a uint16 carrier and fp8 as a uint8 one, tagged by name in
``dtypes``, as the JAX package stores them, so a file written by either
package loads in the other.  A stacked QTensor (a leading layer axis on
every array) is written as it lies and comes back stacked.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..config import QuantConfig
from ..convert import _check_shapes
from ..kernels.dispatch import resolve_device
from ..tensor import QTensor, QuantMeta
from ..tree import tree_leaves_with_paths
from ._safetensors import iter_file, save_file

__all__ = ["save_quantized", "load_quantized"]

_COMPONENTS = ("qdata", "scale", "zero_point", "svd_up", "svd_down")
# the reference's component names, for checkpoint-key parity
_REF_NAMES = {"qdata": "weight", "scale": "scale",
              "zero_point": "zero_point", "svd_up": "svd_up",
              "svd_down": "svd_down"}
# dtypes stored as a same-width unsigned carrier, as the JAX package does
_CARRIERS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8,
             torch.float8_e5m2: torch.uint8}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in _CARRIERS}


def _stored(t: torch.Tensor) -> tuple[torch.Tensor, str]:
    """The tensor as written (a carrier view for bf16 / fp8) and its dtype
    name (numpy's name, as the JAX package records it)."""
    name = str(t.dtype).removeprefix("torch.")
    carrier = _CARRIERS.get(t.dtype)
    return (t if carrier is None else t.view(carrier)), name


def _restored(t: torch.Tensor, name: str) -> torch.Tensor:
    dt = _BY_NAME.get(name)
    return t if dt is None or t.dtype == dt else t.view(dt)


def save_quantized(params, path: str, config: QuantConfig | None = None):
    """Write ``params`` (a tree of QTensors and tensors, on any device) to
    ``path``/model.safetensors with the meta and config sidecars."""
    os.makedirs(path, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    dtypes: dict[str, str] = {}
    metas: dict[str, dict] = {}
    for p, leaf in tree_leaves_with_paths(
            params, is_leaf=lambda x: isinstance(x, QTensor)):
        if isinstance(leaf, QTensor):
            base = p[: -len(".weight")] if p.endswith(".weight") else p
            metas[base] = dataclasses.asdict(leaf.meta)
            for comp in _COMPONENTS:
                arr = getattr(leaf, comp)
                if arr is not None:
                    key = f"{base}.{_REF_NAMES[comp]}"
                    tensors[key], dtypes[key] = _stored(arr)
        elif isinstance(leaf, torch.Tensor):
            tensors[p], dtypes[p] = _stored(leaf)
    save_file(tensors, os.path.join(path, "model.safetensors"),
              metadata={"format": "sdnq_tpu"})
    with open(os.path.join(path, "sdnq_tpu_meta.json"), "w") as f:
        json.dump({"metas": metas, "dtypes": dtypes}, f, indent=1)
    if config is not None:
        with open(os.path.join(path, "quantization_config.json"), "w") as f:
            f.write(config.to_json())


def insert_path(tree: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def listify(tree):
    """Dicts whose keys are exactly 0..n-1 as digits become lists (the
    models keep their blocks in lists)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: listify(v) for k, v in tree.items()}
    keys = list(out)
    if keys and all(k.isdigit() for k in keys):
        order = sorted(keys, key=int)
        if [int(k) for k in order] == list(range(len(order))):
            return [out[k] for k in order]
    return out


def load_quantized(path: str, device=None):
    """The nested-dict tree saved at ``path``, on ``device`` (the card
    unless the CPU is asked for), and its QuantConfig (None without the
    sidecar).  Returns (params, config)."""
    device = resolve_device(device)
    with open(os.path.join(path, "sdnq_tpu_meta.json")) as f:
        side = json.load(f)
    metas, dtypes = side["metas"], side["dtypes"]
    raw = {key: _restored(t, dtypes.get(key, "")) for key, t in iter_file(
        os.path.join(path, "model.safetensors"), device=device)}

    params: dict = {}
    consumed = set()
    for base, meta_dict in metas.items():
        meta_dict = dict(meta_dict)
        for key in ("original_shape", "quantized_shape"):
            meta_dict[key] = tuple(meta_dict[key])
        comps = {}
        for comp in _COMPONENTS:
            key = f"{base}.{_REF_NAMES[comp]}"
            comps[comp] = raw.get(key)
            consumed.add(key)
        qt = QTensor(meta=QuantMeta(**meta_dict), **comps)
        _check_shapes(qt)
        insert_path(params, base + ".weight", qt)
    for key, val in raw.items():
        if key not in consumed:
            insert_path(params, key, val)

    cfg = None
    cfg_path = os.path.join(path, "quantization_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = QuantConfig.from_json(f.read())
    return listify(params), cfg
