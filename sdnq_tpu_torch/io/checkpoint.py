"""Training checkpoints without Orbax and without pickle.

``save_checkpoint(path, state)`` writes the tensors of a training state (a
nested dict / list / tuple of tensors, QTensors, TrainQTensors, the
optimizers' 8-bit BufferQs, Python scalars such as the step, and None) into
``path/state.safetensors`` and the tree's structure with each leaf's kind
(and a QTensor's meta, a BufferQ's shape) into ``path/state.json``.  The
directory is written beside ``path`` and renamed into place, so a cut
write leaves no half checkpoint under that name.  A TrainQTensor's gradient
carrier holds no state and is made anew on restore.

``restore_checkpoint(path, template)`` builds a tree of the template's
structure from the files, each leaf on the device of the template's leaf
there, as JAX's restore does with its template; a tensor requires grad
where the template's does.  A leaf whose kind, dtype or shape differs from
the template's raises.  An Orbax directory written by the JAX package is
not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import torch

from ..convert import _check_shapes
from ..optim.base import BufferQ
from ..tensor import QTensor, QuantMeta
from ..train.matmul import TrainQTensor, grad_carrier
from ._safetensors import load_file, save_file

__all__ = ["save_checkpoint", "restore_checkpoint"]

_TENSORS, _TREE = "state.safetensors", "state.json"
_QT_FIELDS = ("qdata", "scale", "zero_point", "svd_up", "svd_down")


def _qt_node(qt: QTensor, key: str, tensors: dict) -> dict:
    for f in _QT_FIELDS:
        if getattr(qt, f) is not None:
            tensors[f"{key}.{f}"] = getattr(qt, f)
    return {"meta": dataclasses.asdict(qt.meta),
            "fields": [f for f in _QT_FIELDS if getattr(qt, f) is not None]}


def _encode(x, key: str, tensors: dict) -> dict:
    if isinstance(x, dict):
        return {"kind": "dict", "items": {
            k: _encode(v, f"{key}{k}.", tensors) for k, v in x.items()}}
    if isinstance(x, (list, tuple)):
        return {"kind": type(x).__name__, "items": [
            _encode(v, f"{key}{i}.", tensors) for i, v in enumerate(x)]}
    key = key[:-1]
    if x is None:
        return {"kind": "none"}
    if isinstance(x, (bool, int, float, str)):
        return {"kind": "scalar", "type": type(x).__name__, "value": x}
    if isinstance(x, torch.Tensor):
        tensors[key] = x
        return {"kind": "tensor", "key": key}
    if isinstance(x, QTensor):
        return {"kind": "qtensor", "key": key, **_qt_node(x, key, tensors)}
    if isinstance(x, TrainQTensor):
        return {"kind": "train_qtensor", "key": key,
                **_qt_node(x.qt, key, tensors)}
    if isinstance(x, BufferQ):
        tensors[f"{key}.qdata"] = x.qdata
        tensors[f"{key}.scale"] = x.scale
        return {"kind": "bufferq", "key": key, "shape": list(x.shape),
                "unsigned": bool(x.unsigned)}
    raise TypeError(f"checkpoint leaf {key or '<root>'}: cannot store a "
                    f"{type(x).__name__}")


def save_checkpoint(path: str, state) -> None:
    """Write ``state`` to the directory ``path``, replacing what is
    there."""
    path = os.path.abspath(path)
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tensors: dict[str, torch.Tensor] = {}
    tree = _encode(state, "", tensors)
    save_file(tensors, os.path.join(tmp, _TENSORS),
              metadata={"format": "sdnq_tpu_torch.checkpoint"})
    with open(os.path.join(tmp, _TREE), "w") as f:
        json.dump(tree, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _like(t: torch.Tensor, ref, key: str, device=None) -> torch.Tensor:
    """``t`` on ``ref``'s device (``device`` where there is no ``ref``);
    raises where dtype or shape differ from ``ref``'s."""
    if ref is None:
        return t.to(device)
    if t.dtype != ref.dtype or t.shape != ref.shape:
        raise ValueError(f"checkpoint {key}: {t.dtype}{tuple(t.shape)} "
                         f"where the template has "
                         f"{ref.dtype}{tuple(ref.shape)}")
    return t.to(ref.device)


def _restore_qt(node: dict, tensors: dict, ref: QTensor) -> QTensor:
    meta = dict(node["meta"])
    for k in ("original_shape", "quantized_shape"):
        meta[k] = tuple(meta[k])
    key = node["key"]
    fields = {f: (_like(tensors[f"{key}.{f}"], getattr(ref, f), f"{key}.{f}",
                        ref.qdata.device)
                  if f in node["fields"] else None) for f in _QT_FIELDS}
    qt = QTensor(meta=QuantMeta(**meta), **fields)
    _check_shapes(qt)
    return qt


def _decode(node: dict, tensors: dict, ref, key: str):
    """``key``: the dotted path so far, with a trailing dot."""
    kind = node["kind"]
    where = key[:-1] or "<root>"
    want = {dict: "dict", list: "list", tuple: "tuple", type(None): "none",
            torch.Tensor: "tensor", QTensor: "qtensor",
            TrainQTensor: "train_qtensor", BufferQ: "bufferq"}
    ref_kind = next((v for t, v in want.items() if isinstance(ref, t)),
                    "scalar")
    if kind != ref_kind:
        raise ValueError(f"checkpoint {where}: a {kind} where the "
                         f"template has a {ref_kind}")
    if kind == "dict":
        if set(node["items"]) != set(ref):
            raise ValueError(f"checkpoint {where}: keys "
                             f"{sorted(node['items'])} where the template "
                             f"has {sorted(ref)}")
        return {k: _decode(node["items"][k], tensors, v, f"{key}{k}.")
                for k, v in ref.items()}
    if kind in ("list", "tuple"):
        if len(node["items"]) != len(ref):
            raise ValueError(f"checkpoint {where}: "
                             f"{len(node['items'])} items where the "
                             f"template has {len(ref)}")
        return type(ref)(_decode(n, tensors, r, f"{key}{i}.")
                         for i, (n, r) in enumerate(zip(node["items"], ref)))
    if kind == "none":
        return None
    if kind == "scalar":
        return {"bool": bool, "int": int, "float": float,
                "str": str}[node["type"]](node["value"])
    if kind == "tensor":
        t = _like(tensors[node["key"]], ref, node["key"])
        return t.requires_grad_() if ref.requires_grad else t
    if kind == "qtensor":
        return _restore_qt(node, tensors, ref)
    if kind == "train_qtensor":
        qt = _restore_qt(node, tensors, ref.qt)
        return TrainQTensor(qt=qt, delta=grad_carrier(
            qt.meta.original_shape, qt.qdata.device))
    k = node["key"]
    return BufferQ(qdata=_like(tensors[f"{k}.qdata"], ref.qdata, k),
                   scale=_like(tensors[f"{k}.scale"], ref.scale, k),
                   shape=tuple(node["shape"]), unsigned=node["unsigned"])


def restore_checkpoint(path: str, template):
    """The state saved at ``path``, in ``template``'s structure, each leaf
    on the device of the template's leaf."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _TREE)) as f:
        tree = json.load(f)
    tensors = load_file(os.path.join(path, _TENSORS))
    return _decode(tree, tensors, template, "")
