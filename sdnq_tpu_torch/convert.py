"""Carry weights into the port from numpy.

``params_from_numpy`` turns a nested dict/list of numpy arrays (for example
the JAX package's params after ``np.asarray``, any rank: OIHW conv weights
too), and of JAX QTensors among them, into the port's params;
``qtensor_from_numpy`` builds a QTensor from the arrays and metadata fields
of a JAX ``QTensor``, so both packages can run on the same quantized bytes.
``train_params_from_numpy`` and ``opt_state_from_numpy`` carry a JAX
training state across (TrainQTensors, optimizer moments, Kahan buffers,
the step), so both packages can start a training step from the same state.
bfloat16 and float8 arrays (numpy extension dtypes) keep their bits.

The JAX objects are read by their fields alone (``qt`` and ``delta``;
``qdata``, ``scale``, ... and ``meta``; ``qdata``, ``scale``, ``shape`` and
``unsigned``), so this module needs nothing of the JAX package.

A QTensor of a stacked JAX tree (``stack_dit_blocks``: every array with a
leading layer axis, ``meta`` of one layer) crosses as the port's stacked
QTensor, which ``models.dit`` reads layer by layer (``tensor.layer_view``).
Arrays that fit neither one layer nor a stack of them raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels.dispatch import resolve_device
from .tensor import QTensor, QuantMeta, layer_count

__all__ = ["params_from_numpy", "qtensor_from_numpy", "tensor_from_numpy",
           "train_params_from_numpy", "opt_state_from_numpy"]

# numpy extension dtypes by name -> (same-width integer view, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        t = torch.from_numpy(np.ascontiguousarray(a).view(view[0]))
        return t.view(view[1]).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def params_from_numpy(tree, device=None):
    """Nested dict / list / tuple of numpy arrays -> the same structure of
    tensors on ``device`` (the card by default); a QTensor of the JAX
    package (read by its fields) becomes the port's QTensor on the same
    bytes."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if x is None or isinstance(x, (int, float, str, bool)):
            return x
        if hasattr(x, "qdata") and hasattr(x, "meta"):
            return _qtensor_like(x, device)
        return tensor_from_numpy(x, device)

    return conv(tree)


def qtensor_from_numpy(fields: dict, meta: dict, device=None) -> QTensor:
    """``fields``: qdata, scale and optionally zero_point, svd_up, svd_down
    as numpy arrays (or None); ``meta``: the QuantMeta fields by name."""
    device = resolve_device(device)
    kw = {k: v for k, v in meta.items()
          if k in QuantMeta.__dataclass_fields__}
    for k in ("original_shape", "quantized_shape"):
        kw[k] = tuple(int(d) for d in kw[k])
    arrays = {k: (None if fields.get(k) is None
                  else tensor_from_numpy(fields[k], device))
              for k in ("qdata", "scale", "zero_point", "svd_up", "svd_down")}
    qt = QTensor(meta=QuantMeta(**kw), **arrays)
    _check_shapes(qt)
    return qt


def _check_shapes(qt: QTensor) -> None:
    """Raise unless every array holds one layer, or all hold the same
    number of layers on a leading axis (a stacked QTensor)."""
    meta = qt.meta
    n = layer_count(qt)   # raises where the codes fit neither
    lead = () if n is None else (n,)
    rank = len(meta.quantized_shape)
    o = meta.original_shape[0]
    expect = {"scale": rank, "zero_point": rank, "svd_up": 2, "svd_down": 2}
    for name, dims in expect.items():
        a = getattr(qt, name)
        if a is None:
            continue
        if a.dim() != dims + len(lead) or tuple(a.shape[:len(lead)]) != lead:
            raise ValueError(f"QTensor {name} {tuple(a.shape)} does not fit "
                             f"codes {tuple(qt.qdata.shape)} of "
                             f"{'a stack of ' + str(n) if n else 'one layer'}"
                             f" under meta {meta.original_shape}")
    if qt.svd_up is not None and qt.svd_up.shape[len(lead)] != o:
        raise ValueError(f"QTensor svd_up {tuple(qt.svd_up.shape)} does not "
                         f"fit {o} rows")


def _qtensor_like(obj, device) -> QTensor:
    fields = {k: (None if getattr(obj, k, None) is None
                  else np.asarray(getattr(obj, k)))
              for k in ("qdata", "scale", "zero_point", "svd_up", "svd_down")}
    meta = {f.name: getattr(obj.meta, f.name)
            for f in dataclasses.fields(obj.meta)}
    return qtensor_from_numpy(fields, meta, device)


def train_params_from_numpy(tree, device=None):
    """A JAX training parameter tree (dicts / lists of TrainQTensors,
    QTensors and arrays) -> the port's: TrainQTensors with a fresh gradient
    carrier (the JAX ``delta`` is always zeros), QTensors, and tensors, the
    floating ones leaves that require grad."""
    from .train.matmul import TrainQTensor, grad_carrier
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if x is None:
            return None
        if hasattr(x, "qt") and hasattr(x, "delta"):
            qt = _qtensor_like(x.qt, device)
            return TrainQTensor(qt=qt, delta=grad_carrier(
                qt.meta.original_shape, device))
        if hasattr(x, "qdata") and hasattr(x, "meta"):
            return _qtensor_like(x, device)
        t = tensor_from_numpy(x, device)
        return t.requires_grad_() if t.is_floating_point() else t

    return conv(tree)


def opt_state_from_numpy(state, device=None) -> dict:
    """A JAX optimizer state ``{"step", "per_param": [None | {name: BufferQ
    | array}]}`` -> the port's, with BufferQs, tensors and an int step.
    Muon's per-leaf ``"muon"`` flag stays a Python bool."""
    from .optim.base import BufferQ
    device = resolve_device(device)

    def buf(x):
        if hasattr(x, "qdata") and hasattr(x, "unsigned"):
            return BufferQ(qdata=tensor_from_numpy(x.qdata, device),
                           scale=tensor_from_numpy(x.scale, device),
                           shape=tuple(int(d) for d in x.shape),
                           unsigned=bool(x.unsigned))
        return tensor_from_numpy(x, device)

    return {"step": int(np.asarray(state["step"])),
            "per_param": [None if st is None
                          else {k: bool(np.asarray(v)) if k == "muon"
                                else buf(v) for k, v in st.items()}
                          for st in state["per_param"]]}
