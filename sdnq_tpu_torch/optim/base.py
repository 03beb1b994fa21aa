"""Quantized-state optimizer machinery.

The JAX package's ``optim.base`` over torch tensors: each optimizer is an
(init, update) pair over parameter trees whose parameters may be QTensors or
TrainQTensors and whose moment buffers are themselves quantized when large
enough: 8-bit microfloat codes in flat groups of 256 with one fp32 scale
each (``BufferQ``).  Also: nan-scrubbed gradients, clipping, stochastically
rounded buffer writes (rounding bits from a ``torch.Generator``), cautious
masking, the final-norm modes, host offload of the buffers.

Unlike the JAX package the updates are in place: a TrainQTensor's ``qt``,
a floating parameter's values and the state's entries are replaced one
parameter at a time, so the card never holds two copies of the codes or of
the moment buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..formats import get_format
from ..packing import decode_float, encode_float
from ..quant.core import _div, random_bits
from ..tensor import QTensor, dequantize
from ..train.matmul import TrainQTensor

__all__ = ["QOptimizer", "OptConfig", "quantize_buffer",
           "dequantize_buffer", "zero_buffer", "update_buffer_lerp",
           "apply_norm_to_update", "scrub_grad", "cautious_mask", "BufferQ",
           "offload_opt_state", "fetch_opt_state",
           "cast_state_for_transfer", "cast_state_from_transfer"]

# moment buffers smaller than this stay fp32
MIN_QUANT_BUFFER_NUMEL = 16384
BUFFER_GROUP = 256


@dataclasses.dataclass
class OptConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    eps: float = 1e-8
    grad_clip: float | None = None
    final_norm_mode: str = "none"   # none|clip|rms|rms_clip|relative
    use_cautious: bool = False
    use_kahan: bool = True
    quantize_state: bool = True
    state_fmt: str = "int8"
    stochastic_rounding: bool = True


class QOptimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, generator) -> (params, state)


@dataclasses.dataclass
class BufferQ:
    """8-bit group-quantized optimizer buffer (flat groups of 256)."""
    qdata: torch.Tensor   # (n_groups, 256) uint8 codes
    scale: torch.Tensor   # (n_groups, 1) fp32
    shape: tuple
    unsigned: bool


# Microfloat codes, not linear int8: second moments span many orders of
# magnitude within a group, and a linear grid would round the small ones
# to zero (then m / (sqrt(0) + eps) explodes).
_FMT_UNSIGNED = "float8_e4m4fnu"
_FMT_SIGNED = "float8_e4m3fn_sdnq"


def _buffer_fmt(unsigned: bool):
    return get_format(_FMT_UNSIGNED if unsigned else _FMT_SIGNED)


def _quantizable(numel: int) -> bool:
    return numel >= MIN_QUANT_BUFFER_NUMEL and numel % BUFFER_GROUP == 0


def quantize_buffer(x: torch.Tensor, generator: torch.Generator | None = None,
                    unsigned: bool = False, sr_bits=None):
    """x as a BufferQ (or x itself when too small or not a whole number of
    groups).  Stochastic rounding takes uniform 32-bit ``sr_bits`` of the
    groups' shape, or draws them from ``generator``."""
    if not _quantizable(x.numel()):
        return x
    fmt = _buffer_fmt(unsigned)
    flat = x.reshape(-1, BUFFER_GROUP).float()
    amax = flat.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(_div(amax, fmt.max), 2.0 ** -126)
    v = torch.clamp(flat / scale, fmt.min, fmt.max)
    if sr_bits is None and generator is not None:
        sr_bits = random_bits(v.shape, generator)
    codes = encode_float(v, fmt, sr_bits=sr_bits).to(torch.uint8)
    return BufferQ(qdata=codes, scale=scale, shape=tuple(x.shape),
                   unsigned=unsigned)


def zero_buffer(shape, device, unsigned: bool = False):
    """``quantize_buffer`` of zeros, built without the zeros: code 0 is
    +0.0 in both microfloats, and an all-zero group takes the floor
    scale."""
    numel = 1
    for d in shape:
        numel *= d
    if not _quantizable(numel):
        return torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    groups = numel // BUFFER_GROUP
    return BufferQ(
        qdata=torch.zeros((groups, BUFFER_GROUP), dtype=torch.uint8,
                          device=device),
        scale=torch.full((groups, 1), 2.0 ** -126, dtype=torch.float32,
                         device=device),
        shape=tuple(shape), unsigned=unsigned)


def dequantize_buffer(b) -> torch.Tensor:
    if isinstance(b, BufferQ):
        flat = decode_float(b.qdata, _buffer_fmt(b.unsigned)) * b.scale
        return flat.reshape(b.shape)
    return b


def update_buffer_lerp(buf, new_value: torch.Tensor, beta: float,
                       generator: torch.Generator | None = None):
    """buf <- beta*buf + (1-beta)*new: dequantize, lerp, requantize for a
    BufferQ.  Returns (stored buffer, its fp32 value before requantizing)."""
    cur = dequantize_buffer(buf)
    nxt = beta * cur + (1.0 - beta) * new_value.float()
    if isinstance(buf, BufferQ):
        return quantize_buffer(nxt, generator, unsigned=buf.unsigned), nxt
    return nxt, nxt


def scrub_grad(g: torch.Tensor, clip: float | None, grad_scale=None):
    """NaN-scrubbed fp32 gradient, divided by an AMP ``grad_scale`` and
    clipped to norm ``clip`` where given."""
    g = torch.nan_to_num(g.float())
    if grad_scale is not None:
        g = g / torch.as_tensor(grad_scale, dtype=torch.float32,
                                device=g.device)
    if clip is not None:
        norm = torch.sqrt(g.square().sum() + 1e-12)
        g = g * torch.clamp_max(clip / norm, 1.0)
    return g


def cautious_mask(update: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Zero the components whose sign disagrees with the gradient,
    rescaled to keep the mean magnitude."""
    mask = (update * grad > 0).to(update.dtype)
    mask = mask / torch.clamp_min(mask.mean(), 1e-3)
    return update * mask


def apply_norm_to_update(update: torch.Tensor, param_norm: torch.Tensor,
                         mode: str) -> torch.Tensor:
    """The final-norm modes."""
    if mode in (None, "none"):
        return update
    rms = torch.sqrt(update.square().mean() + 1e-12)
    if mode == "rms":
        return update / torch.clamp_min(rms, 1.0)
    if mode == "rms_clip":
        return update / torch.clamp_min(rms, 1e-12) * torch.clamp_max(rms,
                                                                      1.0)
    if mode == "clip":
        norm = torch.sqrt(update.square().sum() + 1e-12)
        return update * torch.clamp_max(1.0 / norm, 1.0)
    if mode == "relative":
        return update * torch.clamp_min(param_norm, 1e-3)
    if mode == "rms_scaled":
        return update * (0.2 / torch.clamp_min(rms, 1e-12))
    if mode == "rms_clip_scaled":
        return update * torch.clamp_max(0.2 / torch.clamp_min(rms, 1e-12),
                                        1.0)
    if mode == "muon":
        rows = update.shape[0] if update.dim() else 1
        cols = max(1, update.numel() // max(rows, 1))
        return update * (max(1.0, rows / cols) ** 0.5)
    return update


# ---------------------------------------------------------------------------
# Host offload of the moment buffers, and 16-bit transfer casts
# ---------------------------------------------------------------------------

def _map_buffers(state, fn, into_bufferq: bool = True):
    """``fn`` on every moment-buffer tensor, in place in ``state`` (a
    BufferQ's fields too with ``into_bufferq``); the Kahan buffers stay as
    they are."""
    def one(x):
        if isinstance(x, BufferQ):
            if into_bufferq:
                x.qdata, x.scale = fn(x.qdata), fn(x.scale)
            return x
        return fn(x) if isinstance(x, torch.Tensor) else x
    for st in state["per_param"]:
        if st is not None:
            for k in st:
                if k != "kahan":
                    st[k] = one(st[k])
    return state


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def offload_opt_state(state):
    """Move the moment buffers of the card into pinned host memory between
    steps (Kahan buffers stay); buffers elsewhere stay as they are."""
    return _map_buffers(state, _to_pinned)


def fetch_opt_state(state, device=None):
    """Bring offloaded (pinned host) buffers back to ``device`` (the card
    by default)."""
    def back(t):
        if t.device.type == "cpu" and t.is_pinned():
            return t.to(device or "cuda", non_blocking=True)
        return t
    return _map_buffers(state, back)


def cast_state_for_transfer(state, dtype=torch.bfloat16):
    """fp32 moment buffers to a 16-bit transfer type (BufferQ codes and
    the step stay)."""
    return _map_buffers(state, lambda t: t.to(dtype)
                        if t.dtype == torch.float32 and t.dim() > 0 else t,
                        into_bufferq=False)


def cast_state_from_transfer(state):
    return _map_buffers(state, lambda t: t.float()
                        if t.dtype in (torch.bfloat16, torch.float16) else t,
                        into_bufferq=False)


def param_value(p):
    if isinstance(p, TrainQTensor):
        p = p.qt
    if isinstance(p, QTensor):
        return dequantize(p, torch.float32)
    return p.detach().float()
