"""Quantized-state optimizers: AdamW, Lion, Adafactor, CAME.

The JAX package's ``optim.optimizers``.  Shared engine: scrub the gradient
-> the optimizer's raw update -> cautious mask -> final-norm mode -> lr and
decoupled weight decay -> a Kahan-compensated, stochastically rounded write
of the parameter (for a quantized parameter the write is a fresh
quantization).  Moment buffers are 8-bit group-quantized when large enough;
Adafactor's and CAME's factored second moments stay fp32.

``update`` works in place (see ``optim.base``): it returns the same
parameter tree and state it was given, changed one parameter at a time.
With ``grads=None`` it reads each gradient from the parameters (``.grad``,
``delta.grad`` for a TrainQTensor) and clears it once used, so a step holds
at most one parameter's fp32 temporaries beyond the gradients still
waiting.  The step's scalars (bias corrections, decay) are fp32 0-dim
tensors, as the JAX package computes them.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..tensor import QTensor, dequantize, quantize_tensor
from ..train.matmul import TrainQTensor
from ..tree import tree_leaves
from .base import (
    OptConfig, QOptimizer, apply_norm_to_update, cautious_mask,
    dequantize_buffer, param_value, scrub_grad, update_buffer_lerp,
    zero_buffer,
)

__all__ = ["adamw", "lion", "adafactor", "came", "make_optimizer"]


def _is_q(x) -> bool:
    return isinstance(x, (QTensor, TrainQTensor))


def _is_param(x) -> bool:
    return _is_q(x) or (isinstance(x, torch.Tensor)
                        and x.is_floating_point())


def _shape_device(p):
    if isinstance(p, TrainQTensor):
        p = p.qt
    if isinstance(p, QTensor):
        return tuple(p.meta.original_shape), p.qdata.device
    return tuple(p.shape), p.device


def _take_grad(p):
    """A parameter's gradient, cleared on the parameter."""
    holder = p.delta if isinstance(p, TrainQTensor) else p
    g = holder.grad
    holder.grad = None
    return g


def make_optimizer(init_param: Callable, update_param: Callable,
                   cfg: OptConfig) -> QOptimizer:
    """``init_param(shape, device, cfg)`` -> a parameter's state dict;
    ``update_param(g, st, v, cfg, t, generator)`` -> the raw update, with
    ``st`` changed in place and ``t`` the step as an fp32 0-dim tensor."""

    def init(params):
        states = []
        for p in tree_leaves(params, is_leaf=_is_q):
            if not _is_param(p):
                states.append(None)
                continue
            shape, device = _shape_device(p)
            st = init_param(shape, device, cfg)
            if cfg.use_kahan and _is_q(p):
                st["kahan"] = torch.zeros(shape, dtype=torch.bfloat16,
                                          device=device)
            states.append(st)
        return {"step": 0, "per_param": states}

    def update(grads, state, params, generator=None, grad_scale=None):
        step = int(state["step"]) + 1
        flat_p = tree_leaves(params, is_leaf=_is_q)
        flat_g = None if grads is None else tree_leaves(grads, is_leaf=_is_q)
        del grads  # the flat list is the only holder left: freed as used
        states = state["per_param"]
        sr_gen = generator if cfg.stochastic_rounding else None
        for i, (p, st) in enumerate(zip(flat_p, states)):
            if flat_g is None:
                g = _take_grad(p) if _is_param(p) else None
            else:
                g, flat_g[i] = flat_g[i], None
            if st is None or g is None:
                continue
            g = scrub_grad(g, cfg.grad_clip, grad_scale)
            v = param_value(p)
            t = torch.tensor(float(step), dtype=torch.float32,
                             device=g.device)
            raw = update_param(g, st, v, cfg, t, generator)
            if cfg.use_cautious:
                raw = cautious_mask(raw, g)
            del g
            pn = torch.sqrt(v.square().mean() + 1e-12)
            raw = apply_norm_to_update(raw, pn, cfg.final_norm_mode)
            delta = -cfg.lr * raw
            del raw
            if cfg.weight_decay:
                delta = delta - cfg.lr * cfg.weight_decay * v
            if _is_q(p):
                qt = p.qt if isinstance(p, TrainQTensor) else p
                comp = st.get("kahan")
                target = v + delta
                del v, delta
                if comp is not None:
                    target = target + comp.float()
                meta = qt.meta
                new_qt = quantize_tensor(
                    target, meta.fmt, meta.layer_kind,
                    matmul_fmt=meta.matmul_fmt, group_size=meta.group_size,
                    hadamard_group_size=meta.hadamard_group_size,
                    use_svd=False, use_hadamard=meta.use_hadamard,
                    use_quantized_matmul=meta.use_quantized_matmul,
                    use_stochastic_rounding=sr_gen is not None,
                    dequant_dtype=meta.dequant_dtype, generator=sr_gen)
                if comp is not None:
                    st["kahan"] = (target - dequantize(new_qt, torch.float32)
                                   ).to(torch.bfloat16)
                if isinstance(p, TrainQTensor):
                    p.qt = new_qt
                else:
                    for f in ("qdata", "scale", "zero_point", "svd_up",
                              "svd_down", "meta"):
                        setattr(p, f, getattr(new_qt, f))
            else:
                with torch.no_grad():
                    p.copy_((v + delta).to(p.dtype))
        state["step"] = step
        return params, state

    return QOptimizer(init=init, update=update)


def _moment(shape, device, cfg, unsigned=False):
    if cfg.quantize_state:
        return zero_buffer(shape, device, unsigned=unsigned)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _factored_dims(shape):
    if len(shape) < 2:
        return None
    return len(shape) - 1, len(shape) - 2


def _factored(shape, device):
    c, r = _factored_dims(shape)
    row_shape, col_shape = list(shape), list(shape)
    row_shape[c] = 1
    col_shape[r] = 1
    return (torch.zeros(tuple(row_shape), dtype=torch.float32, device=device),
            torch.zeros(tuple(col_shape), dtype=torch.float32, device=device))


def _approx_rsqrt(g, vr, vc, r):
    r_factor = vr / torch.clamp_min(vr.mean(dim=r, keepdim=True), 1e-30)
    return g * torch.rsqrt(r_factor * vc + 1e-30)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, **kw):
    cfg = OptConfig(lr=lr, eps=eps, weight_decay=weight_decay, **kw)

    def init_param(shape, device, cfg):
        return {"m": _moment(shape, device, cfg),
                "v": _moment(shape, device, cfg, unsigned=True)}

    def update_param(g, st, v, cfg, t, gen):
        st["m"], m = update_buffer_lerp(st["m"], g, b1, gen)
        st["v"], vv = update_buffer_lerp(st["v"], g.square(), b2, gen)
        m_hat = m / (1 - b1 ** t)
        v_hat = vv / (1 - b2 ** t)
        return m_hat / (torch.sqrt(v_hat) + cfg.eps)

    return make_optimizer(init_param, update_param, cfg)


# ---------------------------------------------------------------------------
# Lion
# ---------------------------------------------------------------------------

def lion(lr=1e-4, b1=0.9, b2=0.99, weight_decay=0.0, **kw):
    cfg = OptConfig(lr=lr, weight_decay=weight_decay, **kw)

    def init_param(shape, device, cfg):
        return {"m": _moment(shape, device, cfg)}

    def update_param(g, st, v, cfg, t, gen):
        m = dequantize_buffer(st["m"])
        upd = torch.sign(b1 * m + (1 - b1) * g)
        st["m"], _ = update_buffer_lerp(st["m"], g, b2, gen)
        return upd

    return make_optimizer(init_param, update_param, cfg)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def adafactor(lr=1e-4, decay_rate=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, **kw):
    kw.setdefault("final_norm_mode", "none")
    cfg = OptConfig(lr=lr, eps=eps, weight_decay=weight_decay, **kw)

    def init_param(shape, device, cfg):
        if _factored_dims(shape) is not None:
            vr, vc = _factored(shape, device)
            return {"vr": vr, "vc": vc}
        return {"v": _moment(shape, device, cfg, unsigned=True)}

    def update_param(g, st, v, cfg, t, gen):
        beta2t = 1.0 - t ** -decay_rate
        g2 = g.square() + eps
        dims = _factored_dims(g.shape)
        if dims is not None:
            c, r = dims
            st["vr"] = beta2t * st["vr"] + (1 - beta2t) * g2.mean(
                dim=c, keepdim=True)
            st["vc"] = beta2t * st["vc"] + (1 - beta2t) * g2.mean(
                dim=r, keepdim=True)
            upd = _approx_rsqrt(g, st["vr"], st["vc"], r)
        else:
            st["v"], vv = update_buffer_lerp(st["v"], g2, beta2t, gen)
            upd = g * torch.rsqrt(vv + 1e-30)
        rms = torch.sqrt(upd.square().mean() + 1e-12)
        return upd / torch.clamp_min(rms / clip_threshold, 1.0)

    return make_optimizer(init_param, update_param, cfg)


# ---------------------------------------------------------------------------
# CAME
# ---------------------------------------------------------------------------

def came(lr=1e-4, b1=0.9, b2=0.999, b3=0.9999, eps1=1e-30, eps2=1e-16,
         clip_threshold=1.0, weight_decay=0.0, **kw):
    cfg = OptConfig(lr=lr, weight_decay=weight_decay, **kw)

    def init_param(shape, device, cfg):
        st = {"m": _moment(shape, device, cfg)}
        if _factored_dims(shape) is not None:
            st["vr"], st["vc"] = _factored(shape, device)
            st["ur"], st["uc"] = _factored(shape, device)
        else:
            st["v"] = _moment(shape, device, cfg, unsigned=True)
        return st

    def update_param(g, st, v, cfg, t, gen):
        g2 = g.square() + eps1
        dims = _factored_dims(g.shape)
        if dims is not None:
            c, r = dims
            st["vr"] = b2 * st["vr"] + (1 - b2) * g2.mean(dim=c, keepdim=True)
            st["vc"] = b2 * st["vc"] + (1 - b2) * g2.mean(dim=r, keepdim=True)
            u = _approx_rsqrt(g, st["vr"], st["vc"], r)
        else:
            st["v"], vv = update_buffer_lerp(st["v"], g2, b2, gen)
            u = g * torch.rsqrt(vv + 1e-30)
        rms = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        st["m"], m = update_buffer_lerp(st["m"], u, b1, gen)
        if dims is None:
            return m
        # confidence-residual factorization
        res = (u - m).square() + eps2
        st["ur"] = b3 * st["ur"] + (1 - b3) * res.mean(dim=c, keepdim=True)
        st["uc"] = b3 * st["uc"] + (1 - b3) * res.mean(dim=r, keepdim=True)
        return _approx_rsqrt(m, st["ur"], st["uc"], r)

    return make_optimizer(init_param, update_param, cfg)
