"""Trainable quantized matmuls.

The JAX package's ``train.matmul`` over torch tensors.  A quantized weight
trains without a master copy: ``TrainQTensor = (QTensor, delta)``.  The
forward multiplies by the stored codes (the static int8 / fp8 GEMM, or the
weight-only kernel below 32 rows) and never reads ``delta``; the backward
hands dL/dW to ``delta`` and computes the input gradient and the weight
gradient as dynamically quantized GEMMs in the layer's own matmul family:

* grad-input ``g · W``: where the stored weight already is a rowwise int8 /
  uint8 matmul operand (the "fast" route), the weight's row scales fold
  into the cotangent in B1's prologue (``x_colscale``) and B1's "nn" GEMM
  reads the stored (O, K) codes as they lie; else the dequantized weight is
  quantized columnwise and goes through the same "nn" GEMM;
* grad-weight ``gᵀ · x``: both operands quantized columnwise over the
  tokens and multiplied by B10 (``kernels.scaled_mm.scaled_mm_tn``).

``save_quantized_activations`` selects the JAX package's "ckpt" variant:
the forward saves its input quantized (emitted by B1 where the fused
static route runs, else quantized columnwise) instead of the raw input.

The optimizer writes ``requantize(dequant(qt) + update)`` into
``TrainQTensor.qt`` (``optim``).

The gradient carrier: the JAX package's ``delta`` is a full fp32 array of
zeros, whose cotangent is the weight gradient.  Here ``delta`` is one fp32
zero expanded to the weight's shape (stride 0): a leaf that costs 4 bytes
yet receives a full-shape ``.grad``, where a zero-filled leaf would cost 4
bytes per weight on top of that gradient.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from ..formats import get_format
from ..kernels import scaled_mm as _smm
from ..kernels.dispatch import route_fp8_to_int8
from ..layers import _quantized_matmul_2d, _weight_as_int8, \
    _weight_only_linear_2d
from ..quant.core import quantize_fp_mm, quantize_int_mm, quantize_uint_mm
from ..quant.hadamard import rotate_hadamard
from ..tensor import QTensor, dequantize, quantize_tensor
from ..tree import tree_map

__all__ = ["TrainQTensor", "make_train_params", "train_qlinear",
           "train_forward", "train_backward", "keep_for_backward",
           "grad_input_stats", "token_stats_reduced", "token_stats",
           "extract_weight_grads", "apply_weight_updates", "grad_carrier",
           "DynamicTensor", "dynamic_qlinear"]


def grad_carrier(shape, device) -> torch.Tensor:
    """A leaf of ``shape`` that requires grad and holds one fp32 zero."""
    return torch.zeros((), dtype=torch.float32, device=device).expand(
        tuple(shape)).requires_grad_()


@dataclasses.dataclass
class TrainQTensor:
    """Quantized parameter + gradient carrier (``delta.grad`` is dL/dW)."""
    qt: QTensor
    delta: torch.Tensor

    @property
    def shape(self):
        return self.qt.meta.original_shape


def _is_q(x) -> bool:
    return isinstance(x, (QTensor, TrainQTensor))


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def make_train_params(params):
    """Wrap every QTensor in a TrainQTensor with a gradient carrier, and
    make every floating tensor a leaf that requires grad (JAX
    differentiates every floating leaf of the tree it is given)."""
    def wrap(leaf):
        if isinstance(leaf, QTensor):
            return TrainQTensor(qt=leaf, delta=grad_carrier(
                leaf.meta.original_shape, leaf.qdata.device))
        if _is_float(leaf):
            return leaf.detach().requires_grad_()
        return leaf
    return tree_map(wrap, params, is_leaf=_is_q)


def extract_weight_grads(params):
    """The gradients as a tree of the params' structure: ``delta.grad`` at
    each TrainQTensor, ``.grad`` at each floating leaf, None elsewhere."""
    def grad(leaf):
        if isinstance(leaf, TrainQTensor):
            return leaf.delta.grad
        if _is_float(leaf):
            return leaf.grad
        return None
    return tree_map(grad, params, is_leaf=_is_q)


def apply_weight_updates(params, updates, generator=None):
    """new_W = dequant(qt) + update, requantized (stochastic rounding from
    ``generator`` when given); a TrainQTensor comes back as its QTensor, as
    in the JAX package.  ``updates`` is a tree of the params' structure
    (None where nothing changes)."""
    def upd(p, u):
        if isinstance(p, TrainQTensor):
            p = p.qt
        if isinstance(p, QTensor) and u is not None:
            meta = p.meta
            w_new = dequantize(p, torch.float32) + u.float()
            return quantize_tensor(
                w_new, meta.fmt, meta.layer_kind,
                matmul_fmt=meta.matmul_fmt, group_size=meta.group_size,
                hadamard_group_size=meta.hadamard_group_size,
                svd_rank=meta.svd_rank or 32, use_svd=meta.svd_rank > 0,
                use_hadamard=meta.use_hadamard,
                use_quantized_matmul=meta.use_quantized_matmul,
                use_stochastic_rounding=generator is not None,
                dequant_dtype=meta.dequant_dtype, generator=generator)
        if u is not None and _is_float(p):
            return (p.detach().float() + u.float()).to(p.dtype)
        return p
    return tree_map(upd, params, updates, is_leaf=_is_q)


# ---------------------------------------------------------------------------
# The trainable linear op
# ---------------------------------------------------------------------------

def _uint8_zp_rows(b_q, b_s, b_zp, kdim):
    """Weight-side zero-point rank-1 rows for the asymmetric GEMM."""
    colsum = b_q.to(torch.int32).sum(-1)[None, :].float()
    s = b_s.reshape(1, -1)
    z = b_zp.reshape(1, -1)
    return z, colsum * s + float(kdim) * z


def _exec_fmt(mm_fmt: str) -> str:
    """Execution matmul family for ``mm_fmt``.  The H100 has fp8 tensor
    cores, so fp8 stays fp8 (``route_fp8_to_int8`` is False); the
    forward's emitted residual, the saved-activation quantize and the
    backward GEMMs all ask here, so they agree."""
    f = get_format(mm_fmt)
    if not f.is_integer and f.num_bits == 8 and route_fp8_to_int8():
        return "int8"
    return mm_fmt


def _dynamic_mm(a, b_t, mm_fmt: str = "int8", out_dtype=torch.float32):
    """a (M, K) × b_t (N, K) -> (M, N), both quantized per call in the
    family of ``mm_fmt`` (b_t rowwise here, a in B1's prologue)."""
    f = get_format(mm_fmt)
    b_t = b_t.float()
    if f.is_integer and not f.is_unsigned:
        b_q, b_s = quantize_int_mm(b_t, -1)
        return _smm.scaled_mm_fused_act(a, b_q, b_s, None, x_fmt="int8",
                                        out_dtype=out_dtype)
    if f.is_integer:
        b_q, b_s, b_zp = quantize_uint_mm(b_t, -1)
        z0, z1 = _uint8_zp_rows(b_q, b_s, b_zp, a.shape[-1])
        return _smm.scaled_mm_fused_act(a, b_q, b_s, None, x_fmt="uint8",
                                        out_dtype=out_dtype, v_zp0=z0,
                                        v_zp1=z1)
    if f.num_bits == 8:
        b_q, b_s = quantize_fp_mm(b_t, -1, fmt=f)
        return _smm.scaled_mm_fused_act(a, b_q, b_s, None, x_fmt=f.name,
                                        out_dtype=out_dtype)
    return _smm.bf16_scaled_mm(a, b_t, None, None, None, out_dtype=out_dtype)


def _row_scale(stats, i, fmt):
    """Scale ``i`` of the given statistics (None: quantize by the
    operand's own)."""
    if stats is None or stats[i] is None:
        return None
    return _smm.row_scale_from_amax(stats[i], fmt).reshape(-1)


def token_stats(x, unsigned: bool, comm=None):
    """x's (M, N) per-column statistics over its rows (the tokens),
    all-reduced over ``comm`` (a data axis's ``AxisComm``) where given:
    the absolute maxima (N,), or for the asymmetric family (minima,
    maxima), reduced as one maximum of (-min, max), exact."""
    if unsigned:
        r = torch.stack([-x.amin(0), x.amax(0)]).float()
        r = comm.amax(r) if comm is not None else r
        return -r[0], r[1]
    a = x.abs().amax(0).float()
    return comm.amax(a) if comm is not None else a


def _dynamic_mm_nn(a, b, mm_fmt: str = "int8", out_dtype=torch.float32,
                   stats=None):
    """a (M, C) × b (C, N) -> (M, N) contracting b's leading axis: the
    grad-input GEMM in natural layouts.  b is quantized columnwise (per
    output column n), a per row in B1's prologue, and B1's "nn" GEMM reads
    b as it lies.  ``stats`` (``grad_input_stats``: a's row and b's
    column absolute maxima; uint8: a's row absolute maxima and b's
    negated column minima and maxima) replaces the operands' own."""
    f = get_format(mm_fmt)
    bf = b.float()
    if f.is_integer and not f.is_unsigned:
        if stats is not None:
            b_s = _row_scale(stats, 1, "int8").reshape(1, -1)
            b_q = _smm.quantize_with_scale(bf, b_s, "int8")
        else:
            b_q, b_s = quantize_int_mm(bf, 0)
        return _smm.scaled_mm_fused_act(
            a, b_q, b_s.reshape(-1), None, x_fmt="int8",
            out_dtype=out_dtype, b_layout="nn",
            x_row_scale=_row_scale(stats, 0, "int8"))
    if f.is_integer:
        # asymmetric b (per column n): b = b_q·s + zp ⇒ out += rowsum(a) ⊗ zp
        if stats is not None:   # (a's row amax, -b's column min, its max)
            b_s, b_zp = _smm.uint8_scale_from_range(
                -stats[1].reshape(1, -1), stats[2].reshape(1, -1))
            b_q = _smm.quantize_with_range(bf, b_s, b_zp)
        else:
            b_q, b_s, b_zp = quantize_uint_mm(bf, 0)
        u = a.float().sum(1, keepdim=True)
        v = b_zp.reshape(1, -1).float()
        return _smm.scaled_mm_fused_act(a, b_q, b_s.reshape(-1), None,
                                        x_fmt="int8", out_dtype=out_dtype,
                                        b_layout="nn", lowrank_u=u,
                                        lowrank_v=v,
                                        x_row_scale=_row_scale(stats, 0,
                                                               "int8"))
    if f.num_bits == 8:
        if stats is not None:
            b_s = _row_scale(stats, 1, f.name).reshape(1, -1)
            b_q = _smm.quantize_with_scale(bf, b_s, f.name)
        else:
            b_q, b_s = quantize_fp_mm(bf, 0, fmt=f)
        return _smm.scaled_mm_fused_act(
            a, b_q, b_s.reshape(-1), None, x_fmt=f.name,
            out_dtype=out_dtype, b_layout="nn",
            x_row_scale=_row_scale(stats, 0, f.name))
    # 16-bit family: bf16 values, products exact in fp32, fp32 sums
    acc = a.to(torch.bfloat16).float() @ bf.to(torch.bfloat16).float()
    return acc.to(out_dtype)


def _fwd_value(x2d, qt, bias, use_quantized_matmul, emit_quantized=False,
               out_dtype=torch.bfloat16, x_amax_reduce=None):
    if (use_quantized_matmul and qt.meta.use_quantized_matmul
            and x2d.shape[0] >= 32):
        return _quantized_matmul_2d(x2d, qt, bias, out_dtype,
                                    emit_quantized=emit_quantized,
                                    x_amax_reduce=x_amax_reduce)
    assert not emit_quantized
    return _weight_only_linear_2d(x2d, qt, bias, out_dtype)


def _fused_emit_eligible(qt, m_rows, use_quantized_matmul) -> bool:
    """True when the forward takes the fused static GEMM, whose row
    quantize can be the ckpt residual: symmetric int8 / fp8, and the
    asymmetric uint8 family (residual (x_q, s, zp); the grad-weight adds a
    rank-1 (gᵀ·zp) ⊗ 1_K term)."""
    meta = qt.meta
    if not (use_quantized_matmul and meta.use_quantized_matmul
            and m_rows >= 32 and not meta.re_quantize_for_matmul):
        return False
    mfmt = meta.matmul_format
    if mfmt.is_integer:
        # packed sub-byte codes ride a uint8 container, not a uint8 operand
        return (not meta.is_packed
                and qt.qdata.dtype in (torch.int8, torch.uint8))
    return mfmt.num_bits == 8


def _save_columnwise(x2d, qt, comm=None):
    """The ckpt residual where no kernel emits one: x quantized columnwise
    (per feature, over the tokens) in the layer's execution family, so the
    grad-weight GEMM contracts it as it lies; under a data axis (``comm``)
    against the statistics of every rank's tokens, so that the codes are
    the unsharded batch's."""
    f = get_format(_exec_fmt(qt.meta.matmul_fmt))
    xf = x2d.float()
    if f.num_bits > 8:
        return (xf.to(torch.bfloat16),)
    if comm is None:
        if f.is_integer and not f.is_unsigned:
            return quantize_int_mm(xf, 0)
        if f.is_integer:
            return quantize_uint_mm(xf, 0)
        return quantize_fp_mm(xf, 0, fmt=f)
    st = token_stats(xf, f.is_unsigned, comm)
    if f.is_unsigned:
        s, zp = _smm.uint8_scale_from_range(*(v.reshape(1, -1) for v in st))
        return _smm.quantize_with_range(xf, s, zp), s, zp
    name = "int8" if f.is_integer else f.name
    s = _smm.row_scale_from_amax(st, name).reshape(1, -1)
    return _smm.quantize_with_scale(xf, s, name), s


def _fast_grad_input(qt) -> bool:
    """Whether the stored weight is already a rowwise int8 / uint8
    operand of the grad-input GEMM."""
    meta = qt.meta
    q2d = qt.qdata
    if q2d.dim() > 2:
        q2d = q2d.reshape(q2d.shape[0], -1)
    return (meta.use_quantized_matmul and not meta.re_quantize_for_matmul
            and meta.matmul_format.is_integer and not meta.is_packed
            and q2d.dtype in (torch.int8, torch.uint8)
            and qt.scale.numel() == q2d.shape[0])


def _dequant_2d(qt):
    w_deq = dequantize(qt, torch.float32)
    if w_deq.dim() > 2:
        w_deq = w_deq.reshape(w_deq.shape[0], -1)
    return w_deq


def grad_input_stats(g2d, qt):
    """The statistics the grad-input GEMM ``g · W`` quantizes by, over
    the contraction (W's rows): ``(row amax of g (M,), column amax of W
    (K,) or None)``; None where its family takes none (16-bit).  A
    column-parallel shard all-reduces them (max) over the tensor axis
    before ``_grad_input``.  The asymmetric (uint8) family quantizes W's
    columns by their ranges: ``(row amax of g, -column min of W, column
    max of W)``, so that a maximum reduces each."""
    f = get_format(_exec_fmt(qt.meta.matmul_fmt))
    if _fast_grad_input(qt):
        w_s = _weight_as_int8(qt)[1].reshape(1, -1).float()
        return ((g2d.float() * w_s).abs().amax(-1), None)
    if f.num_bits > 8:
        return None
    w = _dequant_2d(qt)
    if f.is_unsigned:
        return (g2d.float().abs().amax(-1), -w.amin(0), w.amax(0))
    return (g2d.float().abs().amax(-1), w.abs().amax(0))


def _grad_input(g2d, qt, x_dtype, stats=None):
    meta = qt.meta
    if not _fast_grad_input(qt):
        return _dynamic_mm_nn(g2d, _dequant_2d(qt),
                              _exec_fmt(meta.matmul_fmt), out_dtype=x_dtype,
                              stats=stats)
    # the stored rowwise codes: g @ (W_q·s + zp·1ᵀ) = (g·sᵀ) @ W_q +
    # (g @ zp)·1ᵀ, the row scales folded into B1's prologue (x_colscale)
    # and the zero-point / SVD terms a rank-R term after the kernel
    w_q, w_s, w_zp = _weight_as_int8(qt)
    u_cols, v_rows = [], []
    if w_zp is not None:
        u_cols.append(g2d.float() @ w_zp.reshape(-1, 1).float())
        v_rows.append(torch.ones((1, w_q.shape[1]), dtype=torch.float32,
                                 device=g2d.device))
    if qt.svd_up is not None:
        u_cols.append(g2d.float() @ qt.svd_up.float())
        v_rows.append(qt.svd_down.float())
    u = torch.cat(u_cols, dim=-1) if u_cols else None
    v = torch.cat(v_rows, dim=0) if v_rows else None
    gx = _smm.scaled_mm_fused_act(g2d, w_q, None, None, x_fmt="int8",
                                  out_dtype=x_dtype, b_layout="nn",
                                  lowrank_u=u, lowrank_v=v,
                                  x_colscale=w_s.reshape(-1),
                                  x_row_scale=_row_scale(stats, 0, "int8"))
    if meta.use_hadamard:
        # W lives in rotated space: rotate the cotangent back (the
        # normalized Hadamard is its own inverse)
        gx = rotate_hadamard(gx, meta.hadamard_group_size)
    return gx


def _grad_weight(g2d, saved, qt, emitted, save_q_acts, token_comm=None):
    meta = qt.meta
    mm_fmt = _exec_fmt(meta.matmul_fmt)
    f = get_format(mm_fmt)
    if emitted:
        # the forward's own row-quantized input (x = xq·s_x[m], after the
        # Hadamard rotation): fold the row scales into the cotangent so
        # both B10 operands are plain codes:
        #   gw[n, k] = Σ_m (g[m, n]·s_x[m]) · xq[m, k]
        xzp = None
        if len(saved) == 3:
            xq, xs, xzp = saved       # asymmetric: x = xq·s + zp
        else:
            xq, xs = saved
        gf = g2d.float() * xs.float()
        if token_comm is not None:   # the columns over every rank's tokens
            name = "int8" if f.is_integer else f.name
            gs = _smm.row_scale_from_amax(token_stats(gf, False, token_comm),
                                          name).reshape(1, -1)
            gq = _smm.quantize_with_scale(gf, gs, name)
        elif f.is_integer:
            gq, gs = quantize_int_mm(gf, 0)
        else:
            gq, gs = quantize_fp_mm(gf, 0, fmt=f)
        u = v = None
        if xzp is not None:
            # gw += (Σ_m g[m, n]·zp[m]) ⊗ 1_K
            u = g2d.float().T @ xzp.float()
            v = torch.ones((1, xq.shape[1]), dtype=torch.float32,
                           device=g2d.device)
        gw = _smm.scaled_mm_tn(gq, xq, gs.reshape(-1), None,
                               out_dtype=torch.float32, lowrank_u=u,
                               lowrank_v=v)
        if meta.use_hadamard:
            gw = rotate_hadamard(gw, meta.hadamard_group_size)
    elif save_q_acts and not (f.is_integer or f.num_bits == 8):
        gw = _smm.dynamic_mm_tn(g2d, saved[0], mm_fmt)
    elif save_q_acts:
        stats = None
        if token_comm is not None:   # g's columns over every rank's tokens
            stats = (token_stats(g2d.float(), f.is_unsigned, token_comm),
                     None)
        gw = _smm.dynamic_mm_tn(g2d, None, mm_fmt, saved_b=saved,
                                stats=stats)
    else:
        x = saved[0].float()
        stats = None
        if token_comm is not None and (f.is_integer or f.num_bits == 8):
            # the tokens' statistics over every data rank's tokens
            stats = (token_stats(g2d.float(), f.is_unsigned, token_comm),
                     token_stats(x, f.is_unsigned, token_comm))
        gw = _smm.dynamic_mm_tn(g2d, x, mm_fmt, stats=stats)
    return gw.reshape(meta.original_shape)


def train_forward(x2d, bias, qt, save_q_acts, use_quantized_matmul,
                  out_dtype=torch.bfloat16, x_amax_reduce=None):
    """The trainable linear's forward: ``(y, saved residuals, emitted)``;
    ``x_amax_reduce`` as ``layers.qlinear``'s."""
    emitted = save_q_acts and _fused_emit_eligible(
        qt, x2d.shape[0], use_quantized_matmul)
    if emitted:
        # B1 emits its row-quantized input: no second quantize pass
        y, *saved = _fwd_value(x2d, qt, bias, use_quantized_matmul,
                               emit_quantized=True, out_dtype=out_dtype,
                               x_amax_reduce=x_amax_reduce)
    else:
        y = _fwd_value(x2d, qt, bias, use_quantized_matmul,
                       out_dtype=out_dtype, x_amax_reduce=x_amax_reduce)
        saved = (_save_columnwise(x2d, qt, getattr(_TOKENS, "comm", None))
                 if save_q_acts else (x2d,))
    return y, tuple(saved), emitted


def train_backward(ctx, g, needs, stats=None, partial=False):
    """The trainable linear's gradients ``(gx, gw, gb)`` from the
    cotangent ``g`` and what ``ctx`` kept (saved tensors, qt, emitted,
    save_q_acts, x_dtype, bias_dtype); ``needs`` the three inputs' flags.
    ``stats``: the grad-input quantization's statistics
    (``grad_input_stats``), all-reduced over a tensor axis.  ``partial``:
    gx is a column-parallel shard's partial sum, kept in fp32 so that the
    ranks' sum is rounded to x's type once, as the unsharded layer's."""
    saved = ctx.saved_tensors
    # the cotangent stays in its own (bf16) type: the quantize passes read
    # it as it is
    g2d = g.reshape(-1, g.shape[-1])
    gx = gw = gb = None
    if needs[0]:
        gx_dtype = torch.float32 if partial else ctx.x_dtype
        gx = _grad_input(g2d, ctx.qt, gx_dtype, stats).to(gx_dtype)
    if needs[1]:
        gw = _grad_weight(g2d, saved, ctx.qt, ctx.emitted, ctx.save_q_acts,
                          getattr(ctx, "token_comm", None))
    if ctx.bias_dtype is not None and needs[2]:
        gb = g2d.float().sum(0).to(ctx.bias_dtype)
    return gx, gw, gb


_TOKENS = threading.local()


@contextlib.contextmanager
def token_stats_reduced(comm):
    """Within the block (on this thread), the trainable linears take their
    per-column statistics over the tokens (the grad-weight's operands, the
    saved quantized activations) over every rank of ``comm`` (a data
    axis's ``AxisComm``: its all-reduce, max), so that data parallelism
    computes the unsharded batch's gradient."""
    prev = getattr(_TOKENS, "comm", None)
    _TOKENS.comm = comm if comm is not None and comm.size > 1 else None
    try:
        yield
    finally:
        _TOKENS.comm = prev


def keep_for_backward(ctx, x2d, bias, qt, saved, emitted, save_q_acts):
    ctx.save_for_backward(*saved)
    ctx.qt, ctx.emitted, ctx.save_q_acts = qt, emitted, save_q_acts
    ctx.x_dtype = x2d.dtype
    ctx.bias_dtype = None if bias is None else bias.dtype
    ctx.token_comm = getattr(_TOKENS, "comm", None)


class _TrainLinear(torch.autograd.Function):
    """y = x @ W_qᵀ + b from the stored codes; straight-through gradients
    into ``delta`` (the JAX package's ``_train_linear`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x2d, delta, bias, qt, save_q_acts, use_quantized_matmul,
                out_dtype=torch.bfloat16, x_amax_reduce=None):
        y, saved, emitted = train_forward(x2d, bias, qt, save_q_acts,
                                          use_quantized_matmul, out_dtype,
                                          x_amax_reduce)
        keep_for_backward(ctx, x2d, bias, qt, saved, emitted, save_q_acts)
        return y

    @staticmethod
    def backward(ctx, g):
        gx, gw, gb = train_backward(ctx, g, ctx.needs_input_grad[:3])
        return gx, gw, gb, None, None, None, None, None


def train_qlinear(x, w: TrainQTensor, bias=None, *,
                  save_quantized_activations: bool = False,
                  out_dtype=torch.bfloat16, x_amax_reduce=None):
    """Trainable quantized linear: y = x @ W_qᵀ + b (bf16, or
    ``out_dtype``: a row-parallel shard's fp32 partial sum) with
    straight-through gradients into ``w.delta``; ``x_amax_reduce`` as
    ``layers.qlinear``'s."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    y = _TrainLinear.apply(x2d, w.delta, bias, w.qt,
                           save_quantized_activations,
                           w.qt.meta.use_quantized_matmul, out_dtype,
                           x_amax_reduce)
    return y.reshape(*lead, y.shape[-1])


# ---------------------------------------------------------------------------
# Dynamic-only training matmul (use_static_quantization=False): the weight
# stays full precision and both operands quantize per call; round() has no
# gradient, so the straight-through backward is written out.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DynamicTensor:
    """Full-precision weight whose matmuls run dynamically quantized in the
    ``fmt`` family (int8 / uint8 / fp8 / 16-bit)."""
    w: torch.Tensor
    fmt: str = "int8"

    @property
    def shape(self):
        return tuple(self.w.shape)


class _DynamicLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, w, bias, fmt):
        y = _dynamic_mm(x2d.float(), w.float(), fmt, out_dtype=torch.float32)
        if bias is not None:
            y = y + bias.float()
        ctx.save_for_backward(x2d, w)
        ctx.fmt = fmt
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        g2d = g.float()
        gx = _dynamic_mm_nn(g2d, w.float(), ctx.fmt).to(x2d.dtype)
        gw = _smm.dynamic_mm_tn(g2d, x2d.float(), ctx.fmt).to(w.dtype)
        gb = None if ctx.bias_dtype is None else g2d.sum(0).to(ctx.bias_dtype)
        return gx, gw, gb, None


def dynamic_qlinear(x, w, bias=None):
    lead = x.shape[:-1]
    fmt = w.fmt if isinstance(w, DynamicTensor) else "int8"
    weight = w.w if isinstance(w, DynamicTensor) else w
    y = _DynamicLinear.apply(x.reshape(-1, x.shape[-1]), weight, bias, fmt)
    return y.reshape(*lead, y.shape[-1])
