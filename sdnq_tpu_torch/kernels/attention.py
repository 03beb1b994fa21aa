"""Quantized scaled-dot-product attention.

Kernel ``flash_attention`` (B3, ``csrc/flash_attn.cuh``, built as
``flash_attn.cu`` for bf16 and int8 Q·K and ``flash_attn_e4m3.cu`` for
e4m3) beside its plain
version and launch counters.  It replaces ``sdnq_tpu/kernels/attention.py``
``_attn_kernel`` in these modes: bf16 Q·Kᵀ with sm_scale·log2(e) folded
into q, or int8 Q·Kᵀ with per-token scales (qs carrying sm_scale·log2(e)); bool
masks, and additive bf16 / fp32 masks (the score plus mask·log2(e), as T5's
relative position bias reaches it); causal attention with its block skip;
grouped KV heads; P·V in bf16,
or in int8 on per-token-quantized V ("token" mode, P quantized once per
block of ``p_block`` keys).  Softmax in base 2.  At FLUX's shape (24 heads,
4608 tokens, head dim 128) and at Llama prefill it is bound by tensor-core
operations; the kernel keeps the score matrix on chip.

The plain version mirrors the JAX package's KERNEL path (attention.py
:597-631: pre-folded scale, exp2, P rounded to V's dtype before a bf16 P·V,
P quantized per P block in token mode), with one full softmax instead of
the online one in the bf16 mode.

``quantized_attention`` keeps the JAX route: where the JAX wrapper runs its
kernel (N % 8 == 0, KN % 128 == 0, D <= 256) the port runs B3; elsewhere,
which is every decode step at N = 1, it runs ``attention_xla``, a torch
port of the JAX package's XLA function ``_attn_xla`` (``exp``, an fp32
softmax, P quantized over the whole row), in plain torch on both devices:
the JAX package computes that step outside any Pallas kernel.

Kernel ``flash_attention_block`` (B9, the block mode of
``csrc/flash_attn.cuh``) replaces ``_attn_kernel`` with ``partial_out=True``
(``_attn_block_pallas``): one KV block's unnormalised fp32 (acc, m, l) in
natural-log units, for the ring's merge (``parallel/ring_attention.py``).
It keeps the JAX route of ``flash_attention_block``: B9 where N % 8, KN %
128 and D % 128 are 0, ``attention_block_xla`` (the XLA block function)
elsewhere, in plain torch on both devices.

Two more modes follow the JAX wrapper line for line.  fp8 e4m3 Q·K
(``matmul_dtype`` "fp8" or "float8_e4m3fn"): q and k quantized per token by
``quantize_fp_mm``, the product summed in fp32 (the kernel converts its e4m3
stages to fp16 in shared memory and runs the fp16 ``wgmma``: e4m3 values
and their products are exact there), then times q_scale·k_scale.  Head-mode
int8 P·V (``pv_scale_mode="head"``, the JAX default): one V scale per
(batch, KV head), vs = max|v| / 127, v_q = rint(v / vs); on the kernel
route the JAX constant-p-scale body (:127-141): p127 = exp2(s − (m −
log2 127)) per P block, l sums the unrounded p127, rint(p127) times v_q in
int8, out = acc / l rounded to the output type, then times vs; on the XLA
route (:633-652) token-mode requantisation of P over the whole row with V
scales of 1, then times vs.

Head dims.  The kernels hold head dims 64, 128 and 256 (the JAX wrapper
pads any D <= 256 to max(128, pow2(D)), :592-631).  On the card
``flash_attention`` pads q, k and v with zeros to the next of those
(``kernel_head_dim``) and slices the output back to v's head dim, which
may differ from q's: zeros add nothing to Q·Kᵀ or P·V, and the per-token
scales are taken before the padding, so the function is unchanged.  The
softmax scale is the caller's, from q's own head dim, never the padded
one (``quantized_attention`` folds it into q or q_scale before the kernel
sees the operands).  Head dims above 256 raise, where the JAX route leaves
its kernel too.  B9 holds D 128 and 256 (its JAX route takes D % 128 =
0).

``trainable_attention`` is ``quantized_attention`` with a gradient.  The
JAX package cannot differentiate its attention kernel (``pallas_call`` has
no reverse-mode rule and ``_attn_kernel`` no custom_vjp); it trains through
``_attn_xla``, where the kernel's route predicate fails.  So the gradient
here is that of the XLA route: the forward runs ``quantized_attention`` as
it is (B3 on the card), saving q, k and v, and the backward recomputes the
XLA route (``attention_xla``) under autograd and returns its gradients, at
the memory of one layer's scores.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._build import P, I
from .dispatch import is_cuda
from ..quant.core import quantize_fp_mm, quantize_int_mm
from ..quant.hadamard import (
    get_hadamard_group_size, next_power_of_2, rotate_hadamard,
)

__all__ = ["flash_attention", "flash_attention_plain", "attention_xla",
           "quantized_attention", "quantize_kv", "attn_auto_matmul_dtype",
           "attn_kernel_route", "attn_p_block", "trainable_attention",
           "flash_attention_block", "flash_attention_block_plain",
           "attention_block_xla", "block_kernel_route", "kernel_head_dim"]

LOG2E = math.log2(math.e)
LOG2_127 = math.log2(127.0)
_NEG_INF = -1e30
# the head dims the kernels hold; other dims up to 256 are padded
_HEAD_DIMS = (64, 128, 256)
_L = ctypes.c_longlong
# mask kinds and Q.K kinds of csrc/flash_attn.cuh
_MASK_KINDS = {torch.bool: 1, torch.bfloat16: 2, torch.float32: 3}
_QK_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


def _library(q, d: int) -> str:
    """The library of q's Q·K kind and head dim d (e4m3, and bf16 / int8
    at D 256, are built apart)."""
    if q.dtype == torch.float8_e4m3fn:
        return "flash_attn_e4m3"
    return "flash_attn_d256" if d == 256 else "flash_attn"


def kernel_head_dim(d: int) -> int | None:
    """The head dim of the kernel that runs head dim ``d``: the first of
    64, 128 and 256 at or above it; None above 256."""
    return next((h for h in _HEAD_DIMS if d <= h), None)


def _pad_head(t, d: int):
    """t (..., D) with zero columns up to d (int8 and fp8 codes padded as
    bytes: a zero byte is their zero)."""
    pad = d - t.shape[-1]
    if not pad:
        return t
    if t.element_size() == 1:
        return torch.nn.functional.pad(t.view(torch.uint8),
                                       (0, pad)).view(t.dtype)
    return torch.nn.functional.pad(t, (0, pad))
_FP8 = ("fp8", "float8_e4m3fn")


def quantize_kv(k, v=None):
    """Per-token int8 quantization of K/V rows (B, KH, N, D): returns
    (k_q, k_scale (B, KH, N)[, v_q, v_scale])."""
    k_q, k_s = quantize_int_mm(k.float(), -1)
    if v is None:
        return k_q, k_s[..., 0]
    v_q, v_s = quantize_int_mm(v.float(), -1)
    return k_q, k_s[..., 0], v_q, v_s[..., 0]


def attn_auto_matmul_dtype(n: int, kn: int, d: int) -> str | None:
    """``matmul_dtype="auto"``: int8 Q·Kᵀ for d <= 64 and n, kn >= 4096,
    else bf16.  These are the JAX package's thresholds, kept so that both
    packages take the same mode on the same shapes; they were not measured
    on the H100."""
    if d <= 64 and min(n, kn) >= 4096:
        return "int8"
    return None


def attn_kernel_route(n: int, kn: int, d: int) -> bool:
    """Whether the JAX wrapper runs its Pallas kernel at this shape (its
    TPU rule: 8-row sublanes, 128-key lanes, head dim <= 256), kept for
    parity: elsewhere both packages take the XLA function."""
    return n % 8 == 0 and kn % 128 == 0 and d <= 256


def attn_p_block(kn: int) -> int:
    """Keys per P block in token mode: the JAX wrapper's KV block, min(512,
    KN) halved until it divides KN (its TPU block rule, kept for parity:
    the block is where P is requantized, so it is part of the function)."""
    bk = min(512, kn)
    while kn % bk:
        bk //= 2
    return bk


def _expand_kv(t, q_per_kv):
    """(B·KH, ...) -> (B·H, ...): each KV head repeated for its group."""
    return t if q_per_kv == 1 else t.repeat_interleave(q_per_kv, dim=0)


def _mask_scores(s, b, h, mask, causal, coef: float = 1.0):
    """s (B·H, N, KN) with -1e30 where a bool mask (broadcast to (B, H, N,
    KN)) is False or, causal, right of the diagonal; a float mask is added,
    times ``coef`` (log2(e) in the exp2 domain)."""
    n, kn = s.shape[-2:]
    if causal:
        keep = (torch.arange(n, device=s.device)[:, None]
                >= torch.arange(kn, device=s.device)[None, :])
        s = torch.where(keep, s, _NEG_INF)
    if mask is not None:
        m = mask.expand(b, h, n, kn).reshape(b * h, n, kn)
        if mask.dtype == torch.bool:
            s = torch.where(m, s, _NEG_INF)
        else:
            s = s + m.float() * coef
    return s


def _div(x, c: float):
    """x / c as a true division also on the card (a torch division by a
    Python scalar runs there as a multiply by the reciprocal)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def flash_attention_plain(q, k, v, q_scale=None, k_scale=None,
                          out_dtype=torch.bfloat16, *, heads=None, mask=None,
                          causal=False, v_scale=None, p_block=None,
                          v_head_scale=None):
    """Plain version of ``flash_attention``: q (B·H, N, D) float (pre-scaled
    q), or int8 or e4m3 with q_scale (B·H, N); k, v (B·KH, KN, D) with
    k_scale (B·KH, KN); ``heads`` H (B·H when None); ``mask`` bool or
    additive float, broadcastable to (B, H, N, KN); ``causal`` masks key j
    > query i.  Base-2 softmax, the additive mask times log2(e); the
    running max starts at -1e30, so a row masked by -inf everywhere gives
    0.  With ``v_scale`` (B·KH, KN), v holds int8 codes and P·V runs in
    token mode, P quantized per block of ``p_block`` keys; with
    ``v_head_scale`` (B·KH,), v holds int8 codes of one scale per KV head
    and P·V runs in head mode over the same blocks (p127 = exp2(s − (m −
    log2 127)), rounded, times the codes; the output rounded to
    ``out_dtype``, then times the head's scale); else P is rounded to v's
    dtype before P·V."""
    bh, n, _ = q.shape
    h = bh if heads is None else heads
    qpk = bh // k.shape[0]
    k, v = _expand_kv(k, qpk), _expand_kv(v, qpk)
    if q_scale is not None:
        k_scale = _expand_kv(k_scale, qpk)
        s = (q.double() @ k.double().transpose(1, 2)).float()  # exact int
        s = s * q_scale.reshape(bh, n)[..., None] * k_scale[:, None, :]
    else:
        s = q.float() @ k.float().transpose(1, 2)
    s = _mask_scores(s, bh // h, h, mask, causal, LOG2E)
    if v_scale is None and v_head_scale is None:
        m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        acc = p.to(v.dtype).float() @ v.float()
        return (acc / l.clamp_min(1e-30)).to(out_dtype)
    head = v_head_scale is not None
    if not head:
        vs = _expand_kv(v_scale.float(), qpk)
    kn = s.shape[-1]
    m = torch.full((bh, n, 1), _NEG_INF, device=q.device)
    l = torch.zeros((bh, n, 1), device=q.device)
    acc = torch.zeros((bh, n, v.shape[-1]), device=q.device)
    for k0 in range(0, kn, p_block):
        sb = s[..., k0:k0 + p_block]
        m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        if head:
            p127 = torch.exp2(sb - (m_new - LOG2_127))
            l = l * alpha + p127.sum(-1, keepdim=True)
            pv = (torch.round(p127).double()
                  @ v[:, k0:k0 + p_block].double()).float()
            acc = acc * alpha + pv
        else:
            p = torch.exp2(sb - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            p_eff = p * vs[:, None, k0:k0 + p_block]
            p_scale = _div(p_eff.amax(-1, keepdim=True).clamp_min(1e-20),
                           127.0)
            p_q = torch.round(p_eff / p_scale)
            pv = (p_q.double() @ v[:, k0:k0 + p_block].double()).float()
            acc = acc * alpha + pv * p_scale
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(out_dtype)
    if head:
        out = _times_head_scale(out, v_head_scale, qpk)
    return out


def _times_head_scale(out, v_head_scale, qpk):
    """Head mode's last step, as the JAX wrapper takes it: the output (B·H,
    N, D) in its own dtype times its KV head's V scale (B·KH,), in fp32,
    rounded back."""
    vs = _expand_kv(v_head_scale.reshape(-1).float(), qpk)
    return (out.float() * vs[:, None, None]).to(out.dtype)


def _vt_scratch(v, int8_pv: bool):
    """The int8 P·V modes' V^T scratch (BKH, D, KN) int8, written by the C
    entry; None in the bf16 P·V mode."""
    if not int8_pv:
        return None
    return torch.empty((v.shape[0], v.shape[2], v.shape[1]), dtype=torch.int8,
                       device=v.device)


def _mode_counts(**on):
    for mode, flag in on.items():
        if flag:
            flash_attention.mode_launches[mode] += 1


def flash_attention(q, k, v, q_scale=None, k_scale=None,
                    out_dtype=torch.bfloat16, *, heads=None, mask=None,
                    causal=False, v_scale=None, p_block=None,
                    v_head_scale=None):
    """Flash attention; see ``flash_attention_plain`` for the function.  On
    the card: q, k bf16 (or int8 or e4m3 with scales), v bf16 (or int8
    with ``v_scale`` or ``v_head_scale``), q's and v's head dims up to 256
    (zero-padded to the kernel's, ``kernel_head_dim``; the output has v's);
    an int8 P·V mode's ``p_block`` is a multiple of 64 up to 512 that
    divides KN; the mask bool, bf16 or fp32 (another float dtype is read
    as fp32), read through its strides."""
    kw = dict(heads=heads, mask=mask, causal=causal, v_scale=v_scale,
              p_block=p_block, v_head_scale=v_head_scale)
    if not is_cuda(q):
        return flash_attention_plain(q, k, v, q_scale, k_scale, out_dtype,
                                     **kw)
    bh, n, d = q.shape
    bkh, kn = k.shape[:2]
    h = bh if heads is None else heads
    quant = q_scale is not None
    int8_pv = v_scale is not None or v_head_scale is not None
    v_want = torch.int8 if int8_pv else torch.bfloat16
    if (q.dtype not in _QK_KINDS or k.dtype != q.dtype
            or quant != (q.dtype != torch.bfloat16) or v.dtype != v_want
            or (v_scale is not None and v_head_scale is not None)):
        raise ValueError(f"flash_attention takes bf16 q/k, or int8 or e4m3 "
                         f"with scales, and {v_want} v; got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    vd = v.shape[-1]
    dk = kernel_head_dim(max(d, vd))
    if dk is None or k.shape[-1] != d:
        raise NotImplementedError(
            f"head dims {d} / {vd}: the kernels take q / k / v head dims up "
            f"to 256 (padded to {_HEAD_DIMS}), q's equal to k's; above 256 "
            "the JAX route leaves its kernel too")
    qpk = bh // bkh if bkh and bh % bkh == 0 else 0
    if (kn < 1 or v.shape[:2] != k.shape[:2] or bh % h or not qpk
            or h % qpk):
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} with {h} heads")
    if int8_pv and not (
            p_block and p_block % 64 == 0 and p_block <= 512
            and kn % p_block == 0):
        raise ValueError(f"int8 P·V block {p_block} for KN {kn}")
    # zero columns up to the kernel's head dim; TMA reads q, k and v: a view
    # off a 16-byte boundary is copied
    q, k, v = (_build.tma_rows(_pad_head(t, dk).contiguous())
               for t in (q, k, v))
    qs = q_scale.reshape(bh, n).float().contiguous() if quant else None
    ks = k_scale.reshape(bkh, kn).float().contiguous() if quant else None
    vs = (v_scale.reshape(bkh, kn).float().contiguous()
          if v_scale is not None else None)
    vh = (v_head_scale.reshape(bkh).float().contiguous()
          if v_head_scale is not None else None)
    strides, mkind = (0, 0, 0, 0), 0
    if mask is not None:
        if mask.dtype not in _MASK_KINDS:
            if not mask.is_floating_point():
                raise ValueError(f"masks are bool or float, not {mask.dtype}")
            mask = mask.float()
        mkind = _MASK_KINDS[mask.dtype]
        mask = mask.expand(bh // h, h, n, kn)
        strides = tuple(mask.stride())
    out = torch.empty((bh, n, dk), dtype=out_dtype, device=q.device)
    vt = _vt_scratch(v, int8_pv)
    if n:
        fn = _build.function(_library(q, dk), "sdnq_flash_attn",
                             [P] * 8 + [_L] * 4 + [P] * 2 + [I] * 11 + [P])
        _build.check(fn(*(_build.ptr(t) for t in (q, k, v, qs, ks, vs, vh,
                                                  mask)),
                        *strides, _build.ptr(out), _build.ptr(vt), bh, n, kn,
                        dk, h, qpk,
                        int(causal), int(p_block or 0), _QK_KINDS[q.dtype],
                        mkind, _build.act_kind(out_dtype), _build.stream(q)),
                     "flash_attention")
        flash_attention.launches += 1
        _mode_counts(masked=mkind == 1, float_mask=mkind > 1, causal=causal,
                     gqa=qpk > 1, int8_pv=v_scale is not None,
                     head_pv=vh is not None, bf16_qk=not quant,
                     int8_qk=q.dtype == torch.int8,
                     e4m3_qk=q.dtype == torch.float8_e4m3fn,
                     padded=dk != d or vd != d, d256=dk == 256)
    return out if vd == dk else out[..., :vd]


flash_attention.launches = 0
# launches of the kernel in each mode (a launch may count in several)
flash_attention.mode_launches = dict(masked=0, float_mask=0, causal=0, gqa=0,
                                     int8_pv=0, head_pv=0, bf16_qk=0,
                                     int8_qk=0, e4m3_qk=0, padded=0, d256=0)


# ---------------------------------------------------------------------------
# B9: flash attention over one KV block, unnormalised partials
# ---------------------------------------------------------------------------

def block_kernel_route(n: int, kn: int, d: int) -> bool:
    """Whether the JAX ``flash_attention_block`` runs its Pallas kernel at
    this shape (its TPU rule: N % 8, KN % 128 and D % 128 all 0, which is
    not ``attn_kernel_route``'s), kept for parity: elsewhere both packages
    take the XLA block function, in plain torch on both devices."""
    return n % 8 == 0 and kn % 128 == 0 and d % 128 == 0


def _block_scores(q, k, q_scale, k_scale, sm_scale, quantized, mask,
                  mask_is_bool, exact: bool):
    """s (BH, N, KN) as the JAX block functions form it: int8 or e4m3
    products in float64, rounded to fp32, times q_scale (carrying sm_scale)
    and k_scale; float q, k times sm_scale after the dot (in float64 where
    ``exact``, as the XLA function's fp32 einsum is held to, else fp32 as
    the kernel's bf16 products sum); the mask (1 or BH, N, KN), row b reading mask row
    b % mask_bh, masks to -1e30 (bool) or is added (float)."""
    bh, n, _ = q.shape
    if quantized or exact:
        s = (q.double() @ k.double().transpose(1, 2)).float()
    else:
        s = q.float() @ k.float().transpose(1, 2)
    if quantized:
        s = s * q_scale.reshape(bh, n, 1) * k_scale[:, None, :]
    elif sm_scale != 1.0:
        s = s * sm_scale
    if mask is not None:
        mask = mask.repeat(bh // mask.shape[0], 1, 1)
        s = (torch.where(mask != 0, s, _NEG_INF) if mask_is_bool
             else s + mask.float())
    return s


def _quantize_p(p, v_scale):
    """Token-mode P: p·vs quantized per row of the block, and its scale."""
    p_eff = p * v_scale[:, None, :].float()
    p_scale = _div(p_eff.amax(-1, keepdim=True).clamp_min(1e-20), 127.0)
    return torch.round(p_eff / p_scale), p_scale


def flash_attention_block_plain(q, k, v, q_scale=None, k_scale=None,
                                v_scale=None, mask=None, *, quantized=True,
                                quantized_pv=False, sm_scale=1.0,
                                mask_is_bool=True):
    """Plain version of B9 (``flash_attention_block``'s kernel route): the
    JAX ``_attn_kernel`` with ``partial_out=True`` step by step, KV blocks
    of ``attn_p_block(KN)`` keys with the online softmax between them in
    natural-log units: m_new = max(m, rowmax s), p = exp(s - m_new), alpha
    = exp(m - m_new), l = l·alpha + Σp, acc = acc·alpha + P·V, where P is
    rounded to v's dtype (bf16 v), or, with int8 v and ``v_scale``
    (``quantized_pv``), p·vs quantized per row of the block.  Returns fp32
    (acc (BH, N, D) unnormalised, m (BH, N, 1), l (BH, N, 1)).  m starts
    at -1e30, so a row that a bool mask hides everywhere has p = 1 for
    every key and l = KN."""
    bh, n, _ = q.shape
    kn = k.shape[1]
    bk = attn_p_block(kn)
    m = torch.full((bh, n, 1), _NEG_INF, device=q.device)
    l = torch.zeros((bh, n, 1), device=q.device)
    acc = torch.zeros((bh, n, v.shape[-1]), device=q.device)
    for k0 in range(0, kn, bk):
        blk = slice(k0, k0 + bk)
        s = _block_scores(q, k[:, blk], q_scale,
                          None if k_scale is None else k_scale[:, blk],
                          sm_scale, quantized,
                          None if mask is None else mask[..., blk],
                          mask_is_bool, exact=False)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vb = v[:, blk]
        if quantized_pv:
            p_q, p_scale = _quantize_p(p, v_scale[:, blk])
            pv = (p_q.double() @ vb.double()).float() * p_scale
        else:
            pv = p.to(vb.dtype).float() @ vb.float()
        acc = acc * alpha + pv
        m = m_new
    return acc, m, l


def attention_block_xla(q, k, v, q_scale=None, k_scale=None, v_scale=None,
                        mask=None, *, quantized=True, quantized_pv=False,
                        sm_scale=1.0, mask_is_bool=True):
    """The JAX package's ``_attn_block_xla`` in torch: one softmax over the
    whole block in fp32 (m the row max, p = exp(s - m), l = Σp), P·V on
    fp32 p, or with ``quantized_pv`` p·vs quantized over the whole row;
    the products in float64, rounded to fp32.  Returns (acc, m, l) as
    ``flash_attention_block_plain``."""
    s = _block_scores(q, k, q_scale, k_scale, sm_scale, quantized, mask,
                      mask_is_bool, exact=True)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if quantized_pv:
        p_q, p_scale = _quantize_p(p, v_scale)
        acc = (p_q.double() @ v.double()).float() * p_scale
    else:
        acc = (p.double() @ v.double()).float()
    return acc, m, l


attention_block_xla.calls = 0

_BLOCK_HEAD_DIMS = (128, 256)
_MASK_BYTES = (torch.bool, torch.int8, torch.uint8)


def flash_attention_block(q, k, v, q_scale=None, k_scale=None, v_scale=None,
                          mask=None, *, quantized=True, quantized_pv=False,
                          sm_scale=1.0, mask_is_bool=True):
    """Flash attention over one KV block, returning the unnormalised fp32
    partials (acc (BH, N, D), m (BH, N, 1), l (BH, N, 1)) that the ring's
    online-softmax merge takes: q (BH, N, D) int8 or e4m3 with q_scale (BH,
    N) (carrying sm_scale; ``quantized``) or float, k (BH, KN, D) likewise
    with k_scale (BH, KN), v (BH, KN, D) bf16, or int8 with v_scale (BH,
    KN) (``quantized_pv``); ``mask`` (1 or BH, N, KN), bool (nonzero
    keeps a key) or, with ``mask_is_bool`` False, added to the scores.

    The JAX route: where ``block_kernel_route`` holds, B9 (a CUDA tensor)
    or its plain version (a CPU tensor); elsewhere ``attention_block_xla``
    on both devices.  On the card B9 takes bf16, int8 or e4m3 q / k, D 128
    or 256 (the route's D % 128 = 0 up to the kernels' 256), a bool, int8
    or float mask.  ``flash_attention_block.launches`` counts B9's
    launches (``.mode_launches`` its e4m3 Q·K and token-mode ones),
    ``attention_block_xla.calls`` the XLA route's calls."""
    bh, n, d = q.shape
    kn = k.shape[1]
    args = (q, k, v, q_scale, k_scale, v_scale, mask)
    kw = dict(quantized=quantized, quantized_pv=quantized_pv,
              sm_scale=float(sm_scale), mask_is_bool=mask_is_bool)
    if not block_kernel_route(n, kn, d):
        attention_block_xla.calls += 1
        return attention_block_xla(*args, **kw)
    if not is_cuda(q):
        return flash_attention_block_plain(*args, **kw)
    v_want = torch.int8 if quantized_pv else torch.bfloat16
    if (q.dtype not in _QK_KINDS or k.dtype != q.dtype
            or quantized != (q.dtype != torch.bfloat16)
            or v.dtype != v_want):
        raise ValueError(f"flash_attention_block takes bf16 q/k, or int8 or "
                         f"e4m3 with scales, and {v_want} v; got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _BLOCK_HEAD_DIMS or v.shape[-1] != d:
        raise NotImplementedError(
            f"head dim {d}: B9 takes {_BLOCK_HEAD_DIMS} (above 256 the "
            "JAX kernel's block mode has no counterpart here)")
    if k.shape[0] != bh or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    q, k, v = (_build.tma_rows(t.contiguous()) for t in (q, k, v))
    qs = q_scale.reshape(bh, n).float().contiguous() if quantized else None
    ks = k_scale.reshape(bh, kn).float().contiguous() if quantized else None
    vs = (v_scale.reshape(bh, kn).float().contiguous() if quantized_pv
          else None)
    mask_heads, strides, mkind = bh, (0, 0, 0), 0
    if mask is not None:
        if (mask.dim() != 3 or bh % mask.shape[0]
                or tuple(mask.shape[1:]) != (n, kn)):
            raise ValueError(f"mask {tuple(mask.shape)} for ({bh}, {n}, "
                             f"{kn})")
        if mask_is_bool:
            if mask.dtype not in _MASK_BYTES:
                raise ValueError(f"a bool mask is bool or int8, not "
                                 f"{mask.dtype}")
            mkind = _MASK_KINDS[torch.bool]
        else:
            if mask.dtype not in _MASK_KINDS or mask.dtype == torch.bool:
                mask = mask.float()
            mkind = _MASK_KINDS[mask.dtype]
        mask_heads, strides = mask.shape[0], tuple(mask.stride())
    acc = torch.empty((bh, n, d), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, n, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, n, 1), dtype=torch.float32, device=q.device)
    vt = _vt_scratch(v, vs is not None)
    if n:
        fn = _build.function(_library(q, d), "sdnq_flash_attn_block",
                             [P] * 7 + [_L] * 3 + [P] * 4 + [I] * 8
                             + [ctypes.c_float, P])
        _build.check(fn(*(_build.ptr(t) for t in (q, k, v, qs, ks, vs, mask)),
                        *strides, *(_build.ptr(t) for t in (acc, m, l, vt)),
                        bh, n, kn, d, mask_heads,
                        attn_p_block(kn) if quantized_pv else 0,
                        _QK_KINDS[q.dtype], mkind, float(sm_scale),
                        _build.stream(q)), "flash_attention_block")
        flash_attention_block.launches += 1
        modes = flash_attention_block.mode_launches
        modes["e4m3_qk"] += q.dtype == torch.float8_e4m3fn
        modes["int8_pv"] += quantized_pv
        modes["d256"] += d == 256
    return acc, m, l


flash_attention_block.launches = 0
flash_attention_block.mode_launches = dict(e4m3_qk=0, int8_pv=0, d256=0)


def attention_xla(q, k, v, q_scale=None, k_scale=None, v_scale=None,
                  mask=None, *, heads, causal=False, sm_scale=1.0,
                  out_dtype=torch.bfloat16):
    """The JAX package's ``_attn_xla`` in torch, with grouped KV heads read
    in place (not repeated): q (B·H, N, D) float or int8 with q_scale (B·H,
    N) carrying sm_scale; k, v (B·KH, KN, D), int8 k with k_scale; int8 v
    with v_scale runs P·V quantized over the whole row; a float mask is
    added to the scores.  Natural-base softmax in fp32.  The products run
    in float64, exact for the int8 codes whatever the card's TF32 setting,
    and are rounded to fp32."""
    bh, n, d = q.shape
    bkh, kn = k.shape[:2]
    qpk, b = bh // bkh, bh // heads
    qg = q.reshape(bkh, qpk * n, d)          # a KV head's query heads, rows
    s = (qg.double() @ k.double().transpose(1, 2)).float()
    s = s.reshape(bh, n, kn)
    if q_scale is not None:
        s = s * q_scale.reshape(bh, n)[..., None] \
            * _expand_kv(k_scale.reshape(bkh, kn), qpk)[:, None, :]
    else:
        s = s * sm_scale
    s = _mask_scores(s, b, heads, mask, causal)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p_eff = p * _expand_kv(v_scale.reshape(bkh, kn).float(), qpk)[:, None]
        p_scale = _div(p_eff.amax(-1, keepdim=True).clamp_min(1e-20), 127.0)
        p = torch.round(p_eff / p_scale)
    pg = p.reshape(bkh, qpk * n, kn)
    out = (pg.double() @ v.double()).float().reshape(bh, n, -1)
    if v_scale is not None:
        out = out * p_scale
    return out.to(out_dtype)


attention_xla.calls = 0
attention_xla.head_calls = 0


def quantized_attention(query, key, value, attn_mask=None,
                        is_causal: bool = False, scale: float | None = None,
                        *, smooth_k: bool = False, use_hadamard: bool = False,
                        hadamard_group_size: int = 256,
                        matmul_dtype: str | None = "default",
                        pv_matmul_dtype: str | None = None,
                        pv_scale_mode: str = "head", out_dtype=None,
                        kv_scales: tuple | None = None,
                        force_xla: bool = False):
    """Scaled-dot-product attention over query (B, H, N, D) and key / value
    (B, KH, KN, D), H a multiple of KH.  ``matmul_dtype`` in {"int8",
    "fp8", "auto", None}; "default" reads SDNQ_TPU_ATTN_MATMUL_DTYPE (int8 when
    unset), as the JAX package does.  ``attn_mask`` bool (False masks a
    key) or float (added to the scores, in its own dtype on the kernel
    route), broadcastable to (B, H, N, KN).  ``kv_scales=(k_scale,
    v_scale)`` marks key (and value, unless v_scale is None) as
    pre-quantized int8 with per-token scales
    (B, KH, KN); int8 value runs P·V in token mode, as does
    ``pv_matmul_dtype="int8"`` with ``pv_scale_mode="token"``; with
    ``pv_scale_mode="head"`` (the default) it runs in head mode.
    ``matmul_dtype`` "fp8" or "float8_e4m3fn" quantizes q and k to e4m3.
    The XLA route's calls count in ``attention_xla.calls`` (head mode's
    in ``attention_xla.head_calls``).  ``force_xla`` takes the XLA route whatever the shape (the JAX
    package's ``SDNQ_TPU_ATTN_FORCE_XLA``)."""
    b, h, n, d = query.shape
    _, kh, kn, _ = key.shape
    if out_dtype is None:
        out_dtype = query.dtype
    if scale is None:
        scale = d ** -0.5
    kv_prequant = kv_scales is not None
    if matmul_dtype == "default":
        from ..envconfig import env_str
        matmul_dtype = env_str("SDNQ_TPU_ATTN_MATMUL_DTYPE", "int8")
    if matmul_dtype == "auto":
        matmul_dtype = attn_auto_matmul_dtype(n, kn, d)
    if matmul_dtype in ("enabled", "uint8"):
        matmul_dtype = "int8"
    if kv_prequant:
        matmul_dtype = "int8"
        smooth_k = use_hadamard = False
    do_quant = matmul_dtype not in (None, "none", "no", "disabled")
    do_quant_pv = (kv_prequant and kv_scales[1] is not None) or \
        pv_matmul_dtype not in (None, "auto", "none", "no", "disabled")
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} KV heads")
    use_fp8 = matmul_dtype in _FP8
    pv_head = do_quant_pv and not kv_prequant and pv_scale_mode == "head"

    qf = query.float()
    kf = key if kv_prequant else key.float()
    vf = value
    if smooth_k:
        kf = kf - kf.mean(dim=2, keepdim=True)
    if use_hadamard and do_quant:
        hsize = next_power_of_2(min(d, hadamard_group_size))
        use_h, hsize = get_hadamard_group_size(next_power_of_2(d), hsize)
        if use_h and d % hsize == 0:
            qf = rotate_hadamard(qf, hsize)
            kf = rotate_hadamard(kf, hsize)

    qf = qf.reshape(b * h, n, d)
    kf = kf.reshape(b * kh, kn, d)
    vf = vf.reshape(b * kh, kn, -1)
    mask = attn_mask
    if mask is not None:
        while mask.dim() < 4:
            mask = mask[None]

    q_scale = k_scale = v_scale = vs_head = None
    if do_quant:
        quant = quantize_fp_mm if use_fp8 else quantize_int_mm
        q_in, q_s = quant(qf, -1)
        q_scale = q_s.reshape(b * h, n) * scale
        if kv_prequant:
            k_in, k_scale = kf, kv_scales[0].reshape(b * kh, kn).float()
        else:
            k_in, k_s = quant(kf, -1)
            k_scale = k_s.reshape(b * kh, kn)
    else:
        q_in, k_in = qf, kf
    if pv_head:
        # one V scale per (batch, KV head): the JAX constant-p-scale path
        vf = vf.float()
        vs_head = _div(vf.abs().amax(dim=(1, 2), keepdim=True)
                       .clamp_min(1e-20), 127.0)
        v_in = torch.round(vf / vs_head).to(torch.int8)
    elif do_quant_pv:
        if kv_prequant:
            v_in, v_scale = vf, kv_scales[1].reshape(b * kh, kn).float()
        else:
            v_in, v_s = quantize_int_mm(vf, -1)
            v_scale = v_s.reshape(b * kh, kn)
    else:
        v_in = vf

    if force_xla or not attn_kernel_route(n, kn, d):
        if pv_head:
            # the JAX XLA route: token-mode P over the whole row, V scales 1
            v_scale = torch.ones((b * kh, kn), device=vf.device)
        attention_xla.calls += 1
        attention_xla.head_calls += pv_head
        out = attention_xla(q_in, k_in, v_in, q_scale, k_scale, v_scale,
                            mask, heads=h, causal=is_causal, sm_scale=scale,
                            out_dtype=out_dtype)
        if pv_head:
            out = _times_head_scale(out, vs_head, h // kh)
        return out.reshape(b, h, n, -1)

    # bf16 operands on both devices, as the JAX kernel path casts them
    if not do_quant_pv:
        v_in = v_in.to(torch.bfloat16)
    kw = dict(heads=h, mask=mask, causal=is_causal, v_scale=v_scale,
              p_block=attn_p_block(kn) if do_quant_pv else None,
              v_head_scale=vs_head)
    if do_quant:
        out = flash_attention(q_in, k_in, v_in, q_scale * LOG2E, k_scale,
                              out_dtype, **kw)
    else:
        q_in = (qf * (scale * LOG2E)).to(torch.bfloat16)
        out = flash_attention(q_in, kf.to(torch.bfloat16), v_in,
                              out_dtype=out_dtype,
                              **kw)
    return out.reshape(b, h, n, -1)


class _TrainableAttention(torch.autograd.Function):
    """Forward: ``quantized_attention``; backward: the gradient of its XLA
    route, recomputed from the saved q, k, v."""

    @staticmethod
    def forward(ctx, query, key, value, kw):
        ctx.save_for_backward(query, key, value)
        ctx.kw = kw
        return quantized_attention(query, key, value, **kw)

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = quantized_attention(*saved, force_xla=True, **ctx.kw)
            grads = torch.autograd.grad(out, saved, g)
        return (*grads, None)


def trainable_attention(query, key, value, **kw):
    """``quantized_attention(query, key, value, **kw)`` (no mask, no
    pre-quantized KV) whose gradient is that of the JAX package's XLA
    route."""
    return _TrainableAttention.apply(query, key, value, kw)
