"""Quantized scaled-dot-product attention.

Kernel ``flash_attention`` (B3, ``csrc/flash_attn.cu``) beside its plain
version and a launch counter.  It replaces ``sdnq_tpu/kernels/attention.py``
``_attn_kernel`` in two modes: bf16 Q·Kᵀ with sm_scale·log2(e) folded into
q, and int8 Q·Kᵀ with per-token scales (qs carrying sm_scale·log2(e)); P·V
in bf16 in both, softmax in base 2.  At FLUX's shape (24 heads, 4608
tokens, head dim 128) it is bound by tensor-core operations; the kernel
keeps the score matrix on chip (online softmax over 64-key tiles).

The plain version mirrors the JAX package's KERNEL path (attention.py
:597-631: pre-folded scale, exp2, P rounded to V's dtype before P·V), with
one full softmax instead of the online one.  It does not mirror the JAX XLA
fallback (fp32 q/k with ``exp``), which agrees with it to fp32 rounding
when the operands are fp32.

Operand dtype: the kernel takes bf16 (and int8 Q/K), as the JAX kernel
path casts to bf16; on the CPU fp32 inputs stay fp32.  Masks, causal
attention, grouped KV heads, int8 P·V and fp8 Q·K are later slices: they
raise here on both devices.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._build import P, I
from .dispatch import is_cuda
from ..quant.core import quantize_int_mm
from ..quant.hadamard import (
    get_hadamard_group_size, next_power_of_2, rotate_hadamard,
)

__all__ = ["flash_attention", "flash_attention_plain", "quantized_attention",
           "quantize_kv", "attn_auto_matmul_dtype"]

LOG2E = math.log2(math.e)
_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)


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


def flash_attention_plain(q, k, v, q_scale=None, k_scale=None,
                          out_dtype=torch.bfloat16):
    """Plain version of ``flash_attention``: q, k (BH, N|KN, D) float
    (pre-scaled q) or int8 with q_scale (BH, N) / k_scale (BH, KN); v (BH,
    KN, D).  Base-2 softmax; P is rounded to v's dtype before P·V."""
    if q_scale is not None:
        s = (q.double() @ k.double().transpose(1, 2)).float()  # exact int
        s = s * q_scale[..., None] * k_scale[:, None, :]
    else:
        s = q.float() @ k.float().transpose(1, 2)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()
    return (acc / l.clamp_min(1e-30)).to(out_dtype)


def flash_attention(q, k, v, q_scale=None, k_scale=None,
                    out_dtype=torch.bfloat16):
    """Flash attention over (BH, N, D) operands; see ``flash_attention_plain``
    for the function.  On the card: q, k bf16 (or int8 with scales), v
    bf16, D in {64, 128}."""
    if not is_cuda(q):
        return flash_attention_plain(q, k, v, q_scale, k_scale, out_dtype)
    bh, n, d = q.shape
    kn = k.shape[1]
    quant = q_scale is not None
    want = torch.int8 if quant else torch.bfloat16
    if q.dtype != want or k.dtype != want or v.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention takes {want} q/k and bf16 v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS or v.shape[-1] != d:
        raise NotImplementedError(
            f"head dim {d}: the kernel takes {_HEAD_DIMS} (others are a "
            "later slice of the port)")
    if k.shape[0] != bh or v.shape[:2] != k.shape[:2] or kn < 1:
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qs = q_scale.reshape(bh, n).float().contiguous() if quant else None
    ks = k_scale.reshape(bh, kn).float().contiguous() if quant else None
    out = torch.empty((bh, n, d), dtype=out_dtype, device=q.device)
    if n:
        fn = _build.function("flash_attn", "sdnq_flash_attn",
                             [P, P, P, P, P, P, I, I, I, I, I, I, P])
        _build.check(fn(*(_build.ptr(t) for t in (q, k, v, qs, ks, out)),
                        bh, n, kn, d, int(quant), _build.act_kind(out_dtype),
                        _build.stream(q)), "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def quantized_attention(query, key, value, attn_mask=None,
                        is_causal: bool = False, scale: float | None = None,
                        *, smooth_k: bool = False, use_hadamard: bool = False,
                        hadamard_group_size: int = 256,
                        matmul_dtype: str | None = "default",
                        pv_matmul_dtype: str | None = None, out_dtype=None,
                        kv_scales: tuple | None = None):
    """Scaled-dot-product attention over (B, H, N, D) with optional int8
    Q·Kᵀ.  ``matmul_dtype`` in {"int8", "auto", None}; "default" reads
    SDNQ_TPU_ATTN_MATMUL_DTYPE (int8 when unset), as the JAX package does.
    ``kv_scales=(k_scale, None)`` marks key as pre-quantized int8."""
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
    missing = [what for what, on in (
        ("attention masks", attn_mask is not None), ("causal", is_causal),
        ("grouped KV heads", kh != h), ("int8 P·V", do_quant_pv),
        (f"{matmul_dtype} Q·K", do_quant and matmul_dtype != "int8"))
        if on]
    if missing:
        raise NotImplementedError(
            ", ".join(missing)
            + ": later slices of the port (ROADMAP queue A item 7)")

    qf = query.float()
    kf = key if kv_prequant else key.float()
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
    # the kernel's operand type; fp32 stays fp32 on the CPU
    kdt = (torch.float32 if query.dtype == torch.float32 and not is_cuda(query)
           else torch.bfloat16)
    v_in = value.reshape(b * kh, kn, -1).to(kdt)
    if do_quant:
        q_q, q_s = quantize_int_mm(qf, -1)
        q_scale = (q_s.reshape(b * h, n) * scale) * LOG2E
        if kv_prequant:
            k_q, k_scale = kf, kv_scales[0].reshape(b * kh, kn).float()
        else:
            k_q, k_s = quantize_int_mm(kf, -1)
            k_scale = k_s.reshape(b * kh, kn)
        out = flash_attention(q_q, k_q, v_in, q_scale, k_scale, out_dtype)
    else:
        q_in = (qf * (scale * LOG2E)).to(kdt)
        out = flash_attention(q_in, kf.to(kdt), v_in, out_dtype=out_dtype)
    return out.reshape(b, h, n, -1)
