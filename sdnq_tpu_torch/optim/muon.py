"""Muon optimizer with Newton-Schulz orthogonalization.

The JAX package's ``optim.muon`` over torch tensors, on the port's
``make_optimizer``: momentum (nesterov optional), then an approximate
orthogonalization of each matrix update by Newton-Schulz (NS) iterations,
scaled by 0.2·√max(n, m); the classic 5-step schedule or Gram-NS (the
iterations on the n x n Gram matrix, with reset steps), adaptive mode
(the momentum's sign before NS, an rsqrt second-moment buffer after), and
an AdamW-style update for vectors and small leaves (``ndim <= 1`` or a
side under 16), scaled by ``adamw_lr / lr``.

With ``use_quantized_matmul=True`` every product inside NS is a dynamic
int8 GEMM: both operands quantized per row (``quant.core.quantize_int_mm``,
the second one transposed to (N, K)), then B4's nt GEMM
(``kernels.scaled_mm.scaled_mm``, looked up at each call), as the JAX
package's ``_make_mm`` runs ``_mm_kernel``.  The int8 GEMM's sum is exact
at any side: B4 adds the int32 sums of a contraction's parts of fewer than
2^17 rows in int64.

A stacked leaf (L, O, I) is orthogonalized as one (L, O·I) matrix, and a
stacked (L, O) bias with L, O >= 16 counts as a matrix, as in the JAX
package (ROADMAP "Known defects"); block lists take the per-layer path.
"""

from __future__ import annotations

import torch

from ..kernels import scaled_mm as _sm
from ..quant.core import quantize_int_mm
from .base import OptConfig, update_buffer_lerp, zero_buffer
from .optimizers import make_optimizer

__all__ = ["muon", "zeropower_via_newtonschulz5", "NS_COEFFICIENTS",
           "GRAM_NS_RESETS", "GRAM_NS_COEFFICIENTS"]

# Classic 5-step NS schedule (the same triple each step).
NS_COEFFICIENTS = ((3.4445, -4.7750, 2.0315),) * 5

# The tuned Gram-NS schedule and its reset steps (numerical constants of
# the public Dao-AILab/gram-newton-schulz repository, as the JAX package
# carries them).
GRAM_NS_RESETS = (2,)
GRAM_NS_COEFFICIENTS = (
    (7.892582874424408, -20.38301394587957, 13.555306149406924),
    (3.911484868135431, -2.5464635929060884, 0.4268988319673074),
    (3.760657955697423, -2.512819018216563, 0.4323647349070073),
    (3.160399673686287, -2.149649518898498, 0.3996366907664389),
    (2.1910971618617303, -1.441662010214663, 0.328146487623155),
)

def _make_mm(use_quantized: bool, dtype):
    """``mm(a, b)`` -> a @ b in the NS working dtype.  Plain: the operands
    rounded to ``dtype``, fp32 sums.  Quantized: a per row and bᵀ per row
    to int8 codes, then B4's nt GEMM with the scales in its epilogue,
    fp32 out."""
    if not use_quantized:
        def mm(a, b):
            return (a.to(dtype).float() @ b.to(dtype).float()).to(dtype)
        return mm

    def mm(a, b):
        a_q, a_s = quantize_int_mm(a, -1)
        b_q, b_s = quantize_int_mm(b.T.contiguous(), -1)
        return _sm.scaled_mm(a_q, b_q, a_s, b_s, None,
                             out_dtype=torch.float32).to(dtype)
    return mm


def zeropower_via_newtonschulz5(
    g: torch.Tensor,
    steps: int | None = None,
    *,
    ns_coefficients=NS_COEFFICIENTS,
    clip: float = 1.0,
    use_gram_ns: bool = False,
    gram_ns_resets=GRAM_NS_RESETS,
    gram_ns_coefficients=GRAM_NS_COEFFICIENTS,
    use_quantized_matmul: bool = False,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Approximate orthogonalization: about U Vᵀ of the SVD of g (2-D),
    fp32 out.  A tall g is worked on transposed."""
    if steps is not None and len(ns_coefficients) != steps:
        ns_coefficients = (tuple(ns_coefficients)
                           * -(-steps // len(ns_coefficients)))[:steps]
    x = g.float()
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / torch.clamp_min(torch.linalg.norm(x), 1e-7)
    x = torch.clamp(torch.nan_to_num(x), -clip, clip).to(dtype)
    mm = _make_mm(use_quantized_matmul, dtype)

    if use_gram_ns and x.shape[0] != x.shape[1]:
        # Q = p(R) accumulated on the Gram matrix R of the transformed X;
        # the final X = Q X applies every step at once.  A reset step
        # applies Q, recomputes R and restarts Q.
        r = mm(x, x.T)
        eye = torch.eye(r.shape[0], dtype=dtype, device=x.device)
        q = None
        n_steps = len(gram_ns_coefficients)
        for i, (a, b, c) in enumerate(gram_ns_coefficients):
            if q is not None and i in gram_ns_resets:
                x = mm(q, x)
                r = mm(x, x.T)
                q = None
            z = (b * r + c * mm(r, r)).to(dtype)
            if q is None:
                q = (z + a * eye).to(dtype)
            else:
                q = (a * q + mm(q, z)).to(dtype)
            if i < n_steps - 1 and (i + 1) not in gram_ns_resets:
                rz = (a * r + mm(r, z)).to(dtype)
                r = (a * rz + mm(z, rz)).to(dtype)
        x = mm(q, x)
    else:
        for a, b, c in ns_coefficients:
            gram = mm(x, x.T)
            b_mat = (b * gram + c * mm(gram, gram)).to(dtype)
            x = (a * x + mm(b_mat, x)).to(dtype)

    x = x.float()
    return x.T if transposed else x


def _is_muon_shape(shape) -> bool:
    """Whether a leaf of ``shape`` takes the NS update (else AdamW's)."""
    return len(shape) >= 2 and min(shape[-2:]) >= 16


def muon(lr=2e-2, momentum=0.95, nesterov=True, ns_steps=5,
         adamw_lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
         adaptive=False, clip=1.0,
         ns_coefficients=NS_COEFFICIENTS,
         use_gram_ns=False, gram_ns_resets=GRAM_NS_RESETS,
         gram_ns_coefficients=GRAM_NS_COEFFICIENTS,
         use_quantized_matmul_ns=False, **kw):
    kw.setdefault("use_kahan", True)
    cfg = OptConfig(lr=lr, weight_decay=weight_decay, eps=eps, **kw)

    def init_param(shape, device, cfg):
        if _is_muon_shape(shape):
            st = {"muon": True}
            if cfg.quantize_state:
                st["m"] = zero_buffer(shape, device)
                if adaptive:
                    st["v"] = zero_buffer(shape, device, unsigned=True)
            else:
                st["m"] = torch.zeros(shape, dtype=torch.float32,
                                      device=device)
                if adaptive:
                    st["v"] = torch.zeros(shape, dtype=torch.float32,
                                          device=device)
            return st
        return {"m": torch.zeros(shape, dtype=torch.float32, device=device),
                "v": torch.zeros(shape, dtype=torch.float32, device=device),
                "muon": False}

    def update_param(g, st, v, cfg, t, gen):
        if st["muon"]:
            st["m"], m = update_buffer_lerp(st["m"], g, momentum, gen)
            u = g + momentum * m if nesterov else m
            if adaptive:
                u = torch.sign(u)   # sign before NS, the v rescale after
            shape = u.shape
            u2 = u.reshape(shape[0], -1) if u.dim() > 2 else u
            o = zeropower_via_newtonschulz5(
                u2, ns_steps, ns_coefficients=ns_coefficients, clip=clip,
                use_gram_ns=use_gram_ns, gram_ns_resets=gram_ns_resets,
                gram_ns_coefficients=gram_ns_coefficients,
                use_quantized_matmul=use_quantized_matmul_ns)
            o = o.reshape(shape)
            if adaptive:
                st["v"], vv = update_buffer_lerp(st["v"], o.square(), b2,
                                                 gen)
                v_hat = vv / (1 - b2 ** t)
                o = o * torch.rsqrt(v_hat + eps)
                o = torch.clamp(torch.nan_to_num(o), -clip, clip)
            # 0.2 * sqrt(max(n, m)) (Keller Jordan's scale)
            return o * (0.2 * (max(u2.shape) ** 0.5))
        # the AdamW branch, scaled to the adamw_lr ratio
        st["m"] = mm_ = b1 * st["m"] + (1 - b1) * g
        st["v"] = vv = b2 * st["v"] + (1 - b2) * g.square()
        m_hat = mm_ / (1 - b1 ** t)
        v_hat = vv / (1 - b2 ** t)
        return (adamw_lr / lr) * m_hat / (torch.sqrt(v_hat) + eps)

    return make_optimizer(init_param, update_param, cfg)
