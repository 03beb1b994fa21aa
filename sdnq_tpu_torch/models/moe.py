"""Mixture-of-Experts FFN with quantized expert banks.

The JAX package's ``models/moe.py`` over torch tensors: top-k routing with
a fixed capacity C an expert (tokens past it drop), one-hot dispatch and
combine einsums in x's dtype, and the experts' weights as ONE QTensor a
projection, shape (E, out, in), quantization groups along ``in`` and
scales (E, out, G), as the JAX package stores them.

``qlinear_batched`` multiplies each expert's rows by its slice of a bank:

* an int8 bank with the quantized matmul: each expert's rows quantized to
  int8 (B1's row quantizer, ``quantize_rows``), then B4's int8 GEMM with
  the epilogue ``acc * x_scale * w_scale`` (``scaled_gemm``), a launch of
  each an expert (the JAX package's one batched int8 ``dot_general``);
* any other bank: dequantized to bf16, then B4's bf16 mode (``scaled_gemm``
  on bf16 operands, fp32 sums and an fp32 result), where the JAX package
  keeps fp32 (``preferred_element_type``) before the cast to the output.

The kernels are looked up in ``kernels.scaled_mm`` at each call (a
caller may route them to their plain versions there).  An int8 expert's
codes and scales are views of the bank
(``tensor.layer_view`` of the bank read as a stack of one-expert
QTensors): nothing is copied.  A weight-only bank is dequantized whole,
as the JAX package does (a packed bank's codes run across its experts'
rows).

``shard_moe`` is expert parallelism over a mesh axis (the JAX package's
``shard_moe``): each rank holds E / n experts of every bank, the router is
replicated.  ``moe_ffn`` on such a tree computes the routing, dispatch
and capacity for all tokens, runs its own experts (B1 + B4 on their
layer views), combines its experts' part of the output, and sums the
parts over the axis in rank order (``AxisComm.sum``), where JAX's GSPMD
lowers the same einsums to all-to-alls.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..formats import torch_dtype
from ..kernels.dispatch import resolve_device
from ..kernels import scaled_mm as _sm
from ..parallel.sharding import REPLICATED, Placement, Sharded, take
from ..tensor import QTensor, dequantize, layer_view, quantize_tensor
from .common import Params, linear_init

__all__ = ["MoEConfig", "MOE_TINY_CONFIG", "init_moe", "moe_ffn",
           "quantize_moe", "qlinear_batched", "top_k", "shard_moe"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The defaults are Mixtral-8x7B's expert FFN
    (``mistralai/Mixtral-8x7B-v0.1`` ``config.json``: hidden 4096,
    intermediate 14336, 8 local experts, 2 a token)."""
    hidden_size: int = 4096
    ff_dim: int = 14336
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


MOE_TINY_CONFIG = MoEConfig(hidden_size=64, ff_dim=128, num_experts=4,
                            top_k=2, capacity_factor=2.0)

_BANKS = ("gate_proj", "up_proj", "down_proj")


def init_moe(cfg: MoEConfig = MOE_TINY_CONFIG, *,
             generator: torch.Generator | None = None, device=None,
             dtype=torch.float32) -> Params:
    """Random parameters on ``device`` (the card by default) from
    ``generator`` (seeded 0 when omitted): the router (E, D) without a
    bias, and three banks of Normal(0, 1/in) weights, (E, out, in)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, f, e = cfg.hidden_size, cfg.ff_dim, cfg.num_experts

    def bank(o, c):
        w = torch.randn((e, o, c), generator=generator, device=device,
                        dtype=dtype)
        return w.mul_(c ** -0.5)

    return {
        "router": linear_init(d, e, generator=generator, device=device,
                              dtype=dtype, bias=False),
        "gate_proj": {"weight": bank(f, d)},
        "up_proj": {"weight": bank(f, d)},
        "down_proj": {"weight": bank(d, f)},
    }


def quantize_moe(params: Params, fmt: str = "int8", *,
                 use_quantized_matmul: bool = False, **kw) -> Params:
    """The expert banks quantized as (E, out, in) QTensors; the router
    stays in full precision."""
    out = dict(params)
    for name in _BANKS:
        out[name] = {"weight": quantize_tensor(
            params[name]["weight"], fmt, "linear",
            use_quantized_matmul=use_quantized_matmul, **kw)}
    return out


def _experts(w: QTensor) -> QTensor:
    """A bank (E, out, in) read as a stack of E one-expert QTensors (its
    arrays as they lie, the meta of one expert), for ``layer_view``."""
    m = w.meta
    one = dataclasses.replace(
        m, original_shape=tuple(m.original_shape[1:]),
        quantized_shape=tuple(m.quantized_shape[1:]),
        group_axis=m.group_axis - 1)
    return dataclasses.replace(w, meta=one)


def _int8_bank(w: QTensor) -> bool:
    m = w.meta
    return (m.use_quantized_matmul and not m.re_quantize_for_matmul
            and m.matmul_format.is_integer and w.qdata.dtype == torch.int8)


def qlinear_batched(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """x (E, C, D) times a bank w (E, O, D) -> (E, C, O), each expert's
    rows by its own weights.  A plain bank: bf16 operands, fp32 sums.  An
    int8 QTensor bank with the quantized matmul: int8 rows times int8
    codes, ``acc * x_scale * w_scale``.  Any other QTensor bank:
    dequantized to bf16, then bf16 operands with fp32 sums.  The result in
    ``out_dtype`` (x's dtype for a plain bank, else the bank's dequant
    dtype when None)."""
    e, c, _ = x.shape
    if not isinstance(w, QTensor):
        out_dtype = out_dtype or x.dtype
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        return torch.stack([_sm.scaled_gemm(xb[i], wb[i], torch.float32)
                            .to(out_dtype) for i in range(e)])
    out_dtype = out_dtype or torch_dtype(w.meta.dequant_dtype)
    if _int8_bank(w):
        experts, outs = _experts(w), []
        for i in range(e):
            wi = layer_view(experts, i)
            xq, xs = _sm.quantize_rows(x[i])[:2]
            outs.append(_sm.scaled_gemm(xq, wi.qdata, out_dtype, xs,
                                        wi.scale.reshape(-1)))
        return torch.stack(outs)
    # the whole bank at once, as the JAX package does: a packed bank's
    # codes run across its experts' rows
    wd = dequantize(w, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    return torch.stack([_sm.scaled_gemm(xb[i], wd[i], torch.float32)
                        .to(out_dtype) for i in range(e)])


def top_k(probs: torch.Tensor, k: int):
    """The k largest of each row, in descending order, the lower index
    first among equal values (``jax.lax.top_k``'s order): a stable
    descending sort, then its first k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig,
            out_dtype=None):
    """x (..., D) -> (y (..., D), aux): the routed experts' FFN and the
    load-balancing loss mean_e(fraction of tokens whose first choice is e
    · mean router probability of e) · E."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    t = 1
    for s in lead:
        t *= s
    xf = x.reshape(t, d)
    out_dtype = out_dtype or x.dtype
    e, k = cfg.num_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * k * t / e))

    router = params["router"]["weight"]
    if isinstance(router, Sharded):
        router = router.local
    logits = xf.float() @ router.float().T                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                        # (T, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # each (token, choice)'s place in its expert's queue, in token order
    onehot = F.one_hot(gate_idx, e).to(torch.int32)              # (T, k, E)
    flat = onehot.reshape(t * k, e)
    pos = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat    # arrival
    pos = (pos.reshape(t, k, e) * onehot).sum(-1)                # (T, k)
    keep = pos < cap

    # dispatch (T, E, C) one-hot -> expert inputs (E, C, D)
    disp = (onehot * keep[..., None]).to(xf.dtype)               # (T, k, E)
    pos_oh = F.one_hot(torch.where(keep, pos, cap).long(), cap + 1) \
        .to(xf.dtype)[..., :cap]                                 # (T, k, C)
    dispatch = torch.einsum("tke,tkc->tec", disp, pos_oh)        # (T, E, C)
    combine = torch.einsum("tec,tke,tk->tec", dispatch,
                           onehot.to(xf.dtype), gate_vals.to(xf.dtype))
    banks = [params[n]["weight"] for n in _BANKS]
    comm = None
    if isinstance(banks[0], Sharded):   # expert parallel: this rank's
        pl = banks[0].placement          # experts and their tokens
        first = pl.qdata if isinstance(pl, QTensor) else pl
        if first.sharded:
            comm = banks[0].mesh.comm(first.axis)
            n_loc = e // comm.size
            lo = comm.rank * n_loc
            dispatch = dispatch[:, lo:lo + n_loc]
            combine = combine[:, lo:lo + n_loc]
        banks = [b.local for b in banks]
    expert_in = torch.einsum("tec,td->ecd", dispatch, xf)

    g = qlinear_batched(expert_in, banks[0], torch.float32)
    u = qlinear_batched(expert_in, banks[1], torch.float32)
    h = F.silu(g) * u
    expert_out = qlinear_batched(h.to(x.dtype), banks[2], torch.float32)

    y = torch.einsum("tec,ecd->td", combine.float(), expert_out)
    if comm is not None:
        y = comm.sum(y)

    # load-balance aux (Switch eq. 4)
    frac = F.one_hot(gate_idx[:, 0], e).float().sum(0) / t
    me = probs.mean(0)
    aux = (frac * me).sum() * e
    return y.reshape(*lead, d).to(out_dtype), aux


def shard_moe(params: Params, mesh, axis: str = "tensor") -> Params:
    """Expert parallelism: every bank leaf split on its leading (expert)
    dimension over ``axis`` where the axis divides it (else replicated);
    the router replicated.  Returns this rank's tree of ``Sharded``
    leaves, which ``moe_ffn`` takes."""
    n = mesh.shape[axis]
    rank = mesh.get_local_rank(axis)

    def put0(a):
        if isinstance(a, QTensor):
            pls = {f: None if getattr(a, f) is None
                   else _bank_placement(getattr(a, f), n, axis)
                   for f in ("qdata", "scale", "zero_point", "svd_up",
                             "svd_down")}
            pq = QTensor(meta=a.meta, **pls)
            local = a
            if pq.qdata.sharded:
                m = a.meta
                k = pq.qdata.size
                local = QTensor(meta=dataclasses.replace(
                    m, original_shape=(m.original_shape[0] // k,)
                    + tuple(m.original_shape[1:]),
                    quantized_shape=(m.quantized_shape[0] // k,)
                    + tuple(m.quantized_shape[1:])), **{
                    f: None if getattr(a, f) is None
                    else take(getattr(a, f), getattr(pq, f), rank)
                    for f in pls})
            return Sharded(local, pq, mesh, "experts")
        pl = _bank_placement(a, n, axis)
        return Sharded(take(a, pl, rank), pl, mesh, "experts")

    out = {"router": {k: Sharded(v, REPLICATED, mesh)
                      for k, v in params["router"].items()}}
    for name in _BANKS:
        out[name] = {k: put0(v) for k, v in params[name].items()}
    return out


def _bank_placement(a, n, axis):
    if a.dim() >= 1 and a.shape[0] % n == 0:
        return Placement(0, axis, n)
    return REPLICATED
