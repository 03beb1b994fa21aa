"""Tensor parallelism for the DiT: each sharded linear issues its own
collectives.

JAX's GSPMD moves shards implicitly; the port's kernels take raw
pointers, not DTensors, so each layer that ``shard_params`` split says
what it holds (``Sharded``: its mode and placement) and ``TPLinear`` runs
it over the tensor axis (``_collectives.AxisComm``):

* column parallel (``qkv``, ``fc1``, ``linear1``, ``img_mod`` /
  ``txt_mod``): Megatron's f on the input (its gradient summed over the
  ranks), the rank's rows of the weight and bias; the modulations' outputs
  are gathered (and put back in the layer's segment order), the others
  stay local: whole heads, and the MLP slice that the next layer's input
  columns follow;
* row parallel (``proj``, ``fc2``, ``linear2``): the rank's input columns
  times its columns of the weight, an fp32 partial sum, summed over the
  ranks (Megatron's g), then the bias, once.  Where the quantized matmul
  quantizes the input rows (B1), their absolute maximum (uint8: their
  minimum and maximum) is all-reduced first and B1 quantizes against the
  given statistics, so the codes are the unsharded layer's bit for bit; a
  weight re-quantized for the matmul takes its rows' statistics so too;
* a row-parallel layer that the axis does not divide (its groups along the
  input would straddle a shard) is replicated: it gathers its input and
  runs whole;
* "fsdp": the layer's codes gathered, then the whole layer; in training
  the gather is an autograd node whose backward keeps this rank's slice
  of the whole gradient (every fsdp rank holds the same batch, so each
  computes the whole gradient).

``local_tree`` turns a sharded tree into one of local leaves with a
``"tp"`` entry beside each sharded layer's weight, which ``models.dit``'s
``_lin`` hands the call to; the q / k norms' weights on sharded heads take
f too (their gradient is summed over the heads' ranks).  ``local_tp``
runs the forward over T virtual ranks (threads) of one device, the same
code and collectives as T processes, so it equals the distributed forward
bit for bit.
"""

from __future__ import annotations

import functools
import types

import torch

from ..formats import torch_dtype
from ..layers import qlinear
from ..tensor import QTensor, layer_count
from ..train.matmul import (
    TrainQTensor, grad_carrier, grad_input_stats, keep_for_backward,
    train_backward, train_forward, train_qlinear,
)
from ._collectives import VirtualComm, ordered_sum
from .sharding import (
    DIT_TP_RULES, Sharded, gather_leaf, shard_params, take,
)

__all__ = ["TPLinear", "local_tree", "local_tp", "untake"]


def untake(full: torch.Tensor, segments, n: int, dim: int = -1):
    """A gather of ``n`` ranks' ``take`` shards (each its part of every
    segment, in rank order) back in segment order."""
    if not segments or n == 1:
        return full
    dim = dim % full.dim()
    chunk = full.shape[dim] // n
    pieces = []
    start = 0
    for s in segments:
        k = s // n
        pieces += [full.narrow(dim, r * chunk + start, k) for r in range(n)]
        start += k
    return torch.cat(pieces, dim=dim)


def _linear(x, w, b, out_dtype, x_amax_reduce=None):
    if isinstance(w, TrainQTensor):
        return train_qlinear(x, w, b, out_dtype=out_dtype or torch.bfloat16,
                             x_amax_reduce=x_amax_reduce)
    return qlinear(x, w, b, out_dtype=out_dtype,
                   x_amax_reduce=x_amax_reduce)


def _out_dtype(w, x):
    if isinstance(w, TrainQTensor):
        return torch.bfloat16
    if isinstance(w, QTensor):
        return torch_dtype(w.meta.dequant_dtype)
    return x.dtype


class TPLinear:
    """How one sharded linear runs: ``mode`` "col", "row", "row_rep" (a
    row rule the axis does not divide) or "col_rep"; ``comm`` the axis's
    collectives, ``segments`` the layer's layout."""

    def __init__(self, mode, comm, segments=()):
        self.mode, self.comm, self.segments = mode, comm, tuple(segments)

    @property
    def size(self) -> int:
        """The ranks the layer's output rows are split over (1 unless
        column parallel)."""
        return self.comm.size if self.mode == "col" else 1

    def __call__(self, p, x, out_dtype=None, gather=False):
        w, b, c = p["weight"], p.get("bias"), self.comm
        n, segs = c.size, self.segments
        if self.mode == "col":
            if isinstance(w, TrainQTensor) and torch.is_grad_enabled():
                y = _col_train(c, x, w, b)
            else:
                y = _linear(c.copy(x), w, b, out_dtype)
            return untake(c.gather(y, -1), segs, n) if gather else y
        if self.mode == "col_rep":
            y = _linear(x, w, b, out_dtype)
            if gather:
                return y
            raise ValueError(
                "a column-parallel layer whose rows do not divide over the "
                f"tensor axis ({tuple(y.shape)} over {n}) cannot feed its "
                "sharded consumer")
        if self.mode == "row":
            y = c.sum(_linear(x, w, None, torch.float32,
                              c.amax if n > 1 else None))
            if b is not None:
                y = y + b.float()
            return y.to(out_dtype or _out_dtype(w, x))
        if self.mode == "row_rep":
            return _linear(untake(c.gather(x, -1), segs, n), w, b,
                           out_dtype)
        raise ValueError(f"tensor-parallel mode {self.mode!r}")


# ---------------------------------------------------------------------------
# A column-parallel trainable linear: its grad-input quantized by the
# unsharded layer's statistics
# ---------------------------------------------------------------------------
#
# The grad-input g·W of a column-parallel shard contracts over its own
# output rows: a partial sum, summed over the ranks (f's backward).  Its
# dynamic quantization (g's rows, W's columns) must take the statistics
# over all the rows, as the unsharded layer's does, so they are
# all-reduced (max) before the GEMM.  On a process group the backward
# issues the collectives itself; the virtual ranks of one process run one
# backward over the joined graph, so their layers' shards are one node.


class _ColTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, delta, bias, comm, qt, use_quantized_matmul):
        y, saved, emitted = train_forward(x2d, bias, qt, False,
                                          use_quantized_matmul)
        keep_for_backward(ctx, x2d, bias, qt, saved, emitted, False)
        ctx.comm = comm
        return y

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        stats = grad_input_stats(g.reshape(-1, g.shape[-1]), ctx.qt)
        if stats is not None:
            stats = tuple(None if v is None else c.amax(v) for v in stats)
        gx, gw, gb = train_backward(ctx, g, ctx.needs_input_grad[:3], stats,
                                    partial=True)
        if gx is not None:
            gx = ordered_sum(c._gather_list(gx)).to(ctx.x_dtype)
        return gx, gw, gb, None, None, None


class _ColTrainJoint(torch.autograd.Function):
    """Every virtual rank's shard of one column-parallel layer."""

    @staticmethod
    def forward(ctx, qts, *flat):
        ctx.ranks, ys = [], []
        for r, qt in enumerate(qts):
            x2d, _, bias = flat[3 * r:3 * r + 3]
            y, saved, emitted = train_forward(
                x2d, bias, qt, False, qt.meta.use_quantized_matmul)
            ctx.ranks.append(types.SimpleNamespace(
                saved_tensors=saved, qt=qt, emitted=emitted,
                save_q_acts=False, x_dtype=x2d.dtype,
                bias_dtype=None if bias is None else bias.dtype))
            ys.append(y)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        needs = ctx.needs_input_grad[1:]
        per = [grad_input_stats(g.reshape(-1, g.shape[-1]), k.qt)
               for g, k in zip(gs, ctx.ranks)]
        stats = None
        if per[0] is not None:
            stats = tuple(None if per[0][i] is None else
                          functools.reduce(torch.maximum,
                                           [p[i] for p in per])
                          for i in range(len(per[0])))
        out, gxs = [], []
        for r, (g, k) in enumerate(zip(gs, ctx.ranks)):
            gx, gw, gb = train_backward(k, g, needs[3 * r:3 * r + 3], stats,
                                        partial=True)
            gxs.append(gx)
            out += [gx, gw, gb]
        if gxs[0] is not None:
            total = ordered_sum(gxs).to(ctx.ranks[0].x_dtype)
            for r in range(len(gxs)):
                out[3 * r] = total
        return (None,) + tuple(out)


def _col_train(c, x, w: TrainQTensor, b):
    """A column-parallel TrainQTensor shard's forward, with its exact
    backward (f included)."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if isinstance(c, VirtualComm):
        def joint(items):
            flat = [t for it in items for t in it[:3]]
            return _ColTrainJoint.apply([it[3] for it in items], *flat)
        y = c.hub.exchange(c.rank, (x2d, w.delta, b, w.qt), joint)
    else:
        y = _ColTrain.apply(x2d, w.delta, b, c, w.qt,
                            w.qt.meta.use_quantized_matmul)
    return y.reshape(*lead, y.shape[-1])


class _FsdpGather(torch.autograd.Function):
    """The whole of a trainable fsdp leaf: forward, ``whole`` (gathered
    by the caller) as a new tensor, or a TrainQTensor's gradient carrier
    of the whole shape; backward, this rank's slice of the whole gradient
    (``take`` along the leaf's gradient placement)."""

    @staticmethod
    def forward(ctx, local, whole, pl, rank):
        ctx.pl, ctx.rank = pl, rank
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, g):
        return take(g, ctx.pl, ctx.rank), None, None, None


def _fsdp_leaf(s: Sharded):
    """An fsdp leaf as the layer reads it: the whole leaf, gathered; where
    it trains, through ``_FsdpGather``, so that its local shard (a
    tensor, or a TrainQTensor's carrier) receives its slice of the
    gradient."""
    from .dryrun import _grad_placement
    whole, x = gather_leaf(s), s.local
    if isinstance(x, TrainQTensor):
        pl = _grad_placement(s)
        rank = s.mesh.get_local_rank(pl.axis) if pl.axis else 0
        delta = grad_carrier(whole.meta.original_shape if layer_count(whole)
                             is None else (whole.qdata.shape[0],)
                             + tuple(whole.meta.original_shape),
                             x.delta.device).detach()
        return TrainQTensor(qt=whole, delta=_FsdpGather.apply(
            x.delta, delta, pl, rank))
    if isinstance(x, torch.Tensor) and x.requires_grad:
        pl = s.placement
        rank = s.mesh.get_local_rank(pl.axis) if pl.axis else 0
        return _FsdpGather.apply(x, whole, pl, rank)
    return whole


def _layer_tp(w: Sharded):
    """The TPLinear of a layer whose weight is ``w``, or None (replicated,
    no rule)."""
    pl = w.placement
    first = pl.qdata if isinstance(pl, QTensor) else pl
    if w.mode not in ("col", "row"):
        return None
    comm = w.mesh.comm(first.axis or "tensor")
    if comm.size == 1:
        return None
    if w.mode == "col":
        return TPLinear("col" if first.sharded else "col_rep", comm,
                        w.segments)
    if w.mode == "row":
        return TPLinear("row" if first.sharded else "row_rep", comm,
                        w.segments)
    return None


def local_tree(tree):
    """The local leaves of a ``shard_params`` tree, with a ``"tp"`` entry
    (a ``TPLinear``) beside each sharded layer's weight, and f on the q /
    k norms' weights beside a column-parallel ``qkv`` / ``linear1``."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_tree(v) for v in tree)
    if isinstance(tree, Sharded):
        if tree.mode != "fsdp":
            return tree.local
        return _fsdp_leaf(tree)
    if not isinstance(tree, dict):
        return tree
    out = {k: local_tree(v) for k, v in tree.items()}
    w = tree.get("weight")
    if isinstance(w, Sharded):
        tp = _layer_tp(w)
        if tp is not None:
            out["tp"] = tp
    heads = [tree.get(k) for k in ("qkv", "linear1")]
    for h in heads:
        if isinstance(h, dict) and isinstance(h.get("weight"), Sharded):
            tp = _layer_tp(h["weight"])
            if tp is not None and tp.mode == "col":
                for nk in ("norm_q", "norm_k"):
                    if nk in out:
                        out[nk] = dict(out[nk], tp=tp)
    return out


def local_tp(params, img, txt, timesteps, pooled, cfg, t_size: int,
             guidance=None, freqs=None, attn_config=None,
             rules=DIT_TP_RULES, device=None, segments=None):
    """``dit_forward`` of ``params`` sharded by ``rules`` over ``t_size``
    virtual tensor ranks (threads) of this process's device: each rank's
    shards and collectives as T processes would run them; returns rank
    0's output (every rank holds the same).  Equal bit for bit to the
    forward of T processes on the same inputs.  ``rules`` and
    ``segments`` go to ``shard_params``."""
    from ..kernels.dispatch import resolve_device
    from ..models.dit import dit_forward
    from ._collectives import run_virtual
    device = resolve_device(device)

    def rank(mesh):
        sharded = shard_params(params, mesh, rules, segments=segments)
        return dit_forward(sharded, img, txt, timesteps, pooled, cfg,
                           guidance=guidance, freqs=freqs,
                           attn_config=attn_config, device=device)
    return run_virtual(rank, {"tensor": t_size}, device.type)[0]


_local_tp = local_tp
