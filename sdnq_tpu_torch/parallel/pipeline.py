"""Pipeline parallelism (GPipe) over layer-stacked block parameters.

The JAX package's ``pipeline_forward`` over ``torch.distributed``.  The
stacked block parameters (``stack_dit_blocks``'s layout: a leading layer
axis on every leaf, QTensors component by component) split their layer
axis over a mesh axis: stage s holds layers s·L/P .. (s+1)·L/P - 1 as
views of the stacked storage (no copy), and each of its layers as a view
of one layer, as the stacked DiT reads them.  Microbatches enter stage 0;
each tick every stage runs its layers on what it holds and hands the
result to the next stage (``dist.batch_isend_irecv``); after num_micro +
P - 1 ticks every microbatch has passed all L layers, and the last
stage's outputs are summed over the axis (JAX's ``psum``), which puts
them on every rank.  A stage skips the ticks on which it holds no
microbatch, and the hand-over of them: the outputs are those of the JAX
schedule, which computes and discards them.

The block function must keep its input's shape and dtype (x -> x), as
every single-stream transformer block does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..tensor import QTensor
from . import _collectives as C

__all__ = ["pipeline_forward", "shard_stage_params", "Stage"]

_ARRAYS = ("qdata", "scale", "zero_point", "svd_up", "svd_down")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _take(x, index):
    """Leaf ``x`` indexed on its layer axis (a view); QTensors array by
    array; 0-d leaves (not stacked) as they are."""
    if isinstance(x, QTensor):
        return dataclasses.replace(x, **{
            a: None if getattr(x, a) is None else getattr(x, a)[index]
            for a in _ARRAYS})
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x[index]


def _layers(tree) -> int:
    counts = set()

    def see(x):
        t = x.qdata if isinstance(x, QTensor) else x
        if isinstance(t, torch.Tensor) and t.dim():
            counts.add(t.shape[0])
        return x
    _map(tree, see)
    if len(counts) != 1:
        raise ValueError(f"stacked parameters with layer counts {counts}")
    return counts.pop()


@dataclasses.dataclass
class Stage:
    """Stage ``index`` of ``count``: ``params`` holds its layers of the
    stacked tree, views of the stacked storage."""
    params: Any
    index: int
    count: int


def shard_stage_params(stacked_params, mesh, axis: str = "fsdp") -> Stage:
    """This rank's stage of ``stacked_params`` along ``axis``: its L/P
    layers, views of the stacked storage (L % P == 0)."""
    p, s = mesh.shape[axis], mesh.get_local_rank(axis)
    n = _layers(stacked_params)
    if n % p:
        raise ValueError(f"{n} layers do not split into {p} stages")
    lp = n // p
    rows = slice(s * lp, (s + 1) * lp)
    return Stage(_map(stacked_params, lambda x: _take(x, rows)), s, p)


def pipeline_forward(block_fn, stacked_params, x_micro, mesh, *,
                     axis: str = "fsdp"):
    """Run x through all L stacked layers with the layer axis split over
    ``axis`` as pipeline stages.

    block_fn(block_params, x) -> x   (one layer's forward; block_params
                                      a view of one layer)
    stacked_params: the stacked tree (leading layer axis L, L % P == 0),
                    or this rank's ``Stage`` of it (``shard_stage_params``)
    x_micro: (num_micro, ...) microbatches, the same on every rank
    Returns the (num_micro, ...) outputs on every rank."""
    p, s = mesh.shape[axis], mesh.get_local_rank(axis)
    stage = (stacked_params if isinstance(stacked_params, Stage)
             else shard_stage_params(stacked_params, mesh, axis))
    if (stage.index, stage.count) != (s, p):
        raise ValueError(f"stage {stage.index} of {stage.count} on rank {s} "
                         f"of {p} along {axis}")
    layers = [_map(stage.params, lambda x, i=i: _take(x, i))
              for i in range(_layers(stage.params))]
    num_micro = x_micro.shape[0]
    mb = x_micro[0]

    def holds(stage_index, t):   # the stage holds microbatch t - stage
        return stage_index <= t < stage_index + num_micro

    outputs = torch.zeros_like(x_micro)
    buf = None
    for t in range(num_micro + p - 1):
        y = None
        if holds(s, t):
            y = x_micro[t] if s == 0 else buf
            for blk in layers:
                y = block_fn(blk, y)
            if y.shape != mb.shape or y.dtype != mb.dtype:
                raise ValueError(
                    f"block_fn changed {tuple(mb.shape)} {mb.dtype} into "
                    f"{tuple(y.shape)} {y.dtype}")
            if s == p - 1:
                outputs[t - (p - 1)] = y
        if p > 1:
            send = [y.contiguous()] if holds(s, t) and s < p - 1 else None
            recv = ([torch.empty(mb.shape, dtype=mb.dtype, device=mb.device)]
                    if s > 0 and holds(s - 1, t) else None)
            got = C.exchange(mesh, axis, send=send, recv=recv)
            buf = got[0] if got else None
    if p > 1:
        dist.all_reduce(outputs, group=mesh.get_group(axis))
    return outputs
