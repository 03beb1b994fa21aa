"""The tensor x data parallel training step of the quantized DiT.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
a data x tensor mesh (tensor the first of 4, 2, 1 that divides the
world), the quantized DiT converted to training and sharded by
``DIT_TP_RULES``, and one full quantized training step: the forward on the
stored codes, the dynamic int8 backward (B1's nn and colscale, B4, B10),
the gradients averaged over ``data``, and AdamW with 8-bit state and
stochastic rounding.

The update (``sharded_update``) works on whole leaves, as GSPMD's does:
each sharded leaf's gradient and codes are gathered over the tensor axis,
the optimizer updates the whole tree (its state whole on every tensor
rank), and each rank keeps its shard of the result.  So updates that read
more than one element of a leaf (Muon's Newton-Schulz, Adafactor's and
CAME's factored moments, a norm-based final-norm mode, a row-parallel
weight's requantization against its whole rows) give the unsharded
update, and the stochastic rounding draws come from the shared seeded
generator over the whole shapes, equal to the unsharded step's.  The
state is not sharded (ROADMAP queue C).

``train_step`` runs on each rank of a process group; ``local_train_step``
runs the same step over virtual ranks (threads) of one device: their
forwards in lockstep, one backward over the joined graph, then their
updates.  ``dryrun_multichip(n)`` is each rank's entry after
``init_process_group``; ``launch(n)`` starts n processes that run it
(NCCL, a card each; gloo on the CPU with ``device="cpu"``).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.nn.functional as F

from ..tensor import QTensor, layer_count
from ..train.matmul import TrainQTensor, token_stats_reduced
from ..tree import tree_leaves
from ._collectives import run_virtual
from .sharding import (
    REPLICATED, Placement, Sharded, _take_qt, assemble, gather_leaf,
    shard_batch, take,
)

__all__ = ["dit_loss", "whole_grads", "sharded_update", "train_step",
           "local_train_step",
           "dryrun_multichip", "launch", "DRYRUN_CONFIG", "tensor_size"]


def tensor_size(n_devices: int) -> int:
    """The tensor axis of an n-device mesh, as the JAX dry run picks it:
    the first of 4, 2, 1 that divides n."""
    for cand in (4, 2, 1):
        if n_devices % cand == 0 and cand <= n_devices:
            return cand
    return 1


def dit_loss(sharded, batch: dict, cfg, mesh, freqs=None, attn_config=None,
             device=None):
    """The mean squared error of the sharded DiT on this rank's rows of the
    global ``batch`` (img, txt, timesteps, pooled, target; guidance
    optional), split over ``data``."""
    from ..models.dit import dit_forward
    b = {k: None if v is None else shard_batch(v, mesh)
         for k, v in batch.items()}
    with token_stats_reduced(mesh.comm("data")):
        out = dit_forward(sharded, b["img"], b["txt"], b["timesteps"],
                          b["pooled"], cfg, guidance=b.get("guidance"),
                          freqs=freqs, attn_config=attn_config,
                          device=device)
    return F.mse_loss(out.float(), b["target"].float())


def _grad_placement(s: Sharded) -> Placement:
    """How a leaf's gradient lies over the ranks: a weight's (out, in)
    gradient split as its rows ("col") or input columns ("row"), with the
    layer's segments; a tensor's as the tensor."""
    pl = s.placement
    if not isinstance(pl, QTensor):
        return pl
    first = pl.qdata if pl.qdata.sharded else pl.scale
    if not first.sharded:
        return REPLICATED
    layer_dim = 0 if s.mode in ("col", "fsdp") else 1
    stacked = layer_count(_qt(s.local)) is not None
    return Placement(layer_dim + int(stacked), first.axis, first.size,
                     tuple(s.segments) if len(s.segments) > 1 else ())


def _qt(x):
    return x.qt if isinstance(x, TrainQTensor) else x


def _local_grad(x):
    holder = x.delta if isinstance(x, TrainQTensor) else x
    if not isinstance(holder, torch.Tensor):
        return None
    g = holder.grad
    holder.grad = None
    return g


def whole_grads(sharded) -> list:
    """The whole gradient of each leaf (``tree_leaves`` order; None where
    none): the shards' gradients averaged over ``data`` and gathered over
    their axis, then cleared on the shards (every rank calls it in
    step)."""
    out = []
    for s in tree_leaves(sharded, is_leaf=lambda x: isinstance(x, Sharded)):
        g = _local_grad(s.local) if isinstance(s, Sharded) else None
        if g is not None:
            g = s.mesh.comm("data").mean(g)
            gp = _grad_placement(s)
            if gp.sharded:
                g = assemble(s.mesh.comm(gp.axis)._gather_list(g), gp)
        out.append(g)
    return out


def sharded_update(sharded, opt, opt_state, generator=None, grads=None):
    """One optimizer step of a sharded tree whose shards hold their
    gradients (every rank calls it in step): ``whole_grads`` (or the given
    ``grads``), the update on the whole leaves (``opt_state`` initialized
    on the whole tree), and each rank's shard of the result written back
    in place."""
    leaves = tree_leaves(sharded, is_leaf=lambda x: isinstance(x, Sharded))
    full_g = whole_grads(sharded) if grads is None else list(grads)
    full_p = []
    for s in leaves:
        if not isinstance(s, Sharded):
            full_p.append(s)
            continue
        whole = gather_leaf(s)
        if isinstance(s.local, TrainQTensor):
            whole = TrainQTensor(qt=whole, delta=None)
        full_p.append(whole)
    opt.update(full_g, opt_state, full_p, generator)
    for s, whole in zip(leaves, full_p):
        if not isinstance(s, Sharded):
            continue
        pl = s.placement
        if isinstance(s.local, TrainQTensor):
            first = pl.qdata if pl.qdata.sharded else pl.scale
            stacked = layer_count(s.local.qt) is not None
            s.local.qt = _take_qt(whole.qt, pl, s.mesh.get_local_rank(
                first.axis) if first.axis else 0, stacked)
        elif isinstance(s.local, torch.Tensor) and isinstance(
                whole, torch.Tensor):
            part = take(whole, pl, s.mesh.get_local_rank(pl.axis)
                        if pl.axis else 0)
            with torch.no_grad():
                s.local.copy_(part.to(s.local.dtype))
    return sharded, opt_state


def train_step(sharded, opt, opt_state, batch: dict, cfg, mesh, *,
               freqs=None, generator=None, attn_config=None, device=None):
    """One training step on this rank of a process group: the loss of its
    rows, the backward, ``sharded_update``.  Returns the loss averaged over
    ``data``."""
    loss = dit_loss(sharded, batch, cfg, mesh, freqs, attn_config, device)
    loss.backward()
    sharded_update(sharded, opt, opt_state, generator)
    return mesh.comm("data").mean(loss.detach())


def local_train_step(trees: list, opt, opt_states: list, batch: dict, cfg,
                     shape: dict, *, freqs=None, generators=None,
                     attn_config=None, device=None, grads_out=None):
    """``train_step`` over the virtual ranks of ``trees`` (each rank's
    ``shard_params`` tree, made in a ``run_virtual`` of mesh ``shape``):
    the forwards in lockstep, one backward of the ranks' losses summed (each
    rank's gradient flows from its own loss through the collectives' joint
    nodes), then each rank's update with its own state and generator (equal
    copies).  Returns the loss averaged over ``data``; ``grads_out``, a
    list, receives rank 0's whole gradients (``whole_grads``)."""
    if shape.get("data", 1) > 1:
        raise ValueError(
            "virtual ranks take one data rank: the backward of data "
            "parallelism all-reduces its token statistics, which the one "
            "backward of joined virtual ranks cannot; run a process group")
    gens = generators or [None] * len(trees)
    device = device or _device_type(trees[0])

    def fwd(mesh):
        return dit_loss(trees[mesh.index], batch, cfg, _mesh_of(
            trees[mesh.index]), freqs, attn_config, device)
    losses = run_virtual(fwd, shape, _device_type(trees[0]))
    torch.stack(losses).sum().backward()

    def upd(mesh):
        i = mesh.index
        grads = whole_grads(trees[i])
        if i == 0 and grads_out is not None:
            grads_out.extend(grads)
        sharded_update(trees[i], opt, opt_states[i], gens[i], grads)
    with torch.no_grad():
        run_virtual(upd, shape, _device_type(trees[0]))
    return torch.stack([x.detach() for x in losses]).reshape(
        shape.get("data", 1), -1)[:, 0].mean()


def _first_sharded(tree):
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, Sharded)):
        if isinstance(leaf, Sharded):
            return leaf
    raise ValueError("the tree holds no Sharded leaf")


def _mesh_of(tree):
    return _first_sharded(tree).mesh


def _device_type(tree):
    return _mesh_of(tree).device_type


# The JAX dry run's model: a small Flux-style DiT.
DRYRUN_CONFIG = dict(in_channels=8, hidden_size=128, num_heads=4,
                     depth_double=1, depth_single=2, txt_dim=64, vec_dim=32,
                     axes_dims=(8, 12, 12), guidance_embed=False)


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Each rank's entry, after ``init_process_group`` of ``n_devices``
    ranks: the data x tensor mesh, the quantized DiT (int8, fp32 dequant)
    converted to training and sharded, AdamW with 8-bit state and
    stochastic rounding, and one full training step on a batch of 2 a
    data rank.  Returns the loss (finite, or it raises)."""
    from .. import QuantConfig, quantize_model
    from ..kernels.dispatch import resolve_device
    from ..models.dit import DiTConfig, init_dit, make_rope_freqs
    from ..optim import adamw
    from ..train import convert_model_to_training
    from .mesh import create_mesh
    from .sharding import DIT_TP_RULES, shard_params
    device = resolve_device(device)
    tensor = tensor_size(n_devices)
    data = n_devices // tensor
    mesh = create_mesh(data=data, tensor=tensor, device=device)
    cfg = DiTConfig(**DRYRUN_CONFIG)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_dit(cfg, generator=gen, device=device)
    qparams, _ = quantize_model(
        params, QuantConfig(weights_dtype="int8", dequant_dtype="float32"),
        arch="FluxTransformer2DModel", device=device)
    tparams = convert_model_to_training(qparams)
    opt = adamw(lr=1e-4, quantize_state=True, stochastic_rounding=True)
    opt_state = opt.init(tparams)
    sharded = shard_params(tparams, mesh, DIT_TP_RULES)
    b, img_hw, txt_len = 2 * data, (4, 4), 8
    n_img = img_hw[0] * img_hw[1]
    batch = dict(
        img=torch.ones((b, n_img, cfg.in_channels), device=device),
        txt=torch.ones((b, txt_len, cfg.txt_dim), device=device),
        timesteps=torch.full((b,), 0.5, device=device),
        pooled=torch.ones((b, cfg.vec_dim), device=device),
        target=torch.zeros((b, n_img, cfg.in_channels), device=device))
    freqs = make_rope_freqs(cfg, txt_len, img_hw, device=device)
    loss = train_step(sharded, opt, opt_state, batch, cfg, mesh,
                      freqs=freqs,
                      generator=torch.Generator(device=device).manual_seed(1),
                      device=device)
    if not torch.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: loss {float(loss)}")
    return float(loss)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_rank(rank, world, port, device_type, out):
    import torch.distributed as dist
    dev = "cpu"
    if device_type == "cpu":
        torch.set_num_threads(1)   # the host's cores shared by the ranks
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        loss = dryrun_multichip(world, device=dev)
        if rank == 0:
            with open(out, "w") as f:
                f.write(repr(loss))
    finally:
        dist.destroy_process_group()


def launch(n_devices: int, device=None, out_dir=None) -> float:
    """``dryrun_multichip`` on ``n_devices`` processes of this host, one
    card each over NCCL, or gloo processes on the CPU when ``device="cpu"``
    is passed; returns rank 0's loss."""
    import tempfile
    import torch.multiprocessing as mp
    from ..kernels.dispatch import resolve_device
    device_type = resolve_device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} processes take a card each; "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        out = os.path.join(d, "loss")
        mp.start_processes(_launch_rank, args=(n_devices, _free_port(),
                                               device_type, out),
                           nprocs=n_devices, join=True)
        with open(out) as f:
            return float(f.read())
