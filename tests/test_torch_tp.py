"""Tensor, expert and data parallelism of the port on gloo CPU process
groups, against the JAX package's sharded functions on conftest's 8-device
CPU mesh and against the port's own unsharded functions, on the same
seeded inputs and the same quantized bytes.

One ``torch.multiprocessing`` spawn of world 4 runs every case (the
workers import this module, which imports neither JAX nor the JAX package
at its top, and run one thread each):

* the FLUX_TINY DiT forward under ``shard_params(..., DIT_TP_RULES)`` at
  tensor 4 and at data 2 x tensor 2, int8 weight-only and int8 with the
  quantized matmul, block lists and stacked, against JAX's ``dit_forward``
  on its ``shard_params`` tree (``tests/test_parallel.py``'s case).
  Weight-only: JAX's own limits, atol 5e-3 and rtol 1e-3.  The quantized
  matmul: a row-parallel layer's fp32 partial sums are added in another
  order than the unsharded sum, and an ulp there moves an activation code
  at a rounding tie by one step in a later layer, as between the two
  packages (``tests/test_torch_dit.py``): max 4e-2 and mean 4e-3 of max
  |out| (measured 1.1e-2 and 1.7e-3);
* ``local_tp``, the same forward over virtual ranks of one process, equal
  to the gloo ranks' bit for bit (tensor 4; and each data rank's rows at
  data 2 x tensor 2);
* expert parallelism (``shard_moe``) over 4 ranks on
  ``tests/test_moe.py``'s case against JAX's sharded ``moe_ffn``: 1e-4;
  the virtual ranks at 2 and 8 too;
* the continuous batcher with its slots over data 2, bit-equal to
  ``mesh=None``;
* the tensor x data parallel training step (data 2 x tensor 2) on the
  JAX dry run's model, against JAX's GSPMD step on conftest's mesh (the
  same bytes and batch; ``STEP_TOL``, the updated codes with SR off so
  that no random draw differs), and against the port's unsharded step
  (SR on, the same generator): the loss within
  1e-6 of it; the gradients (weight-only: the grad-input and grad-weight
  quantized with the unsharded statistics, all-reduced) within 2e-3 of
  their max (measured 4.4e-4: fp32 sums in another order); the updated
  codes equal but for ties (at most 0.1% of codes, one step, measured
  0); the float parameters within 2.5·lr (AdamW's first step moves a
  parameter by about lr whatever its gradient's size, so a gradient near
  0 whose sign differs moves it by 2·lr);
* ``dryrun_multichip(4)``'s loss equal to ``dryrun_multichip(1)``'s, and
  ``launch(2, device="cpu")``'s (a spawn of its own);
* the training step wherever JAX's GSPMD step computes (``TRAIN_CASES``,
  each against the port's unsharded step on the dry run's model): the
  asymmetric (uint8) family's grad-input under a column-parallel layer
  (its ranges all-reduced), its input rows and re-quantized weight rows
  under a row-parallel one, and its grad-weight under a data axis; a
  grouped int8 weight re-quantized for the matmul under row parallelism
  (B1's given-scale mode); the uint4 recipe (its packed row-parallel
  layers replicated); the DiT's linears fsdp-sharded beside a data axis;
  and the uint8 step at data 2 x tensor 2 also against JAX's GSPMD step
  (``STEP_TOL``'s loss and gradients).  ``TRAIN_TOL`` gives each case's
  limits.  A row-parallel layer's fp32 partial sums add in another order
  than the unsharded sum, and an ulp there moves a dynamically quantized
  code at a rounding tie downstream, as in ``tests/test_torch_dit.py``;
  where no row-parallel sum is quantized after (fsdp) the step is equal;
* a trainable linear that saves its input quantized (emitted by B1's
  fused route, or quantized columnwise) under data 4, against the same
  linear unsharded: its saved codes are quantized by the statistics of
  every rank's tokens, so the loss agrees to 1e-6 and the weight
  gradient to ``SAVED_TOL`` of its largest entry (fp32 sums in another
  order); the input gradient, row by row, likewise;
* one sharded statistic at a time, where the whole step's codes move at
  ties: a trainable MLP (fc1 column parallel, fc2 row parallel, the
  quantized matmul, bf16 activations) at tensor 2 and 4 on virtual ranks
  and at tensor 4 on gloo, against the same layers unsharded on the same
  input and cotangent (``LAYER_TOL``).  fc2's input rows and re-quantized
  weight rows and fc1's grad-input operands are quantized by the whole
  rows' and columns' statistics, so the output differs by fp32 sums in
  another order, the weight gradients not at all, and the input
  gradient, whose shards' fp32 partial sums are added before one
  rounding to bf16, by fp32 sums (int8) or at most a bf16 ulp (uint8:
  the unsharded layer rounds its product to bf16 before it adds the
  zero points' rank-1 term).
"""

import dataclasses
import os
import socket
import time

import numpy as np
import pytest
import torch

TINY = dict(b=4, n_img=64, txt=16, hw=(8, 8))
MOE = dict(hidden_size=32, ff_dim=64, num_experts=8, top_k=2,
           capacity_factor=2.0)
RECIPES = {
    "wo": dict(weights_dtype="int8", dequant_dtype="float32"),
    "qmm": dict(weights_dtype="int8", use_quantized_matmul=True,
                dequant_dtype="float32"),
}
MESHES = {"t4": dict(tensor=4), "d2t2": dict(data=2, tensor=2)}
LR = 1e-4
STEP_LR = 1e-3   # the update held against JAX's: large enough to move codes
# The TP x DP step against JAX's: the loss's relative difference (read
# 1.3e-4; the limit of ``tests/test_torch_train.py``'s unsharded step),
# the largest gradient error over that gradient's largest value (3.3e-2;
# about twice), the share of updated codes that differ (9.1e-3; as the
# unsharded step's).
STEP_TOL = {"loss": 5e-4, "grad": 6e-2, "codes": 2e-2}
# The training cases (mesh, recipe, TP rules) against the port's unsharded
# step on the dry run's model; the recipes' groups of 32 divide every
# sharded input (uint8_g32 and int8_g32 are re-quantized for the matmul).
TRAIN_RECIPES = {
    "uint8_g32": dict(weights_dtype="uint8", group_size=32,
                      use_quantized_matmul=True, dequant_dtype="float32"),
    "uint8": dict(weights_dtype="uint8", use_quantized_matmul=True,
                  dequant_dtype="float32"),
    "int8_g32": dict(weights_dtype="int8", group_size=32,
                     use_quantized_matmul=True, dequant_dtype="float32"),
    "uint4_svd": dict(weights_dtype="uint4", use_svd=True, svd_rank=8,
                      group_size=32, use_quantized_matmul=True,
                      dequant_dtype="float32"),
    "int8": dict(weights_dtype="int8", use_quantized_matmul=True,
                 dequant_dtype="float32"),
}
# A batch of 16 gives every data rank's quantized-matmul linears at least
# 32 rows, as the unsharded step's: the port picks the weight-only or the
# quantized route by a rank's rows, JAX's GSPMD step by the global rows.
TRAIN_BATCH = 16
TRAIN_CASES = {
    "t4_uint8_g32": (dict(tensor=4), "uint8_g32", "tp"),
    "d4_uint8": (dict(data=4), "uint8", "tp"),
    "d2t2_uint8_g32": (dict(data=2, tensor=2), "uint8_g32", "tp"),
    "t4_int8_g32": (dict(tensor=4), "int8_g32", "tp"),
    "t4_uint4_svd": (dict(tensor=4), "uint4_svd", "tp"),
    "d2f2_int8": (dict(data=2, fsdp=2), "int8", "fsdp"),
}
# Each case's limits: the loss's relative difference and the largest
# gradient error over that gradient's largest value, about twice the
# readings on gloo (each rank on one thread, its unsharded reference
# too): t4_uint8_g32 1.9e-4 and 4.7e-2, d4_uint8 1.2e-4 and 2.5e-2,
# d2t2_uint8_g32 2.6e-6 and 1.6e-2, t4_int8_g32 1.8e-4 and 3.2e-2,
# t4_uint4_svd 0 and 1.3e-3, d2f2_int8 9.7e-8 and 3.6e-7.  The codes
# that move at ties make the gradients' readings: one code step of a
# narrow layer's tensor is a large share of its largest entry; the
# operands' quantization under each axis alone is exact to fp32 sums
# (the column-parallel uint8 grad-input 1.3e-7, the data-sharded uint8
# grad-weight 3.1e-7 of their largest entries).
TRAIN_TOL = {
    "t4_uint8_g32": (4e-4, 1e-1), "d4_uint8": (2.5e-4, 5e-2),
    "d2t2_uint8_g32": (1e-5, 3.5e-2), "t4_int8_g32": (4e-4, 6.5e-2),
    "t4_uint4_svd": (1e-6, 3e-3), "d2f2_int8": (2e-7, 1e-6),
}
# The trainable linear that saves its input quantized, under data 4: the
# weight and input gradients' largest error over their largest entry
# (fp32 sums in another order; read 2.0e-7 and 0, the loss 1.2e-7)
SAVED_RECIPES = {
    "int8_qmm": ("int8", True), "uint8_qmm": ("uint8", True),
    "fp8_qmm": ("float8_e4m3fn", True), "int8_wo": ("int8", False),
    "uint8_wo": ("uint8", False),
}
SAVED_TOL = 5e-7
# The layer check's recipes (format, group size) and limits by family:
# the output z, the input gradient gx (largest error over the largest
# value, and the error's norm over the norm; the weight gradients are
# equal).  About twice the readings at tensor 2 and 4, virtual and gloo:
# uint8 z 1.1e-3 and 5.3e-5, gx 3.9e-3 and 2.8e-3; int8 z 1.7e-8 and
# 1.0e-9, gx 2.4e-7 and 1.1e-8.  A shard quantized by its own statistics
# reads about 1e-2 in the norm (fc2's rows: z; fc1's grad-input: gx).
LAYER_RECIPES = {"uint8_g32": ("uint8", 32), "uint8": ("uint8", 0),
                 "int8_g32": ("int8", 32), "int8": ("int8", 0)}
LAYER_TOL = {
    "uint8": dict(z_max=2.5e-3, z_rms=1.2e-4, gx_max=8e-3, gx_rms=6e-3),
    "int8": dict(z_max=1e-7, z_rms=1e-8, gx_max=5e-7, gx_rms=5e-8),
}


def _inputs():
    from sdnq_tpu_torch.models import FLUX_TINY_CONFIG as cfg
    rng = np.random.default_rng(0)
    b, n, tl = TINY["b"], TINY["n_img"], TINY["txt"]
    return dict(
        img=rng.normal(size=(b, n, cfg.in_channels)).astype(np.float32),
        txt=rng.normal(size=(b, tl, cfg.txt_dim)).astype(np.float32),
        t=rng.uniform(0, 1, (b,)).astype(np.float32),
        pooled=rng.normal(size=(b, cfg.vec_dim)).astype(np.float32))


def _trees():
    """{recipe: the port's quantized FLUX_TINY tree}."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.models import FLUX_TINY_CONFIG, init_dit
    p = init_dit(FLUX_TINY_CONFIG, device="cpu")
    return {name: T.quantize_model(p, T.QuantConfig(**kw),
                                   arch="FluxTransformer2DModel",
                                   device="cpu")[0]
            for name, kw in RECIPES.items()}


def _step_setup(b: int = 4):
    """The dry run's model (int8, fp32 dequant) and a batch of ``b``."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.models.dit import DiTConfig, init_dit
    from sdnq_tpu_torch.parallel.dryrun import DRYRUN_CONFIG
    cfg = DiTConfig(**DRYRUN_CONFIG)
    q, _ = T.quantize_model(init_dit(cfg, device="cpu"), T.QuantConfig(
        weights_dtype="int8", dequant_dtype="float32"),
        arch="FluxTransformer2DModel", device="cpu")
    g = torch.Generator().manual_seed(3)
    batch = dict(img=torch.randn(b, 16, 8, generator=g),
                 txt=torch.randn(b, 8, 64, generator=g),
                 timesteps=torch.rand(b, generator=g),
                 pooled=torch.randn(b, 32, generator=g),
                 target=torch.randn(b, 16, 8, generator=g))
    return cfg, q, batch


def _train_trees():
    """{recipe: the dry run's model quantized by ``TRAIN_RECIPES``}."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.models.dit import DiTConfig, init_dit
    from sdnq_tpu_torch.parallel.dryrun import DRYRUN_CONFIG
    p = init_dit(DiTConfig(**DRYRUN_CONFIG), device="cpu")
    return {name: T.quantize_model(p, T.QuantConfig(**kw),
                                   arch="FluxTransformer2DModel",
                                   device="cpu")[0]
            for name, kw in TRAIN_RECIPES.items()}


def _case_rules(kind):
    from sdnq_tpu_torch.parallel import DIT_TP_RULES
    return (DIT_TP_RULES if kind == "tp"
            else {k: "fsdp" for k in DIT_TP_RULES})


def _step_grads(q, mesh=None, rules=None):
    """One step's loss and whole gradients (``tree_leaves`` order) of
    the dry run's model ``q`` on ``_step_setup``'s batch of TRAIN_BATCH:
    unsharded, or sharded by ``rules`` over ``mesh`` (every rank calls
    it)."""
    from sdnq_tpu_torch.models.dit import dit_forward, make_rope_freqs
    from sdnq_tpu_torch.parallel import shard_params
    from sdnq_tpu_torch.parallel.dryrun import dit_loss, whole_grads
    from sdnq_tpu_torch.train import (
        convert_model_to_training, extract_weight_grads,
    )
    from sdnq_tpu_torch.tree import tree_leaves
    cfg, _, batch = _step_setup(TRAIN_BATCH)
    freqs = make_rope_freqs(cfg, 8, (4, 4), device="cpu")
    tp = convert_model_to_training(q)
    if mesh is None:
        out = dit_forward(tp, batch["img"], batch["txt"], batch["timesteps"],
                          batch["pooled"], cfg, freqs=freqs, device="cpu")
        loss = torch.nn.functional.mse_loss(out.float(), batch["target"])
        loss.backward()
        grads = tree_leaves(extract_weight_grads(tp))
    else:
        sh = shard_params(tp, mesh, rules)
        loss = dit_loss(sh, batch, cfg, mesh, freqs, device="cpu")
        loss.backward()
        grads = whole_grads(sh)
        loss = mesh.comm("data").mean(loss.detach())
    return dict(loss=float(loss),
                grads=[None if g is None else g.numpy() for g in grads])


def _layer_mlp(p, x):
    from sdnq_tpu_torch.models.dit import _lin
    return _lin(p["fc2"], torch.nn.functional.gelu(_lin(p["fc1"], x),
                                                   approximate="tanh"))


def _layer_readings(recipe, shape=None, mesh=None):
    """The layer check (``LAYER_TOL``'s keys, and ``gw_equal``): the
    ``LAYER_RECIPES`` MLP (128 -> 512 -> 128, 96 tokens) forward and
    backward sharded over a tensor axis, on virtual ranks of ``shape`` or
    on this process's rank of ``mesh``, against the same layers
    unsharded."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.parallel import shard_params
    from sdnq_tpu_torch.parallel._collectives import run_virtual
    from sdnq_tpu_torch.parallel.dryrun import whole_grads
    from sdnq_tpu_torch.parallel.tp import local_tree
    from sdnq_tpu_torch.train import (
        convert_model_to_training, extract_weight_grads,
    )
    from sdnq_tpu_torch.tree import tree_leaves
    fmt, group = LAYER_RECIPES[recipe]
    g = torch.Generator().manual_seed(5)
    tree = {k: {"weight": T.quantize_tensor(
        torch.randn(o, i, generator=g) * 0.05, fmt, group_size=group,
        use_quantized_matmul=True, dequant_dtype="float32"),
        "bias": torch.randn(o, generator=g) * 0.01}
        for k, (o, i) in (("fc1", (512, 128)), ("fc2", (128, 512)))}
    x = torch.randn(96, 128, generator=g).bfloat16()
    gz = torch.randn(96, 128, generator=g)
    rules = {"fc1": "col", "fc2": "row"}

    def run(p, xx):
        z = _layer_mlp(p, xx)
        return z, (z.float() * gz).sum()
    t = convert_model_to_training(tree)
    x0 = x.clone().requires_grad_()
    z0, loss = run(t, x0)
    loss.backward()
    g0 = tree_leaves(extract_weight_grads(t))
    t = convert_model_to_training(tree)
    if mesh is not None:
        sh = shard_params(t, mesh, rules)
        x1 = x.clone().requires_grad_()
        z1, loss = run(local_tree(sh), x1)
        loss.backward()
        g1 = whole_grads(sh)
    else:
        shs = run_virtual(lambda m: shard_params(t, m, rules), shape, "cpu")
        xs = [x.clone().requires_grad_() for _ in shs]
        outs = run_virtual(lambda m: run(local_tree(shs[m.index]),
                                         xs[m.index]), shape, "cpu")
        torch.stack([o[1] for o in outs]).sum().backward()
        with torch.no_grad():
            g1 = run_virtual(lambda m: whole_grads(shs[m.index]), shape,
                             "cpu")[0]
        z1, x1 = outs[0][0], xs[0]

    def rd(a, b):
        a, b = a.detach().float(), b.detach().float()
        return (float((a - b).abs().max() / b.abs().max()),
                float((a - b).norm() / b.norm()))
    (z_max, z_rms), (gx_max, gx_rms) = rd(z1, z0), rd(x1.grad, x0.grad)
    pairs = [(a, b) for a, b in zip(g1, g0) if b is not None]
    return dict(z_max=z_max, z_rms=z_rms, gx_max=gx_max, gx_rms=gx_rms,
                gw_equal=len(pairs) == 4 and all(
                    a is not None and torch.equal(a, b) for a, b in pairs))


def _layers_within(r, recipe):
    tol = LAYER_TOL[LAYER_RECIPES[recipe][0]]
    assert r["gw_equal"], r
    for k, lim in tol.items():
        assert r[k] <= lim, (k, r)


def _saved_weights():
    """{recipe: a (64, 96) trainable linear's QTensor}, and its input
    (192, 96) bf16 and target."""
    import sdnq_tpu_torch as T
    g = torch.Generator().manual_seed(11)
    w = torch.randn(64, 96, generator=g) * 0.1
    x = torch.randn(192, 96, generator=g).bfloat16()
    t = torch.randn(192, 64, generator=g)
    return {name: T.quantize_tensor(w, fmt, use_quantized_matmul=qmm)
            for name, (fmt, qmm) in SAVED_RECIPES.items()}, x, t


def _saved_step(qt, x, t, mesh=None):
    """The trainable linear over ``x`` (this rank's rows under ``mesh``'s
    data axis) saving its input quantized: loss, weight and input
    gradients, as the unsharded step gives them."""
    from sdnq_tpu_torch.parallel import shard_batch
    from sdnq_tpu_torch.train.matmul import (
        TrainQTensor, grad_carrier, token_stats_reduced, train_qlinear,
    )
    w = TrainQTensor(qt=qt, delta=grad_carrier(qt.meta.original_shape,
                                               "cpu"))
    comm = None if mesh is None else mesh.comm("data")
    if comm is not None:
        x, t = shard_batch(x, mesh), shard_batch(t, mesh)
    x = x.clone().requires_grad_()
    with token_stats_reduced(comm):
        y = train_qlinear(x, w, save_quantized_activations=True)
    loss = ((y.float() - t) ** 2).mean()
    loss.backward()
    gw, gx = w.delta.grad, x.grad.float()
    if comm is not None:   # the data axis's mean of each rank's gradients
        loss, gw = comm.mean(loss.detach()), comm.mean(gw)
        gx = comm.gather(gx, 0) / comm.size
    return dict(loss=float(loss), gw=gw.numpy(), gx=gx.numpy())


def _batcher_run(mesh):
    """A 4-slot batcher over a queue of 7 requests; each step a quantized
    matmul (int8 codes, exact sums) of each active slot."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.pipeline import ContinuousBatcher, Request
    g = torch.Generator().manual_seed(5)
    w = T.quantize_tensor(torch.randn(8, 8, generator=g), "int8",
                          use_quantized_matmul=True)

    def step(lat, cond, t_idx, active):
        y = T.qlinear(lat * cond["w"], w, out_dtype=torch.float32)
        return torch.where(active[:, None], lat + 0.1 * torch.tanh(y), lat)

    b = ContinuousBatcher(step, lambda r: torch.full((8,), r.rng_seed * 0.1),
                          4, 4, mesh=mesh)
    for i, (n, seed) in enumerate(((3, 0), (1, 1), (4, 2), (2, 3), (2, 4),
                                   (3, 5), (1, 6))):
        b.submit(Request(i, {"w": torch.full((8,), 0.5 + i)}, n,
                         rng_seed=seed))
    done = b.run()
    return [r.request_id for r in done], {r.request_id: r.result
                                          for r in done}, b.efficiency


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _run_cases(cases):
    import torch.distributed as dist
    from sdnq_tpu_torch.models import FLUX_TINY_CONFIG as cfg
    from sdnq_tpu_torch.models import dit_forward, stack_dit_blocks
    from sdnq_tpu_torch.models.dit import make_rope_freqs
    from sdnq_tpu_torch.models.moe import MoEConfig, moe_ffn, shard_moe
    from sdnq_tpu_torch.optim import adamw
    from sdnq_tpu_torch.parallel import (
        DIT_TP_RULES, create_mesh, gather_batch, shard_batch, shard_params,
        unshard_params,
    )
    from sdnq_tpu_torch.parallel.dryrun import (
        dit_loss, dryrun_multichip, sharded_update, whole_grads,
    )
    from sdnq_tpu_torch.train import convert_model_to_training
    res = {}
    x = {k: torch.from_numpy(v) for k, v in cases["inputs"].items()}
    freqs = make_rope_freqs(cfg, TINY["txt"], TINY["hw"], device="cpu")
    for mname, shape in MESHES.items():
        mesh = create_mesh(device="cpu", **shape)
        for recipe, tree in cases["trees"].items():
            for stacked in (False, True):
                t = stack_dit_blocks(tree) if stacked else tree
                sh = shard_params(t, mesh, DIT_TP_RULES)
                tt = shard_batch(x["t"], mesh)
                with torch.no_grad():
                    out = dit_forward(
                        sh, shard_batch(x["img"], mesh),
                        shard_batch(x["txt"], mesh), tt,
                        shard_batch(x["pooled"], mesh), cfg, guidance=tt,
                        freqs=freqs, device="cpu")
                res[f"tp/{mname}/{recipe}/{int(stacked)}"] = \
                    gather_batch(out, mesh).numpy()
    mesh = create_mesh(tensor=4, device="cpu")
    qp, xm = cases["moe"]
    res["ep"] = moe_ffn(shard_moe(qp, mesh), xm, MoEConfig(**MOE),
                        out_dtype=torch.float32)[0].numpy()
    mesh = create_mesh(data=2, tensor=2, device="cpu")
    res["batcher"] = _batcher_run(mesh)
    # the tensor x data parallel step
    scfg, q, batch = _step_setup()
    tp = convert_model_to_training(q)
    opt = adamw(lr=LR, quantize_state=True, stochastic_rounding=True)
    st = opt.init(convert_model_to_training(q))
    sh = shard_params(tp, mesh, DIT_TP_RULES)
    sfreqs = make_rope_freqs(scfg, 8, (4, 4), device="cpu")
    loss = dit_loss(sh, batch, scfg, mesh, sfreqs, device="cpu")
    loss.backward()
    grads = whole_grads(sh)
    sharded_update(sh, opt, st, torch.Generator().manual_seed(7), grads)
    res["step"] = dict(
        loss=float(mesh.comm("data").mean(loss.detach())),
        grads=[None if g is None else g.numpy() for g in grads],
        params=unshard_params(sh))
    # the same gradients through AdamW with SR off (no random draw) and
    # STEP_LR, from the converted tree again: JAX's update's counterpart
    sh = shard_params(convert_model_to_training(q), mesh, DIT_TP_RULES)
    opt = adamw(lr=STEP_LR, quantize_state=True, stochastic_rounding=False)
    sharded_update(sh, opt, opt.init(convert_model_to_training(q)), None,
                   grads)
    res["step_no_sr"] = unshard_params(sh)
    res["dryrun"] = dryrun_multichip(dist.get_world_size(), device="cpu")
    # the training cases and their unsharded references, each rank on one
    # thread as the sharded steps (BLAS's sums may differ between thread
    # counts)
    for name, (shape, recipe, kind) in TRAIN_CASES.items():
        res[f"train/{name}"] = _step_grads(
            cases["train"][recipe], create_mesh(device="cpu", **shape),
            _case_rules(kind))
    for recipe, q in cases["train"].items():
        res[f"train_ref/{recipe}"] = _step_grads(q)
    mesh = create_mesh(data=4, device="cpu")
    qts, x, t = cases["saved"]
    for name, qt in qts.items():
        res[f"saved/{name}"] = _saved_step(qt, x, t, mesh)
        res[f"saved_ref/{name}"] = _saved_step(qt, x, t)
    mesh = create_mesh(tensor=4, device="cpu")
    for name in LAYER_RECIPES:
        res[f"layers/{name}"] = _layer_readings(name, mesh=mesh)
    return res


def _worker(rank, world, port, case_file, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        cases = torch.load(case_file, weights_only=False)
        torch.save(_run_cases(cases), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, cases, tmp):
    import torch.multiprocessing as mp
    case_file = os.path.join(tmp, "cases.pt")
    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir)
    torch.save(cases, case_file)
    ctx = mp.start_processes(_worker, args=(world, _free_port(), case_file,
                                            out_dir),
                             nprocs=world, join=False)
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"gloo world of {world} did not finish")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the JAX side and the tests
# ---------------------------------------------------------------------------

def _moe_case():
    """``tests/test_moe.py``'s EP case: JAX's banks and input, and the
    port's (the same bytes)."""
    import jax
    import jax.numpy as jnp
    from sdnq_tpu.models.moe import MoEConfig, init_moe, quantize_moe
    from sdnq_tpu_torch.convert import params_from_numpy
    cfg = MoEConfig(**MOE)
    qp = quantize_moe(init_moe(jax.random.key(3), cfg), "int8",
                      use_quantized_matmul=True)
    x = np.random.default_rng(3).normal(size=(16, cfg.hidden_size)) \
        .astype(np.float32)
    return (qp, jnp.asarray(x)), (params_from_numpy(qp, device="cpu"),
                                  torch.from_numpy(x))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    trees = _trees()
    jmoe, tmoe = _moe_case()
    cases = {"inputs": _inputs(), "trees": trees, "moe": tmoe,
             "train": _train_trees(), "saved": _saved_weights()}
    ranks = _spawn(4, cases, str(tmp_path_factory.mktemp("tp")))
    return cases, jmoe, ranks


def _to_jax(tree):
    import jax.numpy as jnp
    import sdnq_tpu as J
    import sdnq_tpu_torch as T
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    if isinstance(tree, T.QTensor):
        return J.QTensor(meta=J.QuantMeta(**dataclasses.asdict(tree.meta)),
                         **{f: None if getattr(tree, f) is None
                            else jnp.asarray(getattr(tree, f).numpy())
                            for f in ("qdata", "scale", "zero_point",
                                      "svd_up", "svd_down")})
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's sharded ``dit_forward`` of each recipe on each mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sdnq_tpu.models import FLUX_TINY_CONFIG as cfg
    from sdnq_tpu.models import dit_forward, make_rope_freqs
    from sdnq_tpu.parallel import DIT_TP_RULES as JR
    from sdnq_tpu.parallel import create_mesh, shard_params
    cases = setup[0]
    x = {k: jnp.asarray(v) for k, v in cases["inputs"].items()}
    freqs = make_rope_freqs(cfg, TINY["txt"], TINY["hw"])
    out = {}
    for mname, shape in MESHES.items():
        n = int(np.prod(list(shape.values())))
        mesh = create_mesh(devices=jax.devices()[:n], **shape)
        for recipe, tree in cases["trees"].items():
            sharded = shard_params(_to_jax(tree), mesh, JR)
            ds = NamedSharding(mesh, P("data"))
            with jax.set_mesh(mesh):
                fwd = jax.jit(lambda p, i, tx: dit_forward(
                    p, i, tx, x["t"], x["pooled"], cfg, guidance=x["t"],
                    freqs=freqs))
                out[(mname, recipe)] = np.asarray(fwd(
                    sharded, jax.device_put(x["img"], ds),
                    jax.device_put(x["txt"], ds)))
    return out


@pytest.fixture(scope="module")
def jax_step():
    """JAX's tensor x data parallel step (``__graft_entry__``'s GSPMD
    dry run step) on conftest's CPU mesh, data 2 x tensor 2, from the
    port's quantized tree (the same bytes) and the same batch: the loss,
    the whole gradients (``tree_leaves`` order, a TrainQTensor's
    ``delta``), and the leaves after AdamW with SR off at STEP_LR."""
    return _jax_step(_step_setup()[1])


@pytest.fixture(scope="module")
def jax_step_uint8(setup):
    """``jax_step`` on the uint8 (groups of 32, quantized matmul) tree of
    ``TRAIN_CASES``'s d2t2_uint8_g32 case, the same bytes."""
    return _jax_step(setup[0]["train"]["uint8_g32"], update=False,
                     b=TRAIN_BATCH)


def _jax_step(q, update=True, b=4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sdnq_tpu.models.dit import DiTConfig, dit_forward, make_rope_freqs
    from sdnq_tpu.optim import adamw as j_adamw
    from sdnq_tpu.parallel import DIT_TP_RULES as JR
    from sdnq_tpu.parallel import create_mesh, shard_params
    from sdnq_tpu.tensor import QTensor
    from sdnq_tpu.train import (
        TrainQTensor, convert_model_to_training, value_and_grad,
    )
    from sdnq_tpu_torch.parallel.dryrun import DRYRUN_CONFIG
    batch = _step_setup(b)[2]
    cfg = DiTConfig(**DRYRUN_CONFIG)
    mesh = create_mesh(data=2, tensor=2, devices=jax.devices()[:4])
    ds = NamedSharding(mesh, P("data"))
    b = {k: jax.device_put(jnp.asarray(v.numpy()), ds)
         for k, v in batch.items()}
    freqs = make_rope_freqs(cfg, 8, (4, 4))
    opt = j_adamw(lr=STEP_LR, quantize_state=True, stochastic_rounding=False)

    def loss_fn(tp):
        out = dit_forward(tp, b["img"], b["txt"], b["timesteps"],
                          b["pooled"], cfg, freqs=freqs)
        return jnp.mean((out.astype(jnp.float32) - b["target"]) ** 2)

    @jax.jit
    def step(tp, state):
        loss, grads = value_and_grad(loss_fn)(tp)
        return (loss, grads) + opt.update(grads, state, tp)

    with jax.set_mesh(mesh):
        jt = shard_params(convert_model_to_training(_to_jax(q)), mesh, JR)
        if update:
            loss, grads, new, _ = step(jt, opt.init(jt))
        else:
            loss, grads = jax.jit(value_and_grad(loss_fn))(jt)
    is_j = (lambda x: isinstance(x, (TrainQTensor, QTensor)))
    grads = [np.asarray(g.delta if isinstance(g, TrainQTensor) else g)
             for g in jax.tree_util.tree_leaves(grads, is_leaf=is_j)]
    if not update:
        return float(loss), grads
    new = [(np.asarray(x.qt.qdata), np.asarray(x.qt.scale))
           if isinstance(x, TrainQTensor) else np.asarray(x)
           for x in jax.tree_util.tree_leaves(new, is_leaf=is_j)]
    return float(loss), grads, new


def _rank0(ranks, key):
    for r in ranks[1:]:
        if isinstance(ranks[0][key], np.ndarray):
            np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("stacked", [0, 1])
@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("mname", list(MESHES))
def test_tp_forward_against_jax(setup, jax_refs, mname, recipe, stacked):
    _, _, ranks = setup
    out = _rank0(ranks, f"tp/{mname}/{recipe}/{stacked}")
    ref = jax_refs[(mname, recipe)]
    assert out.shape == ref.shape
    if recipe == "wo":
        np.testing.assert_allclose(out, ref, atol=5e-3, rtol=1e-3)
    else:
        d = np.abs(out - ref) / np.abs(ref).max()
        assert d.max() < 4e-2 and d.mean() < 4e-3, (d.max(), d.mean())


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("mname", list(MESHES))
def test_local_tp_equals_gloo(setup, mname, recipe):
    from sdnq_tpu_torch.models import FLUX_TINY_CONFIG as cfg
    from sdnq_tpu_torch.models.dit import make_rope_freqs
    from sdnq_tpu_torch.parallel.tp import _local_tp
    cases, _, ranks = setup
    x = {k: torch.from_numpy(v) for k, v in cases["inputs"].items()}
    freqs = make_rope_freqs(cfg, TINY["txt"], TINY["hw"], device="cpu")
    shape = MESHES[mname]
    t_size, d = shape["tensor"], shape.get("data", 1)
    per = TINY["b"] // d
    outs = []
    with torch.no_grad():
        for i in range(d):   # each data rank's rows
            rows = slice(i * per, (i + 1) * per)
            outs.append(_local_tp(
                cases["trees"][recipe], x["img"][rows], x["txt"][rows],
                x["t"][rows], x["pooled"][rows], cfg, t_size,
                guidance=x["t"][rows], freqs=freqs, device="cpu"))
    got = torch.cat(outs).numpy()
    np.testing.assert_array_equal(got, _rank0(ranks, f"tp/{mname}/{recipe}/0"))


def test_expert_parallel_against_jax(setup):
    import jax
    from sdnq_tpu.models.moe import MoEConfig as JCfg
    from sdnq_tpu.models.moe import moe_ffn as jmoe, shard_moe as jshard
    from sdnq_tpu.parallel import create_mesh
    import jax.numpy as jnp
    from sdnq_tpu_torch.models.moe import MoEConfig, moe_ffn, shard_moe
    from sdnq_tpu_torch.parallel._collectives import run_virtual
    cases, (jqp, jx), ranks = setup
    mesh = create_mesh(tensor=4, devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        ref = np.asarray(jax.jit(lambda p, x: jmoe(
            p, x, JCfg(**MOE), out_dtype=jnp.float32)[0])(
                jshard(jqp, mesh, axis="tensor"), jx))
    np.testing.assert_allclose(_rank0(ranks, "ep"), ref, rtol=1e-4,
                               atol=1e-4)
    tqp, tx = cases["moe"]
    for n in (2, 8):
        out = run_virtual(lambda m: moe_ffn(shard_moe(tqp, m), tx,
                                            MoEConfig(**MOE),
                                            out_dtype=torch.float32)[0],
                          {"tensor": n}, "cpu")[0]
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_batcher_over_data_equals_one_device(setup):
    _, _, ranks = setup
    order, results, eff = _batcher_run(None)
    for r in ranks:
        got_order, got, got_eff = r["batcher"]
        assert got_order == order and got_eff == eff
        for k in results:
            np.testing.assert_array_equal(got[k], results[k])


def test_tp_dp_step_against_unsharded(setup):
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.models.dit import dit_forward, make_rope_freqs
    from sdnq_tpu_torch.optim import adamw
    from sdnq_tpu_torch.train import (
        convert_model_to_training, extract_weight_grads,
    )
    from sdnq_tpu_torch.tree import tree_leaves
    _, _, ranks = setup
    cfg, q, batch = _step_setup()
    tp = convert_model_to_training(q)
    opt = adamw(lr=LR, quantize_state=True, stochastic_rounding=True)
    st = opt.init(tp)
    freqs = make_rope_freqs(cfg, 8, (4, 4), device="cpu")
    out = dit_forward(tp, batch["img"], batch["txt"], batch["timesteps"],
                      batch["pooled"], cfg, freqs=freqs, device="cpu")
    loss = torch.nn.functional.mse_loss(out.float(), batch["target"])
    loss.backward()
    grads = [None if g is None else g.clone() for g in
             tree_leaves(extract_weight_grads(tp))]
    opt.update(None, st, tp, torch.Generator().manual_seed(7))
    is_q = (lambda x: isinstance(x, (T.QTensor, T.train.TrainQTensor)))
    want_p = tree_leaves(tp, is_leaf=is_q)
    for r in ranks:
        step = r["step"]
        assert abs(step["loss"] - loss.item()) <= 1e-6 * loss.item()
        assert len(step["grads"]) == len(grads)
        for g, w in zip(step["grads"], grads):
            assert (g is None) == (w is None)
            if w is not None:
                assert np.abs(g - w.numpy()).max() <= \
                    2e-3 * w.abs().max().item()
        got_p = tree_leaves(step["params"], is_leaf=is_q)
        flips = total = 0
        for g, w in zip(got_p, want_p):
            if isinstance(w, T.train.TrainQTensor):
                d = (g.qdata.int() - w.qt.qdata.int()).abs()
                assert d.max() <= 1
                flips, total = flips + int((d > 0).sum()), total + d.numel()
            elif isinstance(w, torch.Tensor) and w.is_floating_point():
                assert (g - w.detach()).abs().max() <= 2.5 * LR
        assert flips <= 1e-3 * total, (flips, total)


def test_tp_dp_step_against_jax(setup, jax_step):
    """The gloo ranks' data 2 x tensor 2 step against JAX's GSPMD step on
    the same bytes and batch: the loss; every whole gradient (the dynamic
    int8 backward's codes at rounding ties differ between XLA's and
    torch's fp32 sums, as in ``tests/test_torch_train.py``'s unsharded
    step); and, after AdamW with SR off at STEP_LR, the codes (a small
    share differs, each weight within two of AdamW's steps of JAX's, 10%
    more for the 8-bit moments, and one rounding; a step moves most codes)
    and the float leaves (within 2.5·STEP_LR: a gradient near 0 whose sign
    differs moves a parameter by 2·STEP_LR)."""
    import sdnq_tpu_torch as T
    from sdnq_tpu_torch.tree import tree_leaves
    _, _, ranks = setup
    jloss, jgrads, jnew = jax_step
    for r in ranks:
        step = r["step"]
        assert abs(step["loss"] - jloss) <= STEP_TOL["loss"] * jloss
        got = [g for g in step["grads"] if g is not None]
        assert len(got) == len(jgrads) > 20
        for g, w in zip(got, jgrads):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= \
                STEP_TOL["grad"] * np.abs(w).max(), np.abs(g - w).max()
        new = tree_leaves(r["step_no_sr"], is_leaf=lambda x: isinstance(
            x, T.QTensor))
        assert len(new) == len(jnew)
        diff = moved = total = 0
        for got, want, old in zip(new, jnew, tree_leaves(
                _step_setup()[1], is_leaf=lambda x: isinstance(
                    x, T.QTensor))):
            if isinstance(got, T.QTensor):
                codes = got.qdata.numpy().astype(np.int32)
                ref = want[0].astype(np.int32)
                diff += int((codes != ref).sum())
                moved += int((codes != old.qdata.numpy()).sum())
                total += codes.size
                step_v = want[1].reshape(-1, 1)
                wv = codes * got.scale.numpy().reshape(-1, 1)
                assert (np.abs(wv - ref * step_v)
                        <= 2.2 * STEP_LR + 1.01 * step_v).all()
            else:
                assert np.abs(got.detach().numpy() - want).max() <= \
                    2.5 * STEP_LR
        assert moved > 0.01 * total, (moved, total)
        assert diff <= STEP_TOL["codes"] * total, (diff, total)


def test_dryrun_multichip_world_4_equals_1(setup):
    from sdnq_tpu_torch.parallel.dryrun import dryrun_multichip, tensor_size
    _, _, ranks = setup
    assert [tensor_size(n) for n in (1, 2, 3, 4, 8)] == [1, 2, 1, 4, 4]
    one = dryrun_multichip(1, device="cpu")
    assert np.isfinite(one)
    for r in ranks:
        assert r["dryrun"] == pytest.approx(one, rel=1e-6)


def test_launch_on_gloo(tmp_path):
    """``launch(2, device="cpu")``: two gloo processes run the dry run's
    step (tensor 2), rank 0's loss that of one process."""
    from sdnq_tpu_torch.parallel.dryrun import dryrun_multichip, launch
    loss = launch(2, device="cpu", out_dir=str(tmp_path))
    assert loss == pytest.approx(dryrun_multichip(1, device="cpu"),
                                 rel=1e-6)


def test_virtual_ranks_take_turns():
    """Virtual ranks run one at a time between collectives: a read-modify-
    write of shared state loses no update, with a short switch interval
    and more ranks than cores, and every exchange returns each rank its
    own result."""
    import sys
    from sdnq_tpu_torch.parallel._collectives import run_virtual
    box = {"n": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def rank(mesh):
            comm = mesh.comm("tensor")
            seen = []
            for i in range(50):
                for _ in range(20):
                    v = box["n"]
                    box["n"] = v + 1
                x = torch.full((1,), float(comm.rank * 100 + i))
                seen.append(comm.gather(x, 0).tolist())
            return seen
        out = run_virtual(rank, {"tensor": 16}, "cpu")
    finally:
        sys.setswitchinterval(old)
    assert box["n"] == 16 * 50 * 20
    for seen in out:
        assert seen == [[float(r * 100 + i) for r in range(16)]
                        for i in range(50)]


def _within(got, want, loss_tol, grad_tol):
    """The step's readings against the reference: (loss's relative
    difference, the largest gradient error over that gradient's largest
    value), each held to its limit."""
    dl = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    gg = [g for g in got["grads"] if g is not None]
    ww = [w for w in want["grads"] if w is not None]
    assert len(gg) == len(ww) > 20
    dg = 0.0
    for g, w in zip(gg, ww):
        assert g.shape == w.shape
        dg = max(dg, float(np.abs(g - w).max()
                           / max(float(np.abs(w).max()), 1e-30)))
    assert dl <= loss_tol and dg <= grad_tol, (dl, dg)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_against_unsharded(setup, case):
    """The TP, DP and fsdp step where the port raised before (the
    asymmetric family's ranges, a row-parallel weight re-quantized for
    the matmul, fsdp layers in training) against the unsharded step."""
    _, _, ranks = setup
    _, recipe, _ = TRAIN_CASES[case]
    for r in ranks:
        _within(r[f"train/{case}"], r[f"train_ref/{recipe}"],
                *TRAIN_TOL[case])


def test_train_step_uint8_against_jax(setup, jax_step_uint8):
    """The uint8 family (groups of 32, quantized matmul) at data 2 x
    tensor 2 against JAX's GSPMD step on the same bytes and batch, at
    ``STEP_TOL``'s loss and gradient limits."""
    _, _, ranks = setup
    loss, grads = jax_step_uint8
    for r in ranks:
        _within(r["train/d2t2_uint8_g32"], dict(loss=loss, grads=grads),
                STEP_TOL["loss"], STEP_TOL["grad"])


@pytest.mark.parametrize("t_size", [2, 4])
@pytest.mark.parametrize("recipe", list(LAYER_RECIPES))
def test_sharded_layers_against_unsharded(recipe, t_size):
    """The layer check on virtual ranks (``LAYER_TOL``): each sharded
    statistic makes the layers' output and gradients the unsharded
    layers' but for fp32 sums in another order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the gloo ranks
    try:
        r = _layer_readings(recipe, {"tensor": t_size})
    finally:
        torch.set_num_threads(threads)
    _layers_within(r, recipe)


@pytest.mark.parametrize("recipe", list(LAYER_RECIPES))
def test_sharded_layers_on_gloo(setup, recipe):
    """The layer check on the gloo ranks at tensor 4 (``LAYER_TOL``)."""
    _, _, ranks = setup
    for r in ranks:
        _layers_within(r[f"layers/{recipe}"], recipe)


@pytest.mark.parametrize("recipe", list(SAVED_RECIPES))
def test_saved_activations_under_data_axis(setup, recipe):
    """A trainable linear saving its input quantized (B1's emitted codes
    on the fused route, else columnwise) under data 4, against the same
    linear unsharded: loss within 1e-6, the weight and input gradients
    within ``SAVED_TOL`` of their largest entries."""
    _, _, ranks = setup
    for r in ranks:
        got, want = r[f"saved/{recipe}"], r[f"saved_ref/{recipe}"]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * want["loss"]
        for k in ("gw", "gx"):
            err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            assert err <= SAVED_TOL, (k, err)
