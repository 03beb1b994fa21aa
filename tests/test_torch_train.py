"""Quantized training: the port's ``train`` package and the differentiable
attention against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both packages; the port runs on the
very bytes the JAX package quantized (``convert``).  Tolerances, each with
its reason:

* ``train_qlinear`` gradients: 1e-5 of the largest entry.  Both packages
  quantize the same bf16 cotangent and the same inputs with the same
  arithmetic and sum integers exactly; what is left is fp32 summation
  order (Hadamard rotation, zero-point terms).
* forward outputs (bf16): one bf16 ulp of the largest output, 2^-7 of it:
  the uint8 zero-point terms are added in another fp32 order, which moves
  a few roundings to bf16.
* the FLUX_TINY step: loss within 5e-4 relative (sound 7e-5 and 1.3e-4 on
  two input seeds); every gradient within 8e-2 of its largest entry (sound
  worst 4.6e-2): bf16 roundings that differ by one ulp flip int8 activation
  codes, and the flips compound through the blocks and the backward.
  After one AdamW step (SR off, lr 1e-3, about half a code step) 82% of
  the codes move and at most 2% of the new codes differ between the
  packages (sound 1.08%), the weights they stand for by at most 2·lr
  (10% more for the 8-bit moments' rounding) plus one code step (sound
  0.9998 of that bound): AdamW's first step is about sign(g)·lr, and a
  gradient entry near zero may take the other sign.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnq_tpu import QuantConfig as JQuantConfig
from sdnq_tpu import quantize_model as j_quantize_model
from sdnq_tpu.kernels import attention as jattn
from sdnq_tpu.models import dit as jdit
from sdnq_tpu.optim import adamw as j_adamw
from sdnq_tpu.tensor import QTensor as JQTensor
from sdnq_tpu.tensor import quantize_tensor as j_quantize_tensor
from sdnq_tpu.train import (
    DynamicTensor as JDynamicTensor,
    TrainQTensor as JTrainQTensor,
    apply_weight_updates as j_apply_weight_updates,
    convert_model_to_training as j_convert,
    dynamic_qlinear as j_dynamic_qlinear,
    make_train_params as j_make_train_params,
    train_qlinear as j_train_qlinear,
)

import sdnq_tpu_torch as T
from sdnq_tpu_torch.convert import (
    opt_state_from_numpy, qtensor_from_numpy, train_params_from_numpy,
)
from sdnq_tpu_torch.kernels.attention import trainable_attention
from sdnq_tpu_torch.models import dit as tdit
from sdnq_tpu_torch.optim import BufferQ, adamw
from sdnq_tpu_torch.train import (
    DynamicTensor, TrainQTensor, apply_weight_updates, checkpoint_block,
    convert_model_to_training, convert_training_model_to_inference,
    dots_saveable_policy, dynamic_qlinear, extract_weight_grads, fit,
    grad_carrier, make_train_params, train_qlinear,
)
from sdnq_tpu_torch.tree import tree_leaves


def _port_qt(qj):
    fields = {k: (None if getattr(qj, k) is None
                  else np.asarray(getattr(qj, k)))
              for k in ("qdata", "scale", "zero_point", "svd_up",
                        "svd_down")}
    return qtensor_from_numpy(fields, dataclasses.asdict(qj.meta), "cpu")


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# train_qlinear
# ---------------------------------------------------------------------------

_LINEAR_CASES = [(fmt, sq, m, False) for fmt in ("int8", "uint8",
                                                 "float8_e4m3fn")
                 for sq in (False, True) for m in (8, 64)]
_LINEAR_CASES += [("int8", sq, m, True) for sq in (False, True)
                  for m in (8, 64)]


@pytest.mark.parametrize("fmt,save_q,m,hadamard", _LINEAR_CASES)
def test_train_qlinear_grads_match_jax(fmt, save_q, m, hadamard):
    """Value and x / weight / bias gradients of a loss through one
    quantized linear, both ``save_quantized_activations`` variants, the
    weight-only (8 rows) and quantized-matmul (64 rows) forwards, the
    "fast" grad-input route (every format here stores a rowwise operand)
    and Hadamard."""
    rng = np.random.default_rng(0)
    k, o = 256, 192
    w = rng.normal(size=(o, k)).astype(np.float32) / 16
    x = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    cot = rng.normal(size=(m, o)).astype(np.float32)
    qj = j_quantize_tensor(jnp.asarray(w), fmt, "linear",
                           use_quantized_matmul=True, use_hadamard=hadamard)
    tp = j_make_train_params({"w": qj})

    def loss(tp, x, b):
        y = j_train_qlinear(x, tp["w"], b, save_quantized_activations=save_q)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, yj), (gt, gx, gb) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True, allow_int=True)(
        tp, jnp.asarray(x), jnp.asarray(b))

    tw = TrainQTensor(_port_qt(qj), grad_carrier((o, k), "cpu"))
    xt = torch.tensor(x, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    y = train_qlinear(xt, tw, bt, save_quantized_activations=save_q)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert _rel(y.float().detach(), np.asarray(yj, np.float32)) <= 2 ** -7
    for got, want in ((xt.grad, gx), (tw.delta.grad, gt["w"].delta),
                      (bt.grad, gb)):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), want) <= 1e-5


def test_grad_carrier_is_four_bytes():
    d = grad_carrier((3072, 15360), "cpu")
    assert d.is_leaf and d.requires_grad and tuple(d.shape) == (3072, 15360)
    assert d.stride() == (0, 0)
    assert d.untyped_storage().nbytes() == 4


def test_qlinear_dispatches_trainable_weights():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(40, 128)).astype(np.float32))
    qt = T.quantize_tensor(w, "int8", use_quantized_matmul=True)
    tw = TrainQTensor(qt, grad_carrier((64, 128), "cpu"))
    assert torch.equal(T.qlinear(x, tw), train_qlinear(x, tw))
    dw = DynamicTensor(w.clone().requires_grad_(), "int8")
    assert torch.equal(T.qlinear(x, dw), dynamic_qlinear(x, dw))


@pytest.mark.parametrize("fmt", ["int8", "uint8", "float8_e4m3fn",
                                 "bfloat16"])
def test_dynamic_qlinear_matches_jax(fmt):
    """The dynamic-only linear (weights full precision): value and
    gradients.  Same quantized operands and exact integer sums: 1e-5 of
    the largest gradient entry; the forward within one bf16 ulp."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(96, 160)).astype(np.float32)
    x = rng.normal(size=(48, 160)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    cot = rng.normal(size=(48, 96)).astype(np.float32)

    def loss(w, x, b):
        y = j_dynamic_qlinear(x, JDynamicTensor(w, fmt), b)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, yj), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                        has_aux=True)(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(b))
    wt, xt, bt = (torch.tensor(a, requires_grad=True) for a in (w, x, b))
    y = dynamic_qlinear(xt, DynamicTensor(wt, fmt), bt)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert _rel(y.float().detach(), np.asarray(yj, np.float32)) <= 2 ** -7
    for got, want in zip((wt.grad, xt.grad, bt.grad), grads):
        assert _rel(got.numpy(), want) <= 1e-5


# ---------------------------------------------------------------------------
# conversion, weight updates, carrying the JAX state across
# ---------------------------------------------------------------------------

def _small_tree(seed=3):
    rng = np.random.default_rng(seed)
    return {"lin": {"weight": rng.normal(size=(128, 256)).astype(np.float32),
                    "bias": rng.normal(size=(128,)).astype(np.float32)},
            "svd": {"weight": rng.normal(size=(96, 256)).astype(np.float32)},
            "norm": {"weight": np.ones((256,), np.float32)}}


def test_convert_model_to_training_round_trip():
    """SVD factors baked back in (as the JAX package requantizes them), a
    gradient carrier on every QTensor, floating leaves trainable; back to
    inference gives the QTensors."""
    tree = _small_tree()
    jq = {"lin": {"weight": j_quantize_tensor(
              jnp.asarray(tree["lin"]["weight"]), "int8", "linear",
              use_quantized_matmul=True),
                  "bias": jnp.asarray(tree["lin"]["bias"])},
          "svd": {"weight": j_quantize_tensor(
              jnp.asarray(tree["svd"]["weight"]), "uint4", "linear",
              use_svd=True, svd_rank=8)},
          "norm": {"weight": jnp.asarray(tree["norm"]["weight"])}}
    jt = j_convert(jq)
    port = {"lin": {"weight": _port_qt(jq["lin"]["weight"]),
                    "bias": torch.from_numpy(tree["lin"]["bias"])},
            "svd": {"weight": _port_qt(jq["svd"]["weight"])},
            "norm": {"weight": torch.from_numpy(tree["norm"]["weight"])}}
    tt = convert_model_to_training(port)
    for key in ("lin", "svd"):
        got, want = tt[key]["weight"], jt[key]["weight"]
        assert isinstance(got, TrainQTensor)
        assert got.qt.meta.svd_rank == want.qt.meta.svd_rank == 0
        assert got.qt.svd_up is None
        assert got.delta.requires_grad and got.delta.stride() == (0, 0)
        codes = got.qt.qdata.numpy().astype(np.int32)
        ref = np.asarray(want.qt.qdata).astype(np.int32)
        # dequantize + SVD product in another fp32 order: a rare code moves
        # a step (none at all for the int8 layer, which has no SVD)
        assert (codes != ref).mean() <= 1e-3
        assert np.abs(codes - ref).max() <= 1
    assert tt["norm"]["weight"].requires_grad
    back = convert_training_model_to_inference(tt)
    assert isinstance(back["lin"]["weight"], T.QTensor)
    assert not back["lin"]["bias"].requires_grad


def test_apply_weight_updates_matches_jax():
    tree = _small_tree(4)
    rng = np.random.default_rng(5)
    qj = j_quantize_tensor(jnp.asarray(tree["lin"]["weight"]), "int8",
                           "linear", use_quantized_matmul=True)
    upd = rng.normal(size=(128, 256)).astype(np.float32) * 0.05
    bupd = rng.normal(size=(128,)).astype(np.float32)
    jp = j_apply_weight_updates(
        {"w": j_make_train_params({"w": qj})["w"],
         "b": jnp.asarray(tree["lin"]["bias"])},
        {"w": jnp.asarray(upd), "b": jnp.asarray(bupd)})
    tp = apply_weight_updates(
        {"w": TrainQTensor(_port_qt(qj), grad_carrier((128, 256), "cpu")),
         "b": torch.from_numpy(tree["lin"]["bias"])},
        {"w": torch.from_numpy(upd), "b": torch.from_numpy(bupd)})
    assert isinstance(tp["w"], T.QTensor)
    np.testing.assert_array_equal(tp["w"].qdata.numpy(),
                                  np.asarray(jp["w"].qdata))
    np.testing.assert_array_equal(tp["w"].scale.numpy(),
                                  np.asarray(jp["w"].scale))
    np.testing.assert_array_equal(tp["b"].numpy(), np.asarray(jp["b"]))


def test_training_state_from_numpy():
    """A JAX training tree and AdamW state carried across: the same codes,
    a fresh carrier, the same moment codes and scales, Kahan and step."""
    tree = _small_tree(6)
    qj = j_quantize_tensor(jnp.asarray(tree["lin"]["weight"]), "int8",
                           "linear", use_quantized_matmul=True)
    jt = j_make_train_params({"w": qj,
                              "b": jnp.asarray(tree["lin"]["bias"])})
    opt = j_adamw(lr=1e-3, stochastic_rounding=False)
    grads = {"w": jnp.asarray(np.random.default_rng(7).normal(
        size=(128, 256)).astype(np.float32)), "b": jnp.ones((128,))}
    jt2, st = opt.update(grads, opt.init(jt), jt)
    tp = train_params_from_numpy(jt2, "cpu")
    assert isinstance(tp["w"], TrainQTensor) and tp["b"].requires_grad
    np.testing.assert_array_equal(tp["w"].qt.qdata.numpy(),
                                  np.asarray(jt2["w"].qt.qdata))
    ts = opt_state_from_numpy(st, "cpu")
    assert ts["step"] == 1
    jflat = st["per_param"]
    assert len(ts["per_param"]) == len(jflat) == 2
    for got, want in zip(ts["per_param"], jflat):
        assert set(got) == set(want)
        for key in got:
            if isinstance(got[key], BufferQ):
                np.testing.assert_array_equal(got[key].qdata.numpy(),
                                              np.asarray(want[key].qdata))
                assert got[key].shape == want[key].shape
            else:
                np.testing.assert_array_equal(
                    got[key].float().numpy(),
                    np.asarray(want[key]).astype(np.float32))


# ---------------------------------------------------------------------------
# attention's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 40])
def test_trainable_attention_grad_matches_jax_xla(n):
    """The forward on the kernel route (N = 128) or the XLA route (N =
    40); the gradient against ``jax.grad`` of the JAX XLA route.  The port
    recomputes it with float64 products, JAX in fp32: 1e-4 of the largest
    gradient entry."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(1, 2, n, 64)).astype(np.float32)
               for _ in range(3))
    cot = rng.normal(size=(1, 2, n, 64)).astype(np.float32)

    def loss(q, k, v):
        out = jattn.quantized_attention(q, k, v, matmul_dtype=None)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = trainable_attention(*ts, matmul_dtype=None)
    ref = jattn.quantized_attention(*map(jnp.asarray, (q, k, v)),
                                    matmul_dtype=None)
    assert _rel(out.detach().numpy(), ref) <= 1e-2  # bf16 P on the kernel
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(ts, want):
        assert _rel(t.grad.numpy(), g) <= 1e-4


def test_model_attention_is_trainable_only_under_autograd():
    from sdnq_tpu_torch.models.common import attention
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    out = attention(q, q, q)
    assert out.grad_fn is not None
    with torch.no_grad():
        assert attention(q, q, q).grad_fn is None


# ---------------------------------------------------------------------------
# FLUX_TINY training, end to end
# ---------------------------------------------------------------------------

def _dit_inputs(cfg, n_img=64, n_txt=16, seed=9):
    rng = np.random.default_rng(seed)
    return dict(
        img=rng.normal(size=(1, n_img, cfg.in_channels)).astype(np.float32),
        txt=rng.normal(size=(1, n_txt, cfg.txt_dim)).astype(np.float32),
        pooled=rng.normal(size=(1, cfg.vec_dim)).astype(np.float32),
        t=np.array([0.6], np.float32), guidance=np.array([3.5], np.float32),
        target=rng.normal(size=(1, n_img, cfg.in_channels)
                          ).astype(np.float32))


def test_flux_tiny_training_step_matches_jax():
    """int8 weights with the quantized matmul under the Flux skip keys,
    ``convert_model_to_training``, loss = mean((out - target)^2): the loss,
    every gradient, and one AdamW step with SR off (lr 1e-3, so that codes
    move)."""
    cfg = jdit.FLUX_TINY_CONFIG
    params = jdit.init_dit(jax.random.key(0), cfg)
    qp, _ = j_quantize_model(
        params, JQuantConfig(weights_dtype="int8", use_quantized_matmul=True),
        arch="FluxTransformer2DModel")
    jt = j_convert(qp)
    inp = _dit_inputs(cfg)
    ji = {k: jnp.asarray(v) for k, v in inp.items()}

    @jax.jit
    def loss_and_grad(tp):
        def loss_fn(tp):
            out = jdit.dit_forward(tp, ji["img"], ji["txt"], ji["t"],
                                   ji["pooled"], cfg, guidance=ji["guidance"])
            return jnp.mean((out.astype(jnp.float32) - ji["target"]) ** 2)
        return jax.value_and_grad(loss_fn, allow_int=True)(tp)

    jloss, jgrads = loss_and_grad(jt)
    jopt = j_adamw(lr=1e-3, quantize_state=True, stochastic_rounding=False)
    jt2, _ = jax.jit(jopt.update)(jgrads, jax.jit(jopt.init)(jt), jt)

    tp = train_params_from_numpy(jt, "cpu")
    ti = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = tdit.dit_forward(tp, ti["img"], ti["txt"], ti["t"], ti["pooled"],
                           tdit.FLUX_TINY_CONFIG, guidance=ti["guidance"],
                           device="cpu")
    loss = ((out.float() - ti["target"]) ** 2).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 5e-4 * float(jloss)

    is_j = lambda x: isinstance(x, (JTrainQTensor, JQTensor))  # noqa: E731
    jflat = jax.tree_util.tree_leaves(jgrads, is_leaf=is_j)
    tflat = tree_leaves(extract_weight_grads(tp),
                        is_leaf=lambda x: isinstance(x, TrainQTensor))
    assert len(jflat) == len(tflat) > 50
    n_q = 0
    for want, got in zip(jflat, tflat):
        if isinstance(want, JTrainQTensor):
            want, n_q = want.delta, n_q + 1
        assert got is not None and tuple(got.shape) == tuple(want.shape)
        assert _rel(got.float().numpy(), want) <= 8e-2
    assert n_q > 30

    opt = adamw(lr=1e-3, quantize_state=True, stochastic_rounding=False)
    tp, state = opt.update(None, opt.init(tp), tp)
    assert state["step"] == 1
    is_t = lambda x: isinstance(x, TrainQTensor)  # noqa: E731
    diff = moved = total = 0
    for want, got, old in zip(
            jax.tree_util.tree_leaves(jt2, is_leaf=is_j),
            tree_leaves(tp, is_leaf=is_t),
            jax.tree_util.tree_leaves(jt, is_leaf=is_j)):
        if isinstance(want, JTrainQTensor):
            new = got.qt.qdata.numpy().astype(np.int32)
            ref = np.asarray(want.qt.qdata).astype(np.int32)
            diff += int((new != ref).sum())
            moved += int((new != np.asarray(old.qt.qdata)).sum())
            total += new.size
            step = np.asarray(want.qt.scale).reshape(-1, 1)
            wv = new * got.qt.scale.numpy().reshape(-1, 1)
            # in value: AdamW steps apart by up to 2·lr (10% more for the
            # 8-bit moments' rounding), and one rounding each
            assert (np.abs(wv - ref * step) <= 2.2e-3 + 1.01 * step).all()
    assert moved > 0.01 * total
    assert diff <= 0.02 * total


# ---------------------------------------------------------------------------
# the loop and checkpointing
# ---------------------------------------------------------------------------

def test_fit_skips_non_finite_steps(tmp_path):
    """A bad loss skips the step's in-place update and drops its gradient:
    the parameter keeps its value, as the JAX loop keeps its pre-step
    state, and the next step's gradient is its own.  With a ``ckpt_dir``
    the loop saves, prunes and resumes from the newest step."""
    seen = []
    param = torch.zeros(3, requires_grad=True)

    def step(p, gen):
        assert gen.device.type == "cpu"
        i = len(seen)
        seen.append(i)
        loss = (p * (float("nan") if i in (1, 2) else 1.0)).sum()
        loss.backward()

        def apply():
            with torch.no_grad():
                p.sub_(p.grad)
            p.grad = None
            return p
        return loss, apply

    metrics = []
    out = fit(step, param, 5, params={"w": param}, device="cpu",
              on_metrics=lambda **kw: metrics.append(kw))
    assert out is param and torch.equal(param.detach(), torch.full((3,), -3.))
    assert param.grad is None
    assert len(seen) == 5 and len(metrics) == 3
    with pytest.raises(FloatingPointError):
        fit(lambda s, g: (torch.tensor(float("inf")), lambda: s), 0, 10,
            device="cpu", max_bad_steps=3)

    def plain(p, gen):
        loss = (p * 2.0).sum()
        loss.backward()

        def apply():
            with torch.no_grad():
                p.sub_(p.grad)
            p.grad = None
            return p
        return loss, apply

    ckpt = str(tmp_path / "ckpt")
    first = torch.zeros(3, requires_grad=True)
    out = fit(plain, first, 2, device="cpu", ckpt_dir=ckpt, save_every=1,
              keep=1)
    assert os.listdir(ckpt) == ["step_2"]
    assert torch.equal(out.detach(), torch.full((3,), -4.))
    # a new run resumes from step_2 into a fresh leaf and takes step 3
    second = torch.zeros(3, requires_grad=True)
    out = fit(plain, second, 3, device="cpu", ckpt_dir=ckpt, save_every=1,
              keep=1)
    assert torch.equal(out.detach(), torch.full((3,), -6.))
    assert out.requires_grad and torch.equal(second.detach(), torch.zeros(3))
    assert os.listdir(ckpt) == ["step_3"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the card is the default
            fit(step, param, 1)


def test_checkpoint_block_gives_the_same_gradients():
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.normal(size=(96, 128)).astype(np.float32))
    x0 = torch.from_numpy(rng.normal(size=(48, 128)).astype(np.float32))
    tw = make_train_params({"w": T.quantize_tensor(
        w, "int8", use_quantized_matmul=True)})["w"]

    def block(x):
        return torch.nn.functional.gelu(train_qlinear(x, tw)).float() @ \
            torch.ones(96, 8)

    grads = []
    for fn in (block, checkpoint_block(block),
               checkpoint_block(block, dots_saveable_policy())):
        x = x0.clone().requires_grad_()
        fn(x).square().sum().backward()
        grads.append((x.grad.clone(), tw.delta.grad.clone()))
        tw.delta.grad = None
    for g in grads[1:]:
        assert torch.equal(g[0], grads[0][0])
        assert torch.equal(g[1], grads[0][1])
