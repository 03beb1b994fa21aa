"""Training checkpoints (``io.checkpoint``) and ``fit``'s save, prune and
resume, on the CPU.

A training state of every leaf kind (TrainQTensors, AdamW's 8-bit moment
BufferQs and bf16 Kahan buffers after a step, floating parameters that
require grad, the step) round-trips bit-equal.  ``fit`` resumed from its
newest ``step_N``, with the caller's generator set to its state at that
step, ends bit-equal to the uninterrupted run, stochastic rounding
included.  ``latest_checkpoint_step`` agrees with the JAX function on one
directory listing."""

import os

import numpy as np
import pytest
import torch

import sdnq_tpu_torch as T
from sdnq_tpu.train.loop import latest_checkpoint_step as j_latest
from sdnq_tpu_torch.io import restore_checkpoint, save_checkpoint
from sdnq_tpu_torch.optim import adamw
from sdnq_tpu_torch.optim.base import BufferQ
from sdnq_tpu_torch.tensor import QTensor
from sdnq_tpu_torch.train import (
    TrainQTensor, convert_model_to_training, fit, latest_checkpoint_step,
    train_qlinear,
)
from sdnq_tpu_torch.tree import tree_leaves


def _model(seed=0):
    """Two int8 linears with the quantized matmul, a bias and a norm
    weight, made trainable."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))
    params = {"blocks": [{"fc": {"weight": w(128, 256, scale=0.06),
                                 "bias": w(128, scale=0.1)}},
                         {"fc": {"weight": w(64, 128, scale=0.09)}}],
              "norm": {"weight": 1.0 + w(256, scale=0.1)}}
    qp, _ = T.quantize_model(params, T.QuantConfig(
        weights_dtype="int8", use_quantized_matmul=True,
        minimum_allowed_numel=1024), device="cpu")
    return convert_model_to_training(qp)


def _loss(tp, x, y):
    h = x * tp["norm"]["weight"]
    h = train_qlinear(h, tp["blocks"][0]["fc"]["weight"],
                      tp["blocks"][0]["fc"]["bias"])
    h = train_qlinear(torch.nn.functional.gelu(h),
                      tp["blocks"][1]["fc"]["weight"])
    return ((h.float() - y) ** 2).mean()


def _batch(step):
    g = torch.Generator().manual_seed(100 + step)
    return torch.randn(32, 256, generator=g), torch.randn(32, 64, generator=g)


def _state():
    tp = _model()
    opt = adamw(lr=1e-2, quantize_state=True, stochastic_rounding=True)
    return {"params": tp, "opt": opt.init(tp)}, opt


def _step_fn(opt):
    def step(state, gen):
        x, y = _batch(state["opt"]["step"])
        loss = _loss(state["params"], x, y)
        loss.backward()

        def apply():
            opt.update(None, state["opt"], state["params"], generator=gen)
            return state
        return loss, apply
    return step


def _is_q(x):
    return isinstance(x, (QTensor, TrainQTensor, BufferQ))


def _assert_bit_equal(got, want):
    """Every leaf of ``got`` equal in kind, dtype, shape and bits to the
    same leaf of ``want``; tensors require grad alike."""
    fg = tree_leaves(got, is_leaf=_is_q)
    fw = tree_leaves(want, is_leaf=_is_q)
    assert len(fg) == len(fw)
    for g, w in zip(fg, fw):
        assert type(g) is type(w)
        if isinstance(w, TrainQTensor):
            assert g.delta.shape == w.delta.shape and g.delta.requires_grad
            g, w = g.qt, w.qt
        if isinstance(w, QTensor):
            assert g.meta == w.meta
            pairs = [(getattr(g, f), getattr(w, f)) for f in (
                "qdata", "scale", "zero_point", "svd_up", "svd_down")]
        elif isinstance(w, BufferQ):
            assert (g.shape, g.unsigned) == (w.shape, w.unsigned)
            pairs = [(g.qdata, w.qdata), (g.scale, w.scale)]
        elif isinstance(w, torch.Tensor):
            assert g.requires_grad == w.requires_grad
            pairs = [(g, w)]
        else:
            assert g == w and type(g) is type(w)
            pairs = []
        for a, b in pairs:
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a.detach(), b.detach())


def test_training_state_round_trips_bit_equal(tmp_path):
    state, opt = _state()
    step = _step_fn(opt)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state = step(state, gen)[1]()
    leaves = tree_leaves(state, is_leaf=_is_q)
    assert any(isinstance(x, BufferQ) for x in leaves)
    per = state["opt"]["per_param"]
    assert any(st is not None and "kahan" in st for st in per)
    assert state["opt"]["step"] == 2
    state["extra"] = (None, 3.5, "tag", True)
    save_checkpoint(str(tmp_path / "ck"), state)
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    fresh, _ = _state()
    fresh["extra"] = (None, 0.0, "", False)
    got = restore_checkpoint(str(tmp_path / "ck"), fresh)
    _assert_bit_equal(got, state)
    # saving again replaces the directory
    save_checkpoint(str(tmp_path / "ck"), got)
    _assert_bit_equal(restore_checkpoint(str(tmp_path / "ck"), fresh), state)


def test_restore_refuses_another_structure(tmp_path):
    state, _ = _state()
    save_checkpoint(str(tmp_path / "ck"), state)
    wrong = dict(state, params=dict(state["params"], norm={"weight": None}))
    with pytest.raises(ValueError, match="norm.weight"):
        restore_checkpoint(str(tmp_path / "ck"), wrong)
    fewer = dict(state, params=dict(
        state["params"], blocks=state["params"]["blocks"][:1]))
    with pytest.raises(ValueError, match="params.blocks"):
        restore_checkpoint(str(tmp_path / "ck"), fewer)
    with pytest.raises(TypeError, match="cannot store"):
        save_checkpoint(str(tmp_path / "x"), {"f": object()})


def test_fit_saves_prunes_and_resumes_bit_equal(tmp_path):
    ckpt = str(tmp_path / "run")
    state, opt = _state()
    gen = torch.Generator().manual_seed(7)
    gen_at = {}
    losses = []

    def metrics(step, loss, step_time):
        losses.append(loss)
        gen_at[step + 1] = gen.get_state()

    full = fit(_step_fn(opt), state, 5, generator=gen, device="cpu",
               ckpt_dir=ckpt, save_every=2, keep=2, on_metrics=metrics)
    assert latest_checkpoint_step(ckpt) == 4
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_4"]

    # a later run picks up at step 4 with the generator as it was there
    fresh, opt2 = _state()
    gen2 = torch.Generator().manual_seed(0)
    gen2.set_state(gen_at[4])
    resumed_losses = []
    resumed = fit(_step_fn(opt2), fresh, 5, generator=gen2, device="cpu",
                  ckpt_dir=ckpt, save_every=2, keep=2,
                  on_metrics=lambda **kw: resumed_losses.append(kw["loss"]))
    assert resumed_losses == losses[4:]
    assert resumed["opt"]["step"] == full["opt"]["step"] == 5
    _assert_bit_equal(resumed, full)
    # step_4's state is what the run held after its fourth step
    ref, opt3 = _state()
    gen3 = torch.Generator().manual_seed(7)
    ref = fit(_step_fn(opt3), ref, 4, generator=gen3, device="cpu")
    _assert_bit_equal(restore_checkpoint(os.path.join(ckpt, "step_4"),
                                         fresh), ref)


def test_latest_checkpoint_step_matches_jax(tmp_path):
    assert latest_checkpoint_step(str(tmp_path / "none")) is None
    assert j_latest(str(tmp_path / "none")) is None
    assert latest_checkpoint_step(str(tmp_path)) == j_latest(
        str(tmp_path)) is None
    for name in ("step_3", "step_12", "step_x", "step_", "other", "step_7"):
        os.makedirs(tmp_path / name)
    assert latest_checkpoint_step(str(tmp_path)) == j_latest(
        str(tmp_path)) == 12
