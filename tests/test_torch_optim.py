"""The port's quantized-state optimizers against the JAX package's, on the
CPU.

Each optimizer takes one update, stochastic rounding off, from the same
parameters and gradients (numpy seeds), in both packages: a TrainQTensor
(int8, its moments 8-bit BufferQs and a Kahan buffer), a floating matrix
large enough for quantized moments, and a small vector whose moments stay
fp32.  Both packages run the same fp32 operations, so the floating
parameter and the fp32 states agree to 1e-5 relative (the fp32 pow / rsqrt
of two libraries), and the codes of the quantized parameter and of the
moment buffers to within one code on at most 0.1% of the entries (a value
on a rounding boundary after those last-bit differences); the bf16 Kahan
buffers see the same flips (``_state_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnq_tpu import optim as jopt
from sdnq_tpu.optim import base as jbase
from sdnq_tpu.tensor import quantize_tensor as j_quantize_tensor
from sdnq_tpu.train import make_train_params as j_make_train_params

from sdnq_tpu_torch import optim as topt
from sdnq_tpu_torch.convert import opt_state_from_numpy, \
    train_params_from_numpy
from sdnq_tpu_torch.optim import base as tbase
from sdnq_tpu_torch.train import TrainQTensor


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64, 512)).astype(np.float32) / 20
    qt = j_quantize_tensor(jnp.asarray(w), "int8", "linear",
                           use_quantized_matmul=True)
    params = j_make_train_params({
        "q": qt, "f": jnp.asarray(rng.normal(size=(64, 256))
                                  .astype(np.float32)),
        "v": jnp.asarray(rng.normal(size=(32,)).astype(np.float32))})
    grads = {"q": rng.normal(size=(64, 512)).astype(np.float32),
             "f": rng.normal(size=(64, 256)).astype(np.float32),
             "v": rng.normal(size=(32,)).astype(np.float32)}
    grads["q"][0, :3] = np.nan  # scrubbed to zero by both
    return params, grads


def _codes_close(got, want, share=1e-3):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    diff = got != want
    assert diff.mean() <= share, diff.mean()
    assert np.abs(got - want).max() <= 1


def _state_close(got, want, step=None):
    """``step``: the quantized parameter's largest code step, for its bf16
    Kahan buffer: the rounding error of the new codes, stored in bf16, is
    within one bf16 ulp (2^-7 relative) except where a code differs, and
    there within a code step."""
    if step is not None:
        got = got.float().numpy()
        want = np.asarray(want).astype(np.float32)
        off = np.abs(got - want) > 2 ** -7 * np.abs(want)
        assert off.mean() <= 5e-3 and (np.abs(got - want) <= step).all()
        return
    if isinstance(want, jbase.BufferQ):
        assert isinstance(got, tbase.BufferQ)
        assert got.shape == want.shape and got.unsigned == want.unsigned
        _codes_close(got.qdata.numpy(), want.qdata)
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=1e-6)
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-5, atol=1e-6 * float(
                                   np.abs(np.asarray(want, np.float32)).max()
                                   + 1e-30))


_OPTS = {
    "adamw": dict(lr=1e-3, weight_decay=0.01),
    "lion": dict(lr=1e-3, weight_decay=0.01),
    "adafactor": dict(lr=1e-3),
    "came": dict(lr=1e-3),
}


@pytest.mark.parametrize("name", sorted(_OPTS))
@pytest.mark.parametrize("grads_from", ["tree", "params"])
def test_one_update_matches_jax(name, grads_from):
    """``grads_from="params"``: the port reads each ``.grad`` (and clears
    it) instead of a gradient tree."""
    kw = dict(_OPTS[name], stochastic_rounding=False)
    jp, grads = _tree()
    jo = getattr(jopt, name)(**kw)
    jst = jo.init(jp)
    jp2, jst2 = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                          jst, jp)

    tp = train_params_from_numpy(jp, "cpu")
    to = getattr(topt, name)(**kw)
    tst = to.init(tp)
    # the init state equals the JAX package's
    for got, want in zip(tst["per_param"], jst["per_param"]):
        assert set(got) == set(want)
        for k in got:
            _state_close(got[k], want[k])
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    if grads_from == "tree":
        tp2, tst2 = to.update(tg, tst, tp)
    else:
        tp["q"].delta.grad = tg["q"]
        tp["f"].grad, tp["v"].grad = tg["f"], tg["v"]
        tp2, tst2 = to.update(None, tst, tp)
        assert tp["q"].delta.grad is None and tp["f"].grad is None
    assert tp2 is tp and tst2 is tst and tst2["step"] == 1
    assert isinstance(tp2["q"], TrainQTensor)
    _codes_close(tp2["q"].qt.qdata.numpy(), jp2["q"].qt.qdata)
    np.testing.assert_allclose(tp2["q"].qt.scale.numpy(),
                               np.asarray(jp2["q"].qt.scale), rtol=1e-6)
    for k in ("f", "v"):
        np.testing.assert_allclose(tp2[k].detach().numpy(),
                                   np.asarray(jp2[k]), rtol=1e-5, atol=1e-6)
    step = float(np.asarray(jp2["q"].qt.scale).max())
    for got, want in zip(tst2["per_param"], jst2["per_param"]):
        assert set(got) == set(want)
        for k in got:
            _state_close(got[k], want[k], step if k == "kahan" else None)
    # the update moved codes
    assert (tp2["q"].qt.qdata.numpy() != np.asarray(jp["q"].qt.qdata)).any()


def test_second_step_from_carried_state():
    """A JAX state after one step, carried across, then one more step in
    each package."""
    kw = dict(lr=1e-3, stochastic_rounding=False)
    jp, grads = _tree(1)
    jo = jopt.adamw(**kw)
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jp1, jst1 = jo.update(jg, jo.init(jp), jp)
    jp2, jst2 = jo.update(jg, jst1, jp1)
    tp = train_params_from_numpy(jp1, "cpu")
    tst = opt_state_from_numpy(jst1, "cpu")
    tp2, tst2 = topt.adamw(**kw).update(
        {k: torch.from_numpy(v) for k, v in grads.items()}, tst, tp)
    assert tst2["step"] == 2
    _codes_close(tp2["q"].qt.qdata.numpy(), jp2["q"].qt.qdata)
    _state_close(tst2["per_param"][1]["kahan"], jst2["per_param"][1]["kahan"],
                 float(np.asarray(jp2["q"].qt.scale).max()))


@pytest.mark.parametrize("unsigned", [False, True])
def test_quantize_buffer_codes_with_fed_in_bits(unsigned, monkeypatch):
    """Stochastic rounding with the same 32-bit rounding bits given to
    both packages: codes byte-equal, scales equal."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 512)).astype(np.float32)
    if unsigned:
        x = x ** 2
    x[3] = 0.0
    bits = rng.integers(0, 2 ** 32, size=(128, 256), dtype=np.uint64) \
        .astype(np.uint32)
    monkeypatch.setattr(jax.random, "bits",
                        lambda key, shape, dtype: jnp.asarray(bits))
    jb = jbase.quantize_buffer(jnp.asarray(x), rng=jax.random.key(0),
                               unsigned=unsigned)
    tb = tbase.quantize_buffer(torch.from_numpy(x), unsigned=unsigned,
                               sr_bits=torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(tb.qdata.numpy(), np.asarray(jb.qdata))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))
    np.testing.assert_array_equal(tbase.dequantize_buffer(tb).numpy(),
                                  np.asarray(jbase.dequantize_buffer(jb)))
    # round to nearest without bits
    jn = jbase.quantize_buffer(jnp.asarray(x), unsigned=unsigned)
    tn = tbase.quantize_buffer(torch.from_numpy(x), unsigned=unsigned)
    np.testing.assert_array_equal(tn.qdata.numpy(), np.asarray(jn.qdata))
    # drawn from a generator: codes within one of the nearest ones
    tg = tbase.quantize_buffer(torch.from_numpy(x), unsigned=unsigned,
                               generator=torch.Generator().manual_seed(0))
    d = tg.qdata.numpy().astype(int) - tn.qdata.numpy().astype(int)
    assert np.abs(d).max() <= 1 and (d != 0).any()


def test_zero_buffer_and_small_buffers():
    for unsigned in (False, True):
        z = tbase.zero_buffer((64, 512), "cpu", unsigned)
        q = tbase.quantize_buffer(torch.zeros(64, 512), unsigned=unsigned)
        assert torch.equal(z.qdata, q.qdata) and torch.equal(z.scale, q.scale)
    small = tbase.zero_buffer((32,), "cpu")
    assert isinstance(small, torch.Tensor) and small.shape == (32,)
    x = torch.randn(100, 3)  # not a whole number of groups: stays fp32
    assert tbase.quantize_buffer(x) is x


def test_update_helpers_match_jax():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(64, 48)).astype(np.float32)
    g[0, 0], g[1, 1] = np.nan, np.inf
    u = rng.normal(size=(64, 48)).astype(np.float32)
    for clip, scale in ((None, None), (0.5, 4.0)):
        np.testing.assert_allclose(
            tbase.scrub_grad(torch.from_numpy(g), clip, scale).numpy(),
            np.asarray(jbase.scrub_grad(jnp.asarray(g), clip, scale)),
            rtol=1e-6)
    gs = np.nan_to_num(g)
    np.testing.assert_allclose(
        tbase.cautious_mask(torch.from_numpy(u), torch.from_numpy(gs)).numpy(),
        np.asarray(jbase.cautious_mask(jnp.asarray(u), jnp.asarray(gs))),
        rtol=1e-6)
    pn = np.float32(0.7)
    for mode in ("none", "rms", "rms_clip", "clip", "relative", "rms_scaled",
                 "rms_clip_scaled", "muon"):
        np.testing.assert_allclose(
            tbase.apply_norm_to_update(torch.from_numpy(u), torch.tensor(pn),
                                       mode).numpy(),
            np.asarray(jbase.apply_norm_to_update(jnp.asarray(u), pn, mode)),
            rtol=1e-6, err_msg=mode)


def test_offload_and_transfer_casts():
    params = {"a": torch.randn(64, 512), "b": torch.randn(8)}
    opt = topt.adamw(quantize_state=False)
    state = opt.init(params)
    # buffers off the card stay where they are
    assert topt.offload_opt_state(state) is state
    assert topt.fetch_opt_state(state, "cpu") is state
    cast = topt.cast_state_for_transfer(state)
    assert cast["per_param"][0]["m"].dtype == torch.bfloat16
    back = topt.cast_state_from_transfer(cast)
    assert back["per_param"][0]["m"].dtype == torch.float32
    qstate = topt.adamw().init(params)
    buf = qstate["per_param"][0]["m"]
    topt.cast_state_for_transfer(qstate)
    assert qstate["per_param"][0]["m"] is buf
    assert buf.scale.dtype == torch.float32
