"""Muon (``sdnq_tpu_torch.optim.muon``) against the JAX package's on the
same seeded numpy inputs, on the CPU.

Limits:
* ``zeropower_via_newtonschulz5`` with ``dtype=float32``: the same fp32
  products in another order, max |port - JAX| <= 1e-5 (classic: measured
  7e-7; Gram-NS: 1.3e-5 on a tall input after its five polynomial
  compositions, so 3e-5 there, twice the reading) of entries up to 0.5;
* in bf16 (the default) one-ulp differences between XLA's and torch's bf16
  rounding points grow over the steps (measured 0.043 of entries up to
  0.45): orthogonality as ``tests/test_training.py`` holds it (|O Oᵀ - I|
  < 0.35 off the diagonal) and max |port - JAX| < 0.1;
* quantized NS (int8 codes, B4's plain version): both packages quantize
  with the true division and sum the int8 products exactly; an fp32 ulp
  between their operands can move a code at a rounding tie by one step,
  which moves an output by at most one code step times its weights
  (``_flip_bound``): each product on JAX's own operands is held there;
  over the whole NS a code moved in an early step is carried through the
  later ones (measured 0.031 of entries up to 0.34), so the whole is held
  as bf16 is, its distance from orthogonal within 0.05 of JAX's;
* ``muon`` over 3 steps with NS in fp32 (both packages' NS patched to
  fp32), SR off: params within 1e-5 of their max, fp32 moment buffers
  within 1e-5 of theirs, plain and adaptive; with 8-bit state a moment
  code at a rounding tie moves by one step (measured on 0.07% of entries,
  3.2e-5 of max), and adaptive mode's o·rsqrt(v̂) magnifies an ulp where
  v̂ is small (0.07%, 6.4e-5): at most 0.5% of entries past 1e-5, all
  within 1e-3,
  the buffers within 32 of their own scale steps; the codes of a quantized
  parameter equal but for ties (at most 1% of codes, one step).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import sdnq_tpu_torch as T
from sdnq_tpu_torch.convert import opt_state_from_numpy
from sdnq_tpu_torch.optim import BufferQ, muon, zeropower_via_newtonschulz5

tmuon = importlib.import_module("sdnq_tpu_torch.optim.muon")


def _g(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jz():
    return importlib.import_module("sdnq_tpu.optim.muon")


@pytest.mark.parametrize("shape,gram,tol", [
    ((32, 48), False, 1e-5), ((48, 32), False, 1e-5), ((64, 64), False, 1e-5),
    ((32, 48), True, 1e-5), ((48, 32), True, 3e-5), ((64, 96), True, 3e-5)])
def test_newton_schulz_fp32_matches_jax(shape, gram, tol):
    import jax.numpy as jnp
    g = _g(shape, 0)
    want = np.asarray(_jz().zeropower_via_newtonschulz5(
        jnp.asarray(g), 5, use_gram_ns=gram, dtype=jnp.float32))
    got = zeropower_via_newtonschulz5(torch.from_numpy(g), 5,
                                      use_gram_ns=gram, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.abs(got.numpy() - want).max() <= tol


@pytest.mark.parametrize("gram", [False, True])
def test_newton_schulz_bf16_orthogonal(gram):
    import jax.numpy as jnp
    g = _g((64, 128), 4)
    got = zeropower_via_newtonschulz5(torch.from_numpy(g), 10,
                                      use_gram_ns=gram).numpy()
    want = np.asarray(_jz().zeropower_via_newtonschulz5(
        jnp.asarray(g), 10, use_gram_ns=gram))
    off = got @ got.T - np.eye(64)
    assert np.abs(off).max() < 0.35
    assert np.abs(got - want).max() < 0.1


def _flip_bound(a_abs_max, w_abs_sum_max):
    """One activation code moved by one step: (row amax / 127) times the
    largest |weight| row sum it meets."""
    return a_abs_max / 127.0 * w_abs_sum_max


@pytest.mark.parametrize("shape,gram", [((48, 80), False), ((80, 48), False),
                                        ((48, 80), True)])
def test_quantized_newton_schulz_matches_jax(monkeypatch, shape, gram):
    """Each quantized product on the operands JAX's NS gave its own: the
    port's within one moved code's bound (0 where no code sits at a tie);
    the whole NS, where a moved code in an early step is carried through
    the later ones, orthogonal and within the bf16 limit."""
    import jax.numpy as jnp
    jm = _jz()
    seen = []
    real = jm._make_mm

    def spy(use_q, dtype):
        mm = real(use_q, dtype)

        def rec(a, b):
            out = mm(a, b)
            seen.append((np.asarray(a), np.asarray(b), np.asarray(out)))
            return out
        return rec
    monkeypatch.setattr(jm, "_make_mm", spy)
    g = _g(shape, 2)
    want = np.asarray(jm.zeropower_via_newtonschulz5(
        jnp.asarray(g), 5, use_gram_ns=gram, use_quantized_matmul=True,
        dtype=jnp.float32))
    mm = tmuon._make_mm(True, torch.float32)
    for a, b, out in seen:
        got = mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        bound = _flip_bound(np.abs(a).max(), np.abs(b).sum(0).max())
        assert np.abs(got - out).max() <= bound, np.abs(got - out).max()
    got = zeropower_via_newtonschulz5(
        torch.from_numpy(g), 5, use_gram_ns=gram, use_quantized_matmul=True,
        dtype=torch.float32).numpy()
    if gram:   # int8 Gram-NS strays from orthogonal in both packages
        return
    o, w = (got, want) if shape[0] <= shape[1] else (got.T, want.T)
    eye = np.eye(min(shape))
    assert abs(np.abs(o @ o.T - eye).max()
               - np.abs(w @ w.T - eye).max()) < 0.05
    assert np.abs(got - want).max() < 0.1


def test_quantized_mm_counts_b4_and_raises_past_2_17(monkeypatch):
    """Each NS step is three B4 GEMMs (15 for the classic schedule), the
    second operand transposed to (N, K); a contraction past 2^17 (where an
    int32 sum of int8 products may no longer be exact, so B4 adds the
    int32 sums of its parts in int64) computes what the JAX package's
    ``_make_mm`` computes, within one moved code's bound (the name is
    kept from when the port raised there)."""
    import jax.numpy as jnp
    from sdnq_tpu_torch.kernels import scaled_mm as ks
    calls = []
    real = ks.scaled_mm

    def spy(a, b, *args, **kw):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ks, "scaled_mm", spy)
    zeropower_via_newtonschulz5(torch.from_numpy(_g((32, 64), 1)), 5,
                                use_quantized_matmul=True)
    assert len(calls) == 15
    assert calls[:3] == [((32, 64), (32, 64)), ((32, 32), (32, 32)),
                         ((32, 32), (64, 32))]
    k = (1 << 17) + 128
    a, b = _g((4, k), 5), _g((k, 4), 6)
    want = np.asarray(_jz()._make_mm(True, jnp.float32)(jnp.asarray(a),
                                                         jnp.asarray(b)))
    got = tmuon._make_mm(True, torch.float32)(torch.from_numpy(a),
                                               torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (4, 4)
    assert np.abs(got - want).max() <= _flip_bound(
        np.abs(a).max(), np.abs(b).sum(0).max())


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(64, 96)).astype(np.float32) * 0.1,
        "tall": rng.normal(size=(96, 32)).astype(np.float32) * 0.1,
        "stack": rng.normal(size=(4, 16, 24)).astype(np.float32) * 0.1,
        "bias": rng.normal(size=(32,)).astype(np.float32) * 0.1,
        "small": rng.normal(size=(8, 12)).astype(np.float32) * 0.1,
    }


def _grads(step, seed=10):
    p = _params(seed + step)
    return {k: v * 3.0 for k, v in p.items()}


def _fp32_ns(monkeypatch):
    """Both packages' Muon run NS in fp32."""
    import jax.numpy as jnp
    jm = _jz()
    monkeypatch.setattr(jm, "zeropower_via_newtonschulz5", functools.partial(
        jm.zeropower_via_newtonschulz5, dtype=jnp.float32))
    monkeypatch.setattr(tmuon, "zeropower_via_newtonschulz5",
                        functools.partial(tmuon.zeropower_via_newtonschulz5,
                                          dtype=torch.float32))


def _run_both(kw, steps=3, carry_after=None):
    """JAX's and the port's params and state after ``steps`` updates of
    the same gradients.  ``carry_after``: the port starts from JAX's state
    (``opt_state_from_numpy``) after that many steps."""
    import jax.numpy as jnp
    jm = _jz()
    jopt, topt = jm.muon(**kw), muon(**kw)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = {k: torch.from_numpy(v) for k, v in _params().items()}
    jst, tst = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _grads(i)
        jp, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        if carry_after is not None and i < carry_after:
            if i == carry_after - 1:
                tst = opt_state_from_numpy(jst, "cpu")
                tp = {k: torch.from_numpy(np.asarray(v)) for k, v in
                      jp.items()}
            continue
        tp, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              tst, tp)
    return jp, jst, tp, tst


def _check(jp, jst, tp, tst, ties=0.0):
    """``ties``: the share of a parameter's entries that may differ by
    more than 1e-5 of its max (up to 1e-3 of it), where an 8-bit moment
    code at a rounding tie moved."""
    for k in jp:
        want = np.asarray(jp[k])
        d = np.abs(tp[k].numpy() - want) / np.abs(want).max()
        assert (d > 1e-5).mean() <= ties and d.max() <= (
            1e-3 if ties else 1e-5), (k, (d > 1e-5).mean(), d.max())
    assert int(tst["step"]) == int(jst["step"])
    names = sorted(jp)
    for k, got, want in zip(names, tst["per_param"], jst["per_param"]):
        assert set(got) == set(want), k
        assert got["muon"] == bool(want["muon"]), k
        for b in ("m", "v"):
            if b not in got:
                continue
            g, w = got[b], want[b]
            if isinstance(g, BufferQ):
                from sdnq_tpu.optim.base import dequantize_buffer as jdq
                gv = T.optim.dequantize_buffer(g).numpy()
                wv = np.asarray(jdq(w))
                # 8-bit codes: the same but for ties, one code step
                scale = g.scale.numpy().max()
                assert np.abs(gv - wv).max() <= 32 * scale, (k, b)
            else:
                wv = np.asarray(w)
                np.testing.assert_allclose(
                    g.numpy(), wv, rtol=0, atol=1e-5 * max(
                        np.abs(wv).max(), 1e-30))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("quantize_state", [False, True])
def test_muon_three_steps_match_jax(monkeypatch, adaptive, quantize_state):
    _fp32_ns(monkeypatch)
    kw = dict(lr=2e-2, adaptive=adaptive, quantize_state=quantize_state,
              stochastic_rounding=False, weight_decay=0.01)
    _check(*_run_both(kw),
           ties=0.005 if quantize_state or adaptive else 0.0)


def test_muon_adamw_branch_and_shapes(monkeypatch):
    """ndim <= 1 and small leaves take the AdamW update scaled by
    adamw_lr / lr; a stacked (L, O, I) leaf is one (L, O·I) NS matrix (the
    JAX package's quirk, ROADMAP "Known defects")."""
    _fp32_ns(monkeypatch)
    kw = dict(lr=1e-2, adamw_lr=3e-3, quantize_state=False,
              stochastic_rounding=False)
    jp, jst, tp, tst = _run_both(kw, steps=1)
    names = sorted(jp)
    flags = {k: st["muon"] for k, st in zip(names, tst["per_param"])}
    assert flags == {"bias": False, "small": False, "stack": True,
                     "tall": True, "w": True}
    # the AdamW branch's first step: (adamw_lr / lr) * sign-like update
    g = _grads(0)["bias"]
    step = 1e-2 * (3e-3 / 1e-2) * g / (np.abs(g) + 1e-8)
    np.testing.assert_allclose(tp["bias"].numpy(), _params()["bias"] - step,
                               rtol=0, atol=1e-6)
    _check(jp, jst, tp, tst)


@pytest.mark.parametrize("adaptive", [False, True])
def test_muon_resumes_from_jax_state(monkeypatch, adaptive):
    """One JAX step, the state carried (``opt_state_from_numpy``, 8-bit
    buffers and the "muon" flags), two more in the port: as three JAX
    steps."""
    _fp32_ns(monkeypatch)
    kw = dict(lr=2e-2, adaptive=adaptive, quantize_state=True,
              stochastic_rounding=False)
    jp, jst, tp, tst = _run_both(kw, steps=3, carry_after=1)
    assert all(isinstance(st["muon"], bool) for st in tst["per_param"])
    _check(jp, jst, tp, tst, ties=0.005)


def test_muon_quantized_param_and_ns(monkeypatch):
    """A quantized (int8) parameter with Kahan under quantized NS: the
    codes equal JAX's but for ties (at most 1% of codes, one step)."""
    import jax.numpy as jnp
    import sdnq_tpu as J
    from sdnq_tpu_torch.convert import qtensor_from_numpy
    import dataclasses
    _fp32_ns(monkeypatch)
    w = _params()["w"]
    jq = J.quantize_tensor(jnp.asarray(w), "int8")
    fields = {k: None if getattr(jq, k) is None else np.asarray(
        getattr(jq, k)) for k in ("qdata", "scale", "zero_point", "svd_up",
                                   "svd_down")}
    tq = qtensor_from_numpy(fields, dataclasses.asdict(jq.meta), "cpu")
    kw = dict(lr=2e-2, quantize_state=False, stochastic_rounding=False,
              use_quantized_matmul_ns=True)
    jopt, topt = _jz().muon(**kw), muon(**kw)
    jp, tp = {"w": jq}, {"w": tq}
    jst, tst = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = _grads(i)["w"]
        jp, jst = jopt.update({"w": jnp.asarray(g)}, jst, jp)
        tp, tst = topt.update({"w": torch.from_numpy(g)}, tst, tp)
    d = np.abs(tp["w"].qdata.numpy().astype(int)
               - np.asarray(jp["w"].qdata).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
