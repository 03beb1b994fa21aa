"""The slice end to end on the CPU: ``qlinear`` on both routes, the whole
``dit_forward`` at FLUX_TINY_CONFIG, and a 2-step ``flux_denoise``, each
against the JAX package on the same numpy inputs and weights.

Tolerances:

* ``qlinear`` and the weight-only model: the same integer codes and the
  same fp32 operations in another order, so rtol 1e-5 (1e-4 over a whole
  model, where sums of thousands of terms compound).
* The model with the quantized matmul: activation codes are rounded per
  row, and the timestep embedding's cos/sin of arguments up to 1000 rad
  differ by about 1e-5 between XLA and torch; such a difference moves
  codes that sit at a rounding tie by one step, and each moved code moves
  its output by one quantization step.  Measured on this config: max error
  about 1.3% of max |out| after 6 blocks, and the two JAX backends (jit
  and eager) differ by 2e-4 alone.  Bound: max 4e-2 and mean 4e-3 of
  max |out|, with the weight-only model above as the tight check."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu.models import dit as jdit
from sdnq_tpu.pipeline.schedulers import FlowMatchScheduler as JFlow
from sdnq_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from sdnq_tpu_torch.models import dit as tdit
from sdnq_tpu_torch.pipeline import FlowMatchScheduler as TFlow, flux_denoise

J_LAYERS = importlib.import_module("sdnq_tpu.layers")
CFG_J = jdit.FLUX_TINY_CONFIG
CFG_T = tdit.FLUX_TINY_CONFIG
B, HW, TXT = 2, (8, 8), 16
QC = dict(weights_dtype="int8", use_quantized_matmul=True,
          dequant_dtype="float32")


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry_qtensors(tree):
    """JAX params with QTensor leaves -> port params, same quantized bytes."""
    if isinstance(tree, J.QTensor):
        fields = {k: (None if getattr(tree, k) is None
                      else np.asarray(getattr(tree, k)))
                  for k in ("qdata", "scale", "zero_point", "svd_up",
                            "svd_down")}
        return qtensor_from_numpy(fields, dataclasses.asdict(tree.meta),
                                  device="cpu")
    if isinstance(tree, dict):
        return {k: _carry_qtensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_carry_qtensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def model():
    params = jdit.init_dit(jax.random.key(0), CFG_J)
    np_params = _to_np(params)
    rng = np.random.default_rng(0)
    inputs = dict(
        img=rng.normal(size=(B, HW[0] * HW[1], CFG_J.in_channels)),
        txt=rng.normal(size=(B, TXT, CFG_J.txt_dim)),
        t=rng.uniform(0, 1, (B,)), pooled=rng.normal(size=(B, CFG_J.vec_dim)),
        g=np.full((B,), 3.5))
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    freqs = jdit.make_rope_freqs(CFG_J, TXT, HW)
    fwd = jax.jit(lambda p, img, t: jdit.dit_forward(
        p, img, jnp.asarray(inputs["txt"]), t, jnp.asarray(inputs["pooled"]),
        CFG_J, guidance=jnp.asarray(inputs["g"]), freqs=freqs))
    return params, np_params, inputs, fwd


def _port_forward(tparams, inputs, img=None, t=None):
    f = lambda k: torch.from_numpy(inputs[k])  # noqa: E731
    return tdit.dit_forward(
        tparams, f("img") if img is None else img, f("txt"),
        f("t") if t is None else t, f("pooled"), CFG_T, guidance=f("g"),
        freqs=tdit.make_rope_freqs(CFG_T, TXT, HW, device="cpu"),
        device="cpu")


def _rel(out, ref):
    err = np.abs(np.asarray(out) - np.asarray(ref))
    scale = np.abs(np.asarray(ref)).max()
    return err.max() / scale, err.mean() / scale


@pytest.mark.parametrize("fmt,had,svd,gs", [
    ("int8", False, False, 0), ("uint8", False, False, 0),
    ("int8", True, False, 0), ("int8", False, True, 0),
    ("int8", False, False, 32), ("uint8", False, False, 32)])
@pytest.mark.parametrize("rows", [40, 5])
def test_qlinear_routes(fmt, had, svd, gs, rows):
    """rows >= 32: quantized matmul (B1; grouped scales requantize the
    weight rowwise first); rows < 32: weight-only (B2).  The QTensor is
    built by the JAX package and carried across."""
    rng = np.random.default_rng(rows)
    w = rng.normal(size=(96, 128)).astype(np.float32)
    x = rng.normal(size=(rows, 128)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    jq = J.quantize_tensor(jnp.asarray(w), fmt, use_quantized_matmul=True,
                           use_hadamard=had, use_svd=svd, svd_rank=8,
                           group_size=gs, dequant_dtype="float32")
    tq = _carry_qtensors(jq)
    ref = np.asarray(J_LAYERS.qlinear(jnp.asarray(x), jq, jnp.asarray(b)))
    out = T.qlinear(torch.from_numpy(x), tq, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=2e-5 * np.abs(ref).max())
    if not (had or svd):  # the port's own quantization gives the same bytes
        tq2 = T.quantize_tensor(torch.from_numpy(w), fmt,
                                use_quantized_matmul=True, group_size=gs,
                                dequant_dtype="float32")
        out2 = T.qlinear(torch.from_numpy(x), tq2, torch.from_numpy(b))
        np.testing.assert_array_equal(out2.numpy(), out)


def test_dit_forward_weight_only(model):
    params, np_params, inputs, fwd = model
    qc = dict(QC, use_quantized_matmul=False)
    jq, _ = J.quantize_model(params, J.QuantConfig(**qc),
                             arch="FluxTransformer2DModel")
    ref = fwd(jq, jnp.asarray(inputs["img"]), jnp.asarray(inputs["t"]))
    tq, _ = T.quantize_model(params_from_numpy(np_params, "cpu"),
                             T.QuantConfig(**qc),
                             arch="FluxTransformer2DModel", device="cpu")
    out = _port_forward(tq, inputs)
    assert out.shape == (B, HW[0] * HW[1], CFG_T.in_channels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def quantized(model):
    params, np_params, inputs, fwd = model
    jq, jcfg = J.quantize_model(params, J.QuantConfig(**QC),
                                arch="FluxTransformer2DModel")
    ref = np.asarray(fwd(jq, jnp.asarray(inputs["img"]),
                         jnp.asarray(inputs["t"])))
    return jq, jcfg, ref


def test_dit_forward_quantized_matmul(model, quantized):
    _, np_params, inputs, _ = model
    jq, jcfg, ref = quantized
    tq, tcfg = T.quantize_model(params_from_numpy(np_params, "cpu"),
                                T.QuantConfig(**QC),
                                arch="FluxTransformer2DModel", device="cpu")
    assert tcfg.to_dict() == jcfg.to_dict()
    # the same layers quantized, to the same bytes
    jl = jax.tree_util.tree_leaves(jq, is_leaf=lambda a: isinstance(
        a, J.QTensor))
    tl = jax.tree_util.tree_leaves(tq, is_leaf=lambda a: isinstance(
        a, T.QTensor))
    assert [isinstance(a, J.QTensor) for a in jl] == \
        [isinstance(a, T.QTensor) for a in tl]
    for a, b in zip(jl, tl):
        if isinstance(a, J.QTensor):
            np.testing.assert_array_equal(b.qdata.numpy(), np.asarray(a.qdata))
    mx, mean = _rel(_port_forward(tq, inputs).numpy(), ref)
    assert mx < 4e-2 and mean < 4e-3, (mx, mean)


def test_dit_forward_carried_qtensors(model, quantized):
    _, _, inputs, _ = model
    jq, _, ref = quantized
    out = _port_forward(_carry_qtensors(_to_np_keep_q(jq)), inputs).numpy()
    mx, mean = _rel(out, ref)
    assert mx < 4e-2 and mean < 4e-3, (mx, mean)


def _to_np_keep_q(tree):
    return jax.tree_util.tree_map(
        lambda a: a if isinstance(a, J.QTensor) else np.asarray(a), tree,
        is_leaf=lambda a: isinstance(a, J.QTensor))


def test_flux_denoise_two_steps(model, quantized):
    _, np_params, inputs, fwd = model
    jq, _, _ = quantized
    steps = 2
    lat0 = inputs["img"]
    # the JAX sampler's loop body over dit_forward (no VAE decode)
    ts = JFlow(shift=3.0).timesteps(steps)
    lat = jnp.asarray(lat0)
    for i in range(steps):
        v = fwd(jq, lat, jnp.full((B,), ts[i], jnp.float32))
        t_prev = ts[i + 1] if i + 1 < steps else 0.0
        lat = lat + (t_prev - ts[i]) * v.astype(jnp.float32)
    tparams = _carry_qtensors(_to_np_keep_q(jq))
    f = lambda k: torch.from_numpy(inputs[k])  # noqa: E731
    out = flux_denoise(tparams, f("txt"), f("pooled"), CFG_T, steps=steps,
                       height=16 * HW[0], width=16 * HW[1], guidance=3.5,
                       latents=f("img"), device="cpu")
    mx, mean = _rel(out.numpy(), lat)
    assert mx < 4e-2 and mean < 4e-3, (mx, mean)
    np.testing.assert_allclose(TFlow(shift=3.0).timesteps(steps).numpy(),
                               np.asarray(ts), rtol=1e-7)
