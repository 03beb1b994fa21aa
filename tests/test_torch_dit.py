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


# ---------------------------------------------------------------------------
# uint4 + SVD rank 32 (the published 4-bit recipe) at FLUX_TINY_CONFIG:
# hidden 256, so K = 256 and the SVD group size 128 reach the half-split
# kernels (B5 / B6 weight-only, B7 with the quantized matmul).
# ---------------------------------------------------------------------------

U4 = dict(weights_dtype="uint4", use_svd=True, svd_rank=32,
          dequant_dtype="float32")


@pytest.fixture(scope="module")
def uint4(model):
    params, _, inputs, fwd = model
    jq, _ = J.quantize_model(params, J.QuantConfig(**U4),
                             arch="FluxTransformer2DModel")
    ref = np.asarray(fwd(jq, jnp.asarray(inputs["img"]),
                         jnp.asarray(inputs["t"])))
    return jq, ref


def _qtensors(tree):
    return [a for a in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda a: isinstance(a, (J.QTensor, T.QTensor)))
        if isinstance(a, (J.QTensor, T.QTensor))]


def test_dit_forward_uint4_svd_weight_only(model, uint4):
    """Carried-across JAX QTensors (half-split uint4 codes, SVD factors):
    the same fp32 operations in another order, 1e-4 of max |out|."""
    _, _, inputs, _ = model
    jq, ref = uint4
    tq = _carry_qtensors(_to_np_keep_q(jq))
    qts = _qtensors(tq)
    assert qts and all(q.meta.pack_layout == "halfsplit"
                       and q.svd_up is not None for q in qts)
    out = _port_forward(tq, inputs).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_dit_forward_uint4_svd_quantized_matmul(model, monkeypatch):
    """The quantized-matmul route on the same recipe, JAX's Pallas bodies
    in interpret mode so that its packed int8 route (B7 here) runs as the
    port's does.  Activation codes at rounding ties flip as in the int8
    case (module docstring): max 4e-2, mean 4e-3 of max |out|."""
    params, _, inputs, _ = model
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    jq, _ = J.quantize_model(
        params, J.QuantConfig(**U4, use_quantized_matmul=True),
        arch="FluxTransformer2DModel")
    freqs = jdit.make_rope_freqs(CFG_J, TXT, HW)
    ref = np.asarray(jax.jit(lambda p: jdit.dit_forward(
        p, jnp.asarray(inputs["img"]), jnp.asarray(inputs["txt"]),
        jnp.asarray(inputs["t"]), jnp.asarray(inputs["pooled"]), CFG_J,
        guidance=jnp.asarray(inputs["g"]), freqs=freqs))(jq))
    out = _port_forward(_carry_qtensors(_to_np_keep_q(jq)), inputs).numpy()
    mx, mean = _rel(out, ref)
    assert mx < 4e-2 and mean < 4e-3, (mx, mean)


def test_dit_forward_uint4_svd_from_fp_weights(model, uint4):
    """Both packages quantize the same fp weights.  Their SVD sketches
    differ (torch.Generator against jax.random), so the residuals and then
    the uint4 codes differ by the quantization noise itself, and so do the
    outputs (about 0.2 of max |out| on this random model).  What must
    agree is the quality: each layer's dequantized weight is as far from
    the fp weight on both sides (within 2%), and the model's distance from
    the unquantized model's output agrees within 10%."""
    params, np_params, inputs, _ = model
    jq, ref = uint4
    tq, _ = T.quantize_model(params_from_numpy(np_params, "cpu"),
                             T.QuantConfig(**U4),
                             arch="FluxTransformer2DModel", device="cpu")
    is_q = lambda a: isinstance(a, (J.QTensor, T.QTensor))  # noqa: E731
    leaves = zip(jax.tree_util.tree_leaves(params),
                 jax.tree_util.tree_leaves(jq, is_leaf=is_q),
                 jax.tree_util.tree_leaves(tq, is_leaf=is_q))
    n = 0
    for w, a, b in leaves:
        assert isinstance(a, J.QTensor) == isinstance(b, T.QTensor)
        if not isinstance(a, J.QTensor):
            continue
        assert dataclasses.asdict(a.meta) == dataclasses.asdict(b.meta)
        w = np.asarray(w)
        ej = np.linalg.norm(np.asarray(a.dequantize(jnp.float32)) - w)
        et = np.linalg.norm(b.dequantize(torch.float32).numpy() - w)
        assert abs(et - ej) <= 0.02 * ej, (et, ej)
        n += 1
    assert n == len(_qtensors(jq)) > 0
    # the unquantized model's output (the port's forward on fp weights,
    # which the int8 tests hold to the JAX package's)
    fp = _port_forward(params_from_numpy(np_params, "cpu"), inputs).numpy()
    out = _port_forward(tq, inputs).numpy()
    e_j = np.sqrt(((ref - fp) ** 2).mean())
    e_t = np.sqrt(((out - fp) ** 2).mean())
    assert abs(e_t - e_j) <= 0.1 * e_j, (e_t, e_j)


@pytest.mark.parametrize("fmt", ["uint4", "int8"])
def test_weight_only_svd_rounding_bf16(fmt, monkeypatch):
    """Weight-only with SVD factors at bf16: the correction (x @ downᵀ) @
    upᵀ is computed in the factors' dtype with the bias rounded to it and
    folded in, and added to the kernel's rounded output, as the JAX package
    does (its Pallas bodies in interpret mode keep x in bf16, like the
    port's plain versions).  Both sides then round at the same points and
    agree to one bf16 ulp of each output."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    rng = np.random.default_rng(21)
    w = rng.normal(size=(96, 256)).astype(np.float32)
    x = rng.normal(size=(5, 256)).astype(np.float32)
    b = (rng.normal(size=(96,)) * 8).astype(np.float32)
    jq = J.quantize_tensor(jnp.asarray(w), fmt, use_svd=True, svd_rank=8)
    tq = _carry_qtensors(jq)
    assert tq.svd_up.dtype == torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(J_LAYERS.qlinear(jx, jq, jnp.asarray(b))
                     .astype(jnp.float32))
    out = T.qlinear(torch.from_numpy(x).bfloat16(), tq,
                    torch.from_numpy(b)).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)
    assert (np.abs(out - ref) <= ulp).all(), np.abs(out - ref).max()


def test_flux_denoise_two_steps_uint4(model, uint4):
    """Two Euler steps on the uint4 + SVD weight-only path, carried-across
    QTensors: fp32, 1e-4 of max |latent| as the single forward."""
    _, _, inputs, fwd = model
    jq, _ = uint4
    steps = 2
    ts = JFlow(shift=3.0).timesteps(steps)
    lat = jnp.asarray(inputs["img"])
    for i in range(steps):
        v = fwd(jq, lat, jnp.full((B,), ts[i], jnp.float32))
        t_prev = ts[i + 1] if i + 1 < steps else 0.0
        lat = lat + (t_prev - ts[i]) * v.astype(jnp.float32)
    f = lambda k: torch.from_numpy(inputs[k])  # noqa: E731
    out = flux_denoise(_carry_qtensors(_to_np_keep_q(jq)), f("txt"),
                       f("pooled"), CFG_T, steps=steps, height=16 * HW[0],
                       width=16 * HW[1], guidance=3.5, latents=f("img"),
                       device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(lat), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(lat)).max())
