"""The SD UNet slice on the CPU: ``init_unet``'s tree, ``unet_forward``
(unquantized, int8 weight-only with quantized convs, int8 with the
quantized matmul on linears and im2col convs), the staged forward, the DDIM
and Euler schedulers and a 2-step ``sd_generate``, each against the JAX
package on the same numpy weights and inputs.  UNET_TINY_CONFIG (levels of
32 and 64 channels, a transformer at the second) at 16x16 latents with 8
context tokens, and the same with ``addition_embed_dim`` 48 so that SDXL's
``add_embedding`` runs.  The weights are drawn by the port's seeded init
and handed to JAX (its eager init is slower on the CPU).

Tolerances:

* Unquantized fp32 and int8 weight-only: the same fp32 operations (and the
  same integer codes) in another order: 1e-4 of max |out| (measured at most
  1.1e-6).  The attention takes the XLA function in both packages here (64
  and 8 keys).
* int8 with the quantized matmul: activation codes are rounded per row, so
  a code at a rounding tie moves by one step where an fp32 sum differs by
  an ulp, and its output by one quantization step (as in
  ``test_torch_dit.py``; the timestep embedding's cos/sin at t = 999
  differ by about 1e-5 between XLA and torch).  Measured on the tiny
  config: max 1.04e-2 and mean 1.33e-3 of max |out|, where the JAX
  package's own eager and jit forwards differ by 1.15e-2 and 1.27e-3;
  bound max 3e-2, mean 3e-3, with the weight-only model as the tight
  check.
* Schedulers: ``_sd_alphas`` runs the fp32 linspace in the JAX order, but
  XLA and torch take the cumulative product in other orders (measured
  1.4e-6 relative): 1e-5 relative; the integer timesteps are equal.
* ``sd_generate`` (2 DDIM steps, guidance 7.5, VAE_TINY): JAX's noise
  passed in as ``latents``; guidance multiplies the difference of two
  forwards by 7.5: measured 2.6e-6 of max |image|, bound 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu.models import unet as junet
from sdnq_tpu.models import vae as jvae
from sdnq_tpu.pipeline import schedulers as jsched
from sdnq_tpu.pipeline.diffusion import sd_generate as jgen
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.models import unet as tunet
from sdnq_tpu_torch.models import vae as tvae
from sdnq_tpu_torch.pipeline import schedulers as tsched
from sdnq_tpu_torch.pipeline import sd_generate as tgen

B, HW, L = 2, 16, 8
CFGS = {"tiny": (junet.UNET_TINY_CONFIG, tunet.UNET_TINY_CONFIG),
        "tiny_xl": (dataclasses.replace(junet.UNET_TINY_CONFIG,
                                        addition_embed_dim=48),
                    dataclasses.replace(tunet.UNET_TINY_CONFIG,
                                        addition_embed_dim=48))}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.numpy()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _rel(out, ref):
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    scale = np.abs(np.asarray(ref, np.float32)).max()
    return err.max() / scale, err.mean() / scale


@pytest.fixture(scope="module")
def model(request):
    jcfg, tcfg = CFGS[request.param]  # "tiny" or "tiny_xl"
    params = _np_tree(tunet.init_unet(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(1)
    inp = dict(x=rng.normal(size=(B, HW, HW, 4)),
               t=np.array([999.0, 421.0]),
               ctx=rng.normal(size=(B, L, tcfg.cross_attention_dim)))
    if tcfg.addition_embed_dim:
        inp["added"] = rng.normal(size=(B, tcfg.addition_embed_dim))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    ref = _jax_forward(jcfg, _jax_tree(params), inp)
    return request.param, jcfg, tcfg, params, inp, ref


def _jax_forward(jcfg, jparams, inp):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    fwd = jax.jit(lambda p: junet.unet_forward(
        p, j["x"], j["t"], j["ctx"], jcfg, added_cond=j.get("added")))
    return np.asarray(fwd(jparams))


def _port_forward(tcfg, tparams, inp, **kw):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return tunet.unet_forward(tparams, t["x"], t["t"], t["ctx"], tcfg,
                              added_cond=t.get("added"), device="cpu",
                              **kw).numpy()


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("model", list(CFGS), indirect=True)
def test_init_tree_matches_jax(model):
    """The same nested names and leaf shapes as the JAX ``init_unet``
    (traced for its shapes alone)."""
    _, jcfg, tcfg, params, _, _ = model
    jparams = jax.eval_shape(lambda: junet.init_unet(jax.random.key(0),
                                                     jcfg))
    assert _shapes(params) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jparams)


@pytest.mark.parametrize("model", list(CFGS), indirect=True)
def test_unet_forward_fp32(model):
    _, _, tcfg, params, inp, ref = model
    out = _port_forward(tcfg, params_from_numpy(params, "cpu"), inp)
    assert out.shape == (B, HW, HW, 4) and np.isfinite(out).all()
    mx, _ = _rel(out, ref)
    assert mx <= 1e-4, mx


@pytest.mark.parametrize("model", ["tiny"], indirect=True)
def test_unet_forward_int8_weight_only(model):
    """SD1.5's recipe (BASELINE config 1): int8 weights, convolutions
    quantized too, the weight-only route; the port's ``quantize_model``
    gives the JAX package's bytes."""
    _, jcfg, tcfg, params, inp, _ = model
    qc = dict(weights_dtype="int8", quant_conv=True, dequant_dtype="float32")
    jq, _ = J.quantize_model(_jax_tree(params), J.QuantConfig(**qc),
                             arch="SD15UNet")
    ref = _jax_forward(jcfg, jq, inp)
    tq, _ = T.quantize_model(params_from_numpy(params, "cpu"),
                             T.QuantConfig(**qc), arch="SD15UNet",
                             device="cpu")
    jl = [a for a in jax.tree_util.tree_leaves(
        jq, is_leaf=lambda a: isinstance(a, J.QTensor))
        if isinstance(a, J.QTensor)]
    tl = [a for a in jax.tree_util.tree_leaves(
        tq, is_leaf=lambda a: isinstance(a, T.QTensor))
        if isinstance(a, T.QTensor)]
    assert len(jl) == len(tl) and any(a.qdata.ndim == 4 for a in jl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.qdata.numpy(), np.asarray(a.qdata))
    mx, _ = _rel(_port_forward(tcfg, tq, inp), ref)
    assert mx <= 1e-4, mx


@pytest.mark.parametrize("model", ["tiny_xl"], indirect=True)
def test_unet_forward_int8_quantized_matmul(model):
    """SDXL's recipe (BASELINE config 2): int8 with the quantized matmul on
    the linears and, through im2col, the convolutions; the JAX QTensors
    carried across."""
    _, jcfg, tcfg, params, inp, _ = model
    qc = dict(weights_dtype="int8", quant_conv=True,
              use_quantized_matmul=True, use_quantized_matmul_conv=True,
              dequant_dtype="float32")
    jq, _ = J.quantize_model(_jax_tree(params), J.QuantConfig(**qc),
                             arch="SDXLUNet")
    assert any(isinstance(a, J.QTensor) and a.meta.use_quantized_matmul
               and a.qdata.ndim == 4 for a in jax.tree_util.tree_leaves(
                   jq, is_leaf=lambda a: isinstance(a, J.QTensor)))
    ref = _jax_forward(jcfg, jq, inp)
    out = _port_forward(tcfg, params_from_numpy(jq, "cpu"), inp)
    mx, mean = _rel(out, ref)
    assert mx <= 3e-2 and mean <= 3e-3, (mx, mean)


@pytest.mark.parametrize("model", list(CFGS), indirect=True)
def test_staged_forward(model, caplog):
    """The staged forward (``sync`` logs each stage) is the monolithic
    one, bit for bit, and matches the JAX package's monolithic forward."""
    _, _, tcfg, params, inp, ref = model
    tp = params_from_numpy(params, "cpu")
    staged = tunet.make_staged_unet_forward(tcfg, sync=True)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with caplog.at_level("INFO", logger="sdnq_tpu_torch"):
        out = staged(tp, t["x"], t["t"], t["ctx"], t.get("added"),
                     device="cpu").numpy()
    stages = [r.getMessage() for r in caplog.records
              if "staged-unet stage ok" in r.getMessage()]
    assert len(stages) == 2 + 2 * len(tcfg.block_out_channels) + 1
    np.testing.assert_array_equal(out, _port_forward(tcfg, tp, inp))
    mx, _ = _rel(out, ref)
    assert mx <= 1e-4, mx


def test_upsample_is_jax_nearest_resize():
    """The up-sampler (the VAE's pixel replication) is the JAX package's
    ``jax.image.resize(..., "nearest")`` at twice the size."""
    x = np.random.default_rng(2).normal(size=(2, 5, 3, 4)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 10, 6, 4), "nearest")
    np.testing.assert_array_equal(
        tunet._upsample2x(torch.from_numpy(x)).numpy(), np.asarray(ref))


@pytest.mark.parametrize("steps", [1, 4, 20, 50])
def test_schedulers_against_jax(steps):
    jd, td = jsched.DDIMScheduler(), tsched.DDIMScheduler()
    je, te = jsched.EulerScheduler(), tsched.EulerScheduler()
    np.testing.assert_array_equal(td.timesteps(steps).numpy(),
                                  np.asarray(jd.timesteps(steps)))
    np.testing.assert_array_equal(te.timesteps(steps).numpy(),
                                  np.asarray(je.timesteps(steps)))
    np.testing.assert_allclose(te.sigmas(steps).numpy(),
                               np.asarray(je.sigmas(steps)), rtol=1e-5)
    rng = np.random.default_rng(steps)
    lat, eps, x0 = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
                    for _ in range(3))
    t = np.array([999, 500], np.int32)
    for t_prev in (np.array([800, 0], np.int32), np.array([-1, -1],
                                                          np.int32)):
        ref = jd.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(t_prev),
                      jnp.asarray(lat))
        out = td.step(torch.from_numpy(eps), torch.from_numpy(t).long(),
                      torch.from_numpy(t_prev).long(), torch.from_numpy(lat))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    ref = jd.add_noise(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))
    out = td.add_noise(torch.from_numpy(x0), torch.from_numpy(eps),
                       torch.from_numpy(t).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    sig = te.sigmas(steps)
    jsig = je.sigmas(steps)
    ref = je.step(jnp.asarray(eps), jsig[0], jsig[1],
                  je.scale_input(jnp.asarray(lat), jsig[0]))
    out = te.step(torch.from_numpy(eps), sig[0], sig[1],
                  te.scale_input(torch.from_numpy(lat), sig[0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sd_generate_two_steps():
    """DDIM with classifier-free guidance over 2 steps, then the VAE:
    JAX's own noise (``jax.random.normal`` of key 0) as ``latents``."""
    jcfg, tcfg = CFGS["tiny_xl"]
    params = _np_tree(tunet.init_unet(
        tcfg, generator=torch.Generator().manual_seed(3), device="cpu"))
    vparams = _np_tree(tvae.init_vae(
        tvae.VAE_TINY_CONFIG, generator=torch.Generator().manual_seed(4),
        device="cpu"))
    rng = np.random.default_rng(5)
    text, uncond = (rng.normal(size=(1, L, 64)).astype(np.float32)
                    for _ in range(2))
    added = rng.normal(size=(1, 48)).astype(np.float32)
    side = 8 * HW
    ref = np.asarray(jgen(
        _jax_tree(params), _jax_tree(vparams), jnp.asarray(text),
        jnp.asarray(uncond), unet_cfg=jcfg, vae_cfg=jvae.VAE_TINY_CONFIG,
        steps=2, height=side, width=side, seed=0,
        added_cond=jnp.asarray(added)))
    noise = np.asarray(jax.random.normal(jax.random.key(0),
                                         (1, HW, HW, 4), jnp.float32))
    out = tgen(params_from_numpy(params, "cpu"),
               params_from_numpy(vparams, "cpu"), torch.from_numpy(text),
               torch.from_numpy(uncond), unet_cfg=tcfg,
               vae_cfg=tvae.VAE_TINY_CONFIG, steps=2, height=side,
               width=side, latents=torch.from_numpy(noise),
               added_cond=torch.from_numpy(added), device="cpu").numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    mx, _ = _rel(out, ref)
    assert mx <= 1e-4, mx
