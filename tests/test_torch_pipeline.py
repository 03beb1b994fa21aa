"""FLUX text-to-image on the CPU: ``qconv``, the text encoders, the VAE and
``flux_generate`` at tiny sizes, against the JAX package on the same numpy
weights and inputs.

Tolerances (fp32 throughout unless stated):

* ``qconv``: the same fp32 convolution in another summation order, rtol
  1e-5 plus 1e-5 of max |out|; the im2col patches equal JAX's
  ``conv_general_dilated_patches`` exactly.  With the quantized matmul
  (int8 activation codes) the two packages quantize the same rows to the
  same codes, so 1e-5 of max |out| holds there too.
* ``t5_encode`` / ``clip_encode`` under SDNQ's default int8 recipe
  (weight-only): where both take the XLA attention function (T5 at 96
  tokens, CLIP at 77), the same fp32 operations in another order: 1e-4 of
  max |out|.  T5 at 128 tokens takes the kernel route on both sides (the
  JAX Pallas bodies in interpret mode): q, k, v and P are rounded to bf16
  there, so 2e-2 of max |out|.
* ``vae_decode`` / ``vae_encode``: about twenty convolutions and an fp32
  softmax over all pixels: 1e-4 of max |out|.
* ``flux_generate`` (FLUX_TINY, int8 weight-only with groups of 64, 2
  Euler steps, VAE_TINY): JAX's noise fed in as ``latents``; 1e-4 of max
  |image|, as the weight-only DiT test."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu import layers as jlayers
from sdnq_tpu.models import dit as jdit
from sdnq_tpu.models import text_encoder as jte
from sdnq_tpu.models import vae as jvae
from sdnq_tpu.pipeline.diffusion import flux_generate as jgen
from sdnq_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from sdnq_tpu_torch.layers import _patches
from sdnq_tpu_torch.models import text_encoder as tte
from sdnq_tpu_torch.models import vae as tvae
from sdnq_tpu_torch.models import dit as tdit
from sdnq_tpu_torch.pipeline import flux_generate as tgen


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(tree):
    """The port's params (drawn by its seeded inits, which are quicker on
    the CPU than the JAX package's eager ones) as JAX arrays."""
    if isinstance(tree, dict):
        return {k: _jax_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_params(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _carry(qt):
    fields = {k: (None if getattr(qt, k) is None else np.asarray(
        getattr(qt, k))) for k in ("qdata", "scale", "zero_point", "svd_up",
                                   "svd_down")}
    return qtensor_from_numpy(fields, dataclasses.asdict(qt.meta), "cpu")


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# qconv
# ---------------------------------------------------------------------------

def _conv_case(seed, cin=8, cout=16, k=3, n=2, hw=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, hw, hw, cin)).astype(np.float32)
    w = (rng.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k * k)).astype(
        np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def test_patches_match_conv_general_dilated_patches():
    """im2col order: channel-major C·kh·kw features, 3x3, stride 2,
    padding ((1, 1), (1, 1)), and an asymmetric SAME pad."""
    x, _, _ = _conv_case(0, hw=10)
    for stride, pad in (((2, 2), ((1, 1), (1, 1))), ((2, 2), "SAME"),
                        ((1, 1), "VALID")):
        ref = jax.lax.conv_general_dilated_patches(
            jnp.asarray(x), filter_shape=(3, 3), window_strides=stride,
            padding=pad, rhs_dilation=(1, 1),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        out = _patches(torch.from_numpy(x), (3, 3), stride, pad, (1, 1))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# 1-D and 3-D convolutions: (spatial shape, kernel, stride, dilation,
# padding, groups)
ND_CASES = {
    "1d_same_stride2": ((17,), (3,), (2,), (1,), "SAME", 1),
    "1d_explicit_dilated": ((16,), (3,), (1,), (2,), ((2, 1),), 1),
    "1d_grouped_valid": ((15,), (4,), (3,), (1,), "VALID", 2),
    "3d_same": ((5, 6, 7), (3, 3, 3), (1, 2, 1), (1, 1, 1), "SAME", 1),
    "3d_explicit_dilated_grouped": ((6, 7, 5), (3, 2, 3), (2, 1, 1),
                                    (1, 2, 2), ((1, 1), (0, 2), (2, 0)), 2),
}


@pytest.mark.parametrize("case", list(ND_CASES))
def test_patches_and_im2col_any_rank(case):
    """im2col of 1-D and 3-D convolutions: the patches equal JAX's
    ``conv_general_dilated_patches`` exactly (channel-major (c, *k)
    features); ``qconv`` on an int8 weight with the quantized matmul (im2col,
    per-group codes where grouped) within 1e-5 of max |out| of JAX's, as
    the 2-D cases."""
    spatial, kshape, stride, dil, pad, groups = ND_CASES[case]
    nd = len(spatial)
    rng = np.random.default_rng(len(case))
    cin, cout = 4, 6
    x = rng.normal(size=(2, *spatial, cin)).astype(np.float32)
    sp = "DHW"[-nd:]
    ref = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=kshape, window_strides=stride,
        padding=pad, rhs_dilation=dil,
        dimension_numbers=(f"N{sp}C", f"{sp}IO", f"N{sp}C"))
    out = _patches(torch.from_numpy(x), kshape, stride, pad, dil)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    w = (rng.normal(size=(cout, cin // groups, *kshape))
         / np.sqrt(cin * np.prod(kshape))).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    jw = J.quantize_tensor(jnp.asarray(w), "int8", layer_kind="conv",
                           use_quantized_matmul=True, dequant_dtype="float32")
    ref = np.asarray(jlayers.qconv(jnp.asarray(x), jw, jnp.asarray(b),
                                   stride=stride, padding=pad, dilation=dil,
                                   feature_group_count=groups))
    got = T.qconv(torch.from_numpy(x), _carry(jw), torch.from_numpy(b),
                  stride=stride, padding=pad, dilation=dil,
                  feature_group_count=groups).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("route", ["plain", "weight_only", "im2col",
                                   "im2col_weight_only"])
@pytest.mark.parametrize("stride,pad", [(1, "SAME"),
                                        (2, ((1, 1), (1, 1))), (2, "SAME")])
def test_qconv_vs_jax(route, stride, pad):
    """Plain and int8 weights; "im2col" takes the quantized matmul (B1 +
    B4) on 2·out² >= 32 patch rows, "im2col_weight_only" the weight-only
    product (B2) on its rows."""
    x, w, b = _conv_case(1)
    if route == "im2col_weight_only":
        x = x[:1, :6, :6]           # at most 9 patch rows
    if route == "plain":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    else:
        jw = J.quantize_tensor(jnp.asarray(w), "int8", layer_kind="conv",
                               use_quantized_matmul=route != "weight_only",
                               dequant_dtype="float32")
        tw = _carry(jw)
    ref = np.asarray(jlayers.qconv(jnp.asarray(x), jw, jnp.asarray(b),
                                   stride=stride, padding=pad))
    out = T.qconv(torch.from_numpy(x), tw, torch.from_numpy(b),
                  stride=stride, padding=pad).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("mm", [False, True])
def test_qconv_grouped_vs_jax(mm):
    """feature_group_count 2: the batched product over the groups (weight-
    only: the dequantized weight; quantized matmul: per-group int8
    codes)."""
    x, _, b = _conv_case(2)
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(16, 4, 3, 3)) / 6).astype(np.float32)
    jw = J.quantize_tensor(jnp.asarray(w), "int8", layer_kind="conv",
                           use_quantized_matmul=True, dequant_dtype="float32")
    x = x if mm else x[:1, :5, :5]   # 162 or 25 patch rows
    ref = np.asarray(jlayers.qconv(jnp.asarray(x), jw, jnp.asarray(b),
                                   feature_group_count=2))
    out = T.qconv(torch.from_numpy(x), _carry(jw), torch.from_numpy(b),
                  feature_group_count=2).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("stride,pad", [(2, "SAME"), (2, "VALID"),
                                        (1, "SAME"), (2, ((1, 2), (0, 1)))])
@pytest.mark.parametrize("quantized", [False, True])
def test_qconv_transpose_vs_jax(stride, pad, quantized):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 5, 8)).astype(np.float32)
    w = (rng.normal(size=(8, 6, 3, 3)) / 5).astype(np.float32)  # (Cin, Cout)
    b = rng.normal(size=(6,)).astype(np.float32)
    if quantized:
        jw = J.quantize_tensor(jnp.asarray(w), "int8",
                               layer_kind="conv_transpose",
                               dequant_dtype="float32")
        tw = _carry(jw)
    else:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    ref = np.asarray(jlayers.qconv(jnp.asarray(x), jw, jnp.asarray(b),
                                   stride=stride, padding=pad,
                                   transpose=True))
    out = T.qconv(torch.from_numpy(x), tw, torch.from_numpy(b),
                  stride=stride, padding=pad, transpose=True).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Text encoders
# ---------------------------------------------------------------------------

QC = dict(weights_dtype="int8", dequant_dtype="float32")


def _quantized(params, arch=None):
    jq, _ = J.quantize_model(params, J.QuantConfig(**QC), arch=arch)
    tq, _ = T.quantize_model(params_from_numpy(_np(params), "cpu"),
                             T.QuantConfig(**QC), arch=arch, device="cpu")
    return jq, tq


@pytest.fixture(scope="module")
def t5():
    params = _jax_params(tte.init_t5(tte.T5_TINY_CONFIG, generator=_gen(1),
                                     device="cpu"))
    return _quantized(params)


@pytest.mark.parametrize("n,route", [(96, "xla"), (128, "interpret")])
def test_t5_encode_vs_jax(monkeypatch, t5, n, route):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", route)
    jq, tq = t5
    cfg = jte.T5_TINY_CONFIG
    ids = np.random.default_rng(n).integers(0, cfg.vocab_size, (2, n))
    ref = np.asarray(jte.t5_encode(jq, jnp.asarray(ids), cfg))
    out = tte.t5_encode(tq, torch.from_numpy(ids), tte.T5_TINY_CONFIG,
                        device="cpu").numpy()
    assert out.shape == (2, n, cfg.hidden_size)
    assert _rel_err(out, ref) <= (1e-4 if route == "xla" else 2e-2)


def test_clip_encode_vs_jax():
    params = _jax_params(tte.init_clip(tte.CLIP_TINY_CONFIG,
                                       generator=_gen(2), device="cpu"))
    jq, tq = _quantized(params)
    cfg = jte.CLIP_TINY_CONFIG
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 77))
    rh, rp = jte.clip_encode(jq, jnp.asarray(ids), cfg)
    oh, op = tte.clip_encode(tq, torch.from_numpy(ids), tte.CLIP_TINY_CONFIG,
                             device="cpu")
    assert oh.shape == (2, 77, cfg.hidden_size) and op.shape == (2, 64)
    assert _rel_err(oh.numpy(), rh) <= 1e-4
    assert _rel_err(op.numpy(), rp) <= 1e-4


# ---------------------------------------------------------------------------
# VAE and the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae():
    params = tvae.init_vae(tvae.VAE_TINY_CONFIG, generator=_gen(3),
                           device="cpu")
    return _jax_params(params), params


def test_vae_decode_encode_vs_jax(vae):
    jp, tp = vae
    jcfg, tcfg = jvae.VAE_TINY_CONFIG, tvae.VAE_TINY_CONFIG
    rng = np.random.default_rng(6)
    z = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jvae.vae_decode(jp, jnp.asarray(z), jcfg))
    out = tvae.vae_decode(tp, torch.from_numpy(z), tcfg, device="cpu")
    assert out.shape == (1, 16, 16, 3)
    assert _rel_err(out.numpy(), ref) <= 1e-4
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jvae.vae_encode(jp, jnp.asarray(img), jcfg))
    out = tvae.vae_encode(tp, torch.from_numpy(img), tcfg, device="cpu")
    assert out.shape == (1, 8, 8, 4)
    assert _rel_err(out.numpy(), ref) <= 1e-4


def test_vae_quantized_convs_carried(vae):
    """The JAX package's VAE with its convs quantized (quant_conv, 4-D
    int8 QTensors, weight-only) carried across by ``params_from_numpy``:
    the decode agrees to 1e-4 of max |out|."""
    jp, _ = vae
    jq, _ = J.quantize_model(jp, J.QuantConfig(
        weights_dtype="int8", quant_conv=True, dequant_dtype="float32"))
    convs = [a for a in jax.tree_util.tree_leaves(
        jq, is_leaf=lambda a: isinstance(a, J.QTensor))
        if isinstance(a, J.QTensor) and len(a.meta.original_shape) == 4]
    assert convs
    tq = params_from_numpy(jq, "cpu")
    carried = [a for a in jax.tree_util.tree_leaves(
        tq, is_leaf=lambda a: isinstance(a, T.QTensor))
        if isinstance(a, T.QTensor) and len(a.meta.original_shape) == 4]
    assert len(carried) == len(convs)
    z = np.random.default_rng(8).normal(size=(1, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jvae.vae_decode(jq, jnp.asarray(z),
                                     jvae.VAE_TINY_CONFIG))
    out = tvae.vae_decode(tq, torch.from_numpy(z), tvae.VAE_TINY_CONFIG,
                          device="cpu")
    assert _rel_err(out.numpy(), ref) <= 1e-4


def test_flux_generate_vs_jax(vae):
    jvp, tvp = vae
    cfg = jdit.FLUX_TINY_CONFIG
    params = _jax_params(tdit.init_dit(tdit.FLUX_TINY_CONFIG,
                                       generator=_gen(4), device="cpu"))
    qc = dict(QC, group_size=64)
    jq, _ = J.quantize_model(params, J.QuantConfig(**qc),
                             arch="FluxTransformer2DModel")
    tq, _ = T.quantize_model(params_from_numpy(_np(params), "cpu"),
                             T.QuantConfig(**qc),
                             arch="FluxTransformer2DModel", device="cpu")
    assert any(q.scale.reshape(q.scale.shape[0], -1).shape[1] > 1
               for q in jax.tree_util.tree_leaves(
                   tq, is_leaf=lambda a: isinstance(a, T.QTensor))
               if isinstance(q, T.QTensor))
    rng = np.random.default_rng(7)
    txt = rng.normal(size=(1, 16, cfg.txt_dim)).astype(np.float32)
    pooled = rng.normal(size=(1, cfg.vec_dim)).astype(np.float32)
    side, steps = 128, 2
    ref = np.asarray(jgen(jq, jvp, jnp.asarray(txt), jnp.asarray(pooled),
                          dit_cfg=cfg, vae_cfg=jvae.VAE_TINY_CONFIG,
                          steps=steps, height=side, width=side, seed=0))
    noise = jax.random.normal(jax.random.key(0),
                              (1, (side // 16) ** 2, cfg.in_channels),
                              jnp.float32)
    out = tgen(tq, tvp, torch.from_numpy(txt), torch.from_numpy(pooled),
               dit_cfg=tdit.FLUX_TINY_CONFIG,
               vae_cfg=tvae.VAE_TINY_CONFIG, steps=steps, height=side,
               width=side, latents=torch.from_numpy(np.asarray(noise)),
               device="cpu")
    assert out.shape == ref.shape == (1, 32, 32, 3)
    assert _rel_err(out.numpy(), ref) <= 1e-4
