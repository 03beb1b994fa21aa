"""The model-level options of dynamic quantization's slice: the port
against the JAX package on the same numpy weights.  ``requantize_model``
and ``apply_options_to_model`` (codes bit-equal, scales within one ulp),
``dequantize_model`` and ``model_memory_footprint`` (equal integers),
stochastic rounding of native fp8 weights with fed-in bits, and a tiny
DiT with tailed weights through both packages' dynamic ``quantize_model``.
Weights with tails are drawn as in tests/test_torch_dynamic.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu import options as jopt
from sdnq_tpu.models import dit as jdit
from sdnq_tpu.quant import core as jcore
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.models import dit as tdit
from sdnq_tpu_torch.quant import core as tcore


def tailed(rng, shape, nu):
    """Gaussian (nu None) or Student-t with nu degrees of freedom."""
    z = rng.normal(size=shape)
    if nu is None:
        return z
    chi2 = sum(rng.normal(size=shape) ** 2 for _ in range(nu))
    return z / np.sqrt(chi2 / nu)


def _small_tree(seed=3):
    rng = np.random.default_rng(seed)
    return {"a": {"weight": (rng.normal(size=(64, 256)) * 0.02).astype(
                np.float32), "bias": rng.normal(size=(64,)).astype(
                np.float32)},
            "b": [{"weight": (tailed(rng, (96, 256), 3) * 0.02).astype(
                np.float32)}]}


def _quantized_pair(**qc):
    tree = _small_tree()
    jq, _ = J.quantize_model(jax.tree_util.tree_map(jnp.asarray, tree),
                             J.QuantConfig(**qc))
    tq, _ = T.quantize_model(params_from_numpy(tree, "cpu"),
                             T.QuantConfig(**qc), device="cpu")
    return jq, tq


def _leaves(j, t):
    jl = jax.tree_util.tree_leaves(
        j, is_leaf=lambda a: isinstance(a, J.QTensor))
    tl = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            tl.append(x)
    walk(t)
    assert len(jl) == len(tl)
    return list(zip(jl, tl))


def _ulps(a, b):
    """The largest difference of two fp32 arrays in ulps of b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a - b) / np.spacing(np.abs(b))).max())


@pytest.mark.parametrize("target", ["int4", "float8_e4m3fn", "uint6"])
def test_requantize_model_matches_jax(target):
    jq, tq = _quantized_pair(weights_dtype="int8")
    jr = jopt.requantize_model(jq, target)
    tr = T.requantize_model(tq, target)
    n = 0
    for a, b in _leaves(jr, tr):
        if isinstance(a, J.QTensor):
            n += 1
            assert dataclasses.asdict(b.meta) == dataclasses.asdict(a.meta)
            np.testing.assert_array_equal(
                b.qdata.view(torch.uint8).numpy() if b.qdata.element_size()
                == 1 else b.qdata.numpy(),
                np.asarray(a.qdata).view(np.uint8)
                if np.asarray(a.qdata).itemsize == 1 else np.asarray(a.qdata))
            assert _ulps(b.scale.numpy(), a.scale) <= 1
            if a.zero_point is not None:
                assert _ulps(b.zero_point.numpy(), a.zero_point) <= 1
    assert n == 2


def test_apply_options_dequantize_and_footprint():
    jq, tq = _quantized_pair(weights_dtype="uint4", group_size=32)
    ja = jopt.apply_options_to_model(jq, use_quantized_matmul=True,
                                     dequant_dtype="float32")
    ta = T.apply_options_to_model(tq, use_quantized_matmul=True,
                                  dequant_dtype="float32")
    for a, b in _leaves(ja, ta):
        if isinstance(a, J.QTensor):
            assert dataclasses.asdict(b.meta) == dataclasses.asdict(a.meta)
            assert b.meta.use_quantized_matmul
    for a, b in _leaves(tq, ta):   # the stored tensors are shared
        if isinstance(a, T.QTensor):
            assert b.qdata is a.qdata
    jd = J.dequantize_model(ja)
    td = T.dequantize_model(ta)
    for a, b in _leaves(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    assert T.model_memory_footprint(tq) == J.model_memory_footprint(jq)
    assert T.model_memory_footprint(td) == J.model_memory_footprint(jd)


@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_stochastic_rounding_fed_bits(fmt):
    """Native fp8 weights with the same 32-bit rounding bits as the JAX
    package's fp8 stochastic rounding (``quantize_fp_mm`` with a key):
    the same bytes; and the rounding is unbiased on average."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    key = jax.random.key(7)
    bits = np.asarray(jax.random.bits(key, w.shape, jnp.uint32))
    jq, js = jcore.quantize_fp_mm(jnp.asarray(w), fmt=fmt, rng=key)
    tq, ts, _ = tcore.quantize_weight(torch.from_numpy(w), fmt,
                                      sr_bits=torch.from_numpy(
                                          bits.astype(np.int64)))
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    nearest = tcore.quantize_weight(torch.from_numpy(w), fmt)[0]
    assert not torch.equal(tq.view(torch.uint8), nearest.view(torch.uint8))
    # through quantize_tensor with a generator: drawn bits, same law
    t = torch.from_numpy(w)
    reps = torch.stack([T.quantize_tensor(
        t, fmt, use_stochastic_rounding=True,
        generator=torch.Generator().manual_seed(i)).dequantize(torch.float32)
        for i in range(64)]).mean(0)
    near = T.quantize_tensor(t, fmt).dequantize(torch.float32)
    assert (reps - t).abs().mean() < (near - t).abs().mean()


def _tailed_dit(cfg, seed=11):
    """The port's seeded init (the JAX init takes seconds eagerly) as
    numpy, every 2-D linear weight redrawn at the init's std with its tail
    from the cycle Gaussian, t5, t3, t2."""
    params = tdit.init_dit(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    laws = [None, 5, 3, 2]
    n = 0

    def conv(x):
        nonlocal n
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        a = x.numpy()
        if a.ndim == 2:
            t = tailed(rng, a.shape, laws[n % 4])
            n += 1
            a = (t / t.std() * a.std()).astype(np.float32)
        return a
    return conv(params)


def test_tiny_dit_dynamic_matches_jax():
    """FLUX_TINY cut to 1 double + 1 single block, with tailed weights,
    through both packages' quantize_model under dynamic quantization from
    uint4 (weight-only, fp32 dequant; the ladder reaches multi-plane and
    minifloat half-split codes): the same format for every path, and the
    forwards within 1e-4 of the largest output (the weight-only tolerance
    of tests/test_torch_dit.py).  The int8 ladder's bit-plane formats are
    held against the JAX package in test_torch_packed_modes.py."""
    start = "uint4"
    cfg_j = dataclasses.replace(jdit.FLUX_TINY_CONFIG, depth_double=1,
                                depth_single=1)
    cfg_t = dataclasses.replace(tdit.FLUX_TINY_CONFIG, depth_double=1,
                                depth_single=1)
    np_params = _tailed_dit(cfg_t)
    qc = dict(weights_dtype=start, use_dynamic_quantization=True,
              dequant_dtype="float32")
    jq, jc = J.quantize_model(jax.tree_util.tree_map(jnp.asarray, np_params),
                              J.QuantConfig(**qc),
                              arch="FluxTransformer2DModel")
    tq, tc = T.quantize_model(params_from_numpy(np_params, "cpu"),
                              T.QuantConfig(**qc),
                              arch="FluxTransformer2DModel", device="cpu")
    # (the same paths; JAX walks the dicts in sorted key order)
    assert {k: sorted(v) for k, v in tc.modules_dtype_dict.items()} == \
        {k: sorted(v) for k, v in jc.modules_dtype_dict.items()}
    assert sorted(tc.modules_to_not_convert) == \
        sorted(jc.modules_to_not_convert)
    assert {"int5", "float5_e2m2fn"} <= set(tc.modules_dtype_dict)
    rng = np.random.default_rng(0)
    b, hw, txt = 1, (4, 4), 8
    img = rng.normal(size=(b, hw[0] * hw[1], cfg_j.in_channels))
    tx = rng.normal(size=(b, txt, cfg_j.txt_dim))
    pooled = rng.normal(size=(b, cfg_j.vec_dim))
    ts, g = np.full((b,), 0.4), np.full((b,), 3.5)
    img, tx, pooled, ts, g = (a.astype(np.float32)
                              for a in (img, tx, pooled, ts, g))
    ref = np.asarray(jdit.dit_forward(
        jq, *map(jnp.asarray, (img, tx, ts, pooled)), cfg_j,
        guidance=jnp.asarray(g), freqs=jdit.make_rope_freqs(cfg_j, txt, hw)))
    out = tdit.dit_forward(
        tq, *map(torch.from_numpy, (img, tx, ts, pooled)), cfg_t,
        guidance=torch.from_numpy(g),
        freqs=tdit.make_rope_freqs(cfg_t, txt, hw, device="cpu"),
        device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
