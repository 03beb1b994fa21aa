"""Dynamic per-layer format selection: the port's ladder against the JAX
package's on the same numpy weights (the model-level options are in
tests/test_torch_options.py).

Weights with tails stand in for real checkpoints' outliers: Student-t draws
z / sqrt(chi2_nu / nu) with chi2_nu a sum of nu squared normals, the law
the card path draws with a torch.Generator.  On i.i.d. Gaussian weights the
ladder never leaves its start format.

The ladder must pick the same format and group size on both sides.  The
port's loss is float64 on the CPU, JAX's fp32, so the losses agree to 1e-6
relative; where they straddle the threshold the choice could differ, and
the test reports the margin instead of loosening the check."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu import dynamic as jdyn
from sdnq_tpu_torch import dynamic as tdyn


def tailed(rng, shape, nu):
    """Gaussian (nu None) or Student-t with nu degrees of freedom."""
    z = rng.normal(size=shape)
    if nu is None:
        return z
    chi2 = sum(rng.normal(size=shape) ** 2 for _ in range(nu))
    return z / np.sqrt(chi2 / nu)


def _pair(w, start, **kw):
    jq = jdyn.quantize_tensor_dynamic(jnp.asarray(w), "linear", fmt=start,
                                      **kw)
    tq = tdyn.quantize_tensor_dynamic(torch.from_numpy(w), "linear",
                                      fmt=start, **kw)
    return jq, tq


def _same_choice(w, jq, tq, start, svd=False):
    """Same format, group size and meta; the losses within 1e-6 relative
    and the codes equal, or with the SVD (whose sketches differ between the
    packages: residual norms agree to about 1e-5, tests/test_torch_svd.py)
    the losses within 1e-4."""
    thr = 10.0 ** -(J.get_format(start).num_bits / 2)
    assert (jq is None) == (tq is None)
    if jq is None:
        return None
    jl = jdyn.quantization_loss(jnp.asarray(w), jq)
    tl = tdyn.quantization_loss(torch.from_numpy(w), tq)
    assert (tq.meta.fmt, tq.meta.group_size) == (jq.meta.fmt,
                                                 jq.meta.group_size), (
        f"margins to {thr:.3e}: JAX {jl - thr:+.3e}, port {tl - thr:+.3e}")
    assert abs(tl - jl) <= (1e-4 if svd else 1e-6) * jl, (tl, jl)
    assert dataclasses.asdict(tq.meta) == dataclasses.asdict(jq.meta)
    if not svd:
        np.testing.assert_array_equal(tq.qdata.numpy(), np.asarray(jq.qdata))
    return tq.meta.fmt


@pytest.mark.parametrize("nu", [None, 3, 2])
@pytest.mark.parametrize("start", ["int8", "uint4"])
def test_ladder_matches_jax(nu, start):
    """512 x 3072 weights scaled by 0.02 from default_rng(0)."""
    w = (tailed(np.random.default_rng(0), (512, 3072), nu)
         * 0.02).astype(np.float32)
    jq, tq = _pair(w, start)
    fmt = _same_choice(w, jq, tq, start)
    if nu is None:  # Gaussian weights keep the start format
        assert fmt == start


def test_ladder_svd_matches_jax():
    """uint4 + SVD rank 16 on a planted rank-16 signal over Student-t
    (nu 3) noise: above the spectral gap the factors, and so the residual
    that the ladder quantizes, agree between the packages' sketches."""
    rng = np.random.default_rng(1)
    u, _ = np.linalg.qr(rng.normal(size=(256, 16)))
    v, _ = np.linalg.qr(rng.normal(size=(512, 16)))
    w = ((u * np.linspace(8, 2, 16)) @ v.T
         + 0.02 * tailed(rng, (256, 512), 3)).astype(np.float32)
    jq, tq = _pair(w, "uint4", use_svd=True, svd_rank=16)
    _same_choice(w, jq, tq, "uint4", svd=True)
    assert tq.meta.svd_rank == 16 and tq.svd_up.shape == (256, 16)


def test_ladder_quantized_matmul_side_effects():
    """int8 with the quantized matmul on 128 x 1024 Student-t (nu 3)
    weights: the rung that passes cannot feed the matmul (a 9-bit float),
    so the layer is stored weight-only and named in
    modules_to_not_use_matmul."""
    w = (tailed(np.random.default_rng(0), (128, 1024), 3)
         * 0.02).astype(np.float32)
    jc, tc = J.QuantConfig(), T.QuantConfig()
    jq = jdyn.quantize_tensor_dynamic(jnp.asarray(w), "linear", fmt="int8",
                                      use_quantized_matmul=True, config=jc,
                                      param_name="a.weight")
    tq = tdyn.quantize_tensor_dynamic(torch.from_numpy(w), "linear",
                                      fmt="int8", use_quantized_matmul=True,
                                      config=tc, param_name="a.weight")
    _same_choice(w, jq, tq, "int8")
    assert tc.modules_to_not_use_matmul == jc.modules_to_not_use_matmul
    assert tc.modules_to_not_use_matmul == ["a.weight"]
    assert not tq.meta.use_quantized_matmul


_COMBOS = ["int8", "uint8", "int4", "uint4", "float8_e4m3fn", "float8_e5m2",
           "float9_e3m5fn", "float5_e2m2fn", "float6_e3m3fnu", "int12",
           "uint16", "float16", "int16"]


def test_matmul_combo_valid_table():
    for wf in _COMBOS:
        for mf in ("int8", "uint8", "float8_e4m3fn", "float16"):
            for rf in ("int8", "uint4", "float8_e4m3fn", "int16"):
                assert tdyn._matmul_combo_valid(wf, mf, rf) == \
                    jdyn._matmul_combo_valid(wf, mf, rf), (wf, mf, rf)
