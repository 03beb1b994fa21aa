"""Three small functions against the JAX package on the same numpy inputs:
``packing.quantize_to_float_format`` (bit-equal: the same integer codec),
``quant.core.dequantize_values`` (bit-equal: one multiply and one add in
the scale's dtype) and ``models.common.mlp_forward``: a plain fp32 MLP
(fp32 sums in another order: 1e-5 of max |out|, measured 4.2e-7) and an
int8 weight-only one, whose hidden state is the QTensor's bf16 output and
whose activation runs on bf16 (XLA rounds each of the activation's steps
to bf16, torch rounds once): 2^-7 of max |out| (measured 3.6e-3)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu import get_format as jfmt
from sdnq_tpu.models.common import mlp_forward as jmlp
from sdnq_tpu.packing import quantize_to_float_format as jq2f
from sdnq_tpu.quant import dequantize_values as jdeq
from sdnq_tpu.tensor import quantize_tensor as jquant
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.formats import get_format as tfmt
from sdnq_tpu_torch.models.common import gelu, mlp_forward as tmlp, silu
from sdnq_tpu_torch.packing import quantize_to_float_format as tq2f
from sdnq_tpu_torch.quant import dequantize_values as tdeq


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2",
                                  "float6_e3m2fn", "float5_e2m2fn",
                                  "float12_e5m6fn"])
def test_quantize_to_float_format_matches_jax(name):
    f = tfmt(name)
    x = np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32)
    x = np.clip(x * f.max / 3.0, f.min, f.max).astype(np.float32)
    x[0, :4] = [0.0, f.max, f.min, 1e-30]
    got = tq2f(torch.from_numpy(x), f).numpy()
    want = np.asarray(jq2f(jnp.asarray(x), jfmt(name)))
    np.testing.assert_array_equal(got, want)
    # a value on the grid stays as it is
    np.testing.assert_array_equal(tq2f(torch.from_numpy(got), f).numpy(), got)


@pytest.mark.parametrize("zp", [False, True])
@pytest.mark.parametrize("qdtype", [np.int8, np.uint8])
def test_dequantize_values_matches_jax(zp, qdtype):
    rng = np.random.default_rng(1)
    q = rng.integers(0, 127, size=(32, 4, 16)).astype(qdtype)
    s = rng.random((32, 4, 1)).astype(np.float32) * 0.01
    z = rng.normal(size=(32, 4, 1)).astype(np.float32) if zp else None
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16,
                                                   torch.bfloat16)):
        want = np.asarray(jdeq(jnp.asarray(q), jnp.asarray(s),
                               None if z is None else jnp.asarray(z), dt),
                          np.float32)
        got = tdeq(torch.from_numpy(q), torch.from_numpy(s),
                   None if z is None else torch.from_numpy(z), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_forward_matches_jax(quantized, act):
    import jax
    rng = np.random.default_rng(2)
    w1 = rng.normal(size=(96, 48)).astype(np.float32) / 7
    w2 = rng.normal(size=(48, 96)).astype(np.float32) / 10
    b1 = rng.normal(size=(96,)).astype(np.float32)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    jp = {"fc1": {"weight": jnp.asarray(w1), "bias": jnp.asarray(b1)},
          "fc2": {"weight": jnp.asarray(w2)}}
    if quantized:
        for k in jp:
            jp[k]["weight"] = jquant(jp[k]["weight"], "int8", "linear")
    tp = params_from_numpy(jp, "cpu")
    jact = (lambda h: jax.nn.gelu(h, approximate=True)) if act == "gelu" \
        else jax.nn.silu
    want = np.asarray(jmlp(jp, jnp.asarray(x), act=jact,
                           out_dtype=jnp.float32), np.float32)
    got = tmlp(tp, torch.from_numpy(x), act=gelu if act == "gelu" else silu,
               out_dtype=torch.float32)
    assert got.shape == (2, 5, 48)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5 if not quantized else err <= 2 ** -7
