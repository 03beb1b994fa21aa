"""B3 at head dims other than 64 and 128, and at a value head dim other than
the query's, on the CPU: ``quantized_attention`` (the kernel route, its
plain version) against the JAX package's, whose wrapper pads q, k and v to
max(128, pow2(D)) before its Pallas body (interpret mode) and slices the
output back to v's head dim.  On the card the port pads to the next of 64,
128 and 256 (``kernel_head_dim``); the padding's exactness is checked here
on the plain version: padded operands give the unpadded function.

Tolerances, per row over the row's largest output, as
``test_torch_attention.py``'s interpret comparisons: bf16 P·V 1e-2 of max
|v| (P rounded to bf16 against a running max in the JAX kernel, the
final max in the plain version), 1e-3 with int8 Q·K and bf16 P·V (the
same codes), 4e-3 in token and head mode (P's codes at ties).  Padding:
the int8 products in float64 are exact (bit-equal); the bf16 ones are fp32
sums over more zero terms (rtol 1e-6)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.kernels.attention import quantized_attention as jattn
from sdnq_tpu_torch.kernels.attention import (
    _pad_head, flash_attention_plain, kernel_head_dim,
    quantized_attention as tattn,
)
from sdnq_tpu_torch.quant.core import quantize_int_mm

MODES = {"bf16": dict(matmul_dtype=None),
         "int8": dict(matmul_dtype="int8"),
         "token": dict(matmul_dtype="int8", pv_matmul_dtype="int8",
                       pv_scale_mode="token"),
         "head": dict(matmul_dtype="int8", pv_matmul_dtype="int8")}
LIMIT = {"bf16": 1e-2, "int8": 1e-3, "token": 4e-3, "head": 4e-3}


def _bf16_exact(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _compare(d, vd, mode, n=64, kn=128, seed=0):
    kw = MODES[mode]
    rng = np.random.default_rng(seed + d + vd)
    q = _bf16_exact(rng, (1, 2, n, d))
    k = _bf16_exact(rng, (1, 2, kn, d))
    v = _bf16_exact(rng, (1, 2, kn, vd))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tkw = dict(kw)
    if kw["matmul_dtype"] is None:
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
        tkw["out_dtype"] = torch.float32
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw), np.float32)
    out = tattn(tq, tk, tv, **tkw).float().numpy()
    assert out.shape == (1, 2, n, vd) == ref.shape
    if mode == "bf16":
        err = np.abs(out - ref).max() / np.abs(v).max()
    else:
        err = (np.abs(out - ref).max(-1) / np.abs(ref).max(-1)).max()
    assert err <= LIMIT[mode], (d, vd, mode, err)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d", [32, 100, 160])
def test_head_dims_against_jax_kernel(monkeypatch, d, mode):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    _compare(d, d, mode)


@pytest.mark.parametrize("mode", ["bf16", "int8", "token"])
def test_value_head_dim_differs(monkeypatch, mode):
    """q and k at head dim 64, v at 96: the output takes v's head dim."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    _compare(64, 96, mode)


def test_kernel_head_dim():
    assert [kernel_head_dim(d) for d in (1, 32, 64, 65, 100, 128, 129, 160,
                                         256)] == [64, 64, 64, 128, 128, 128,
                                                   256, 256, 256]
    assert kernel_head_dim(257) is None


@pytest.mark.parametrize("pv", ["bf16", "token", "head"])
@pytest.mark.parametrize("d,vd", [(100, 100), (160, 160), (64, 96), (40, 24)])
def test_zero_padding_is_exact(d, vd, pv):
    """The plain version on q, k, v padded to the kernel's head dim, its
    output cut back to v's head dim, equals it on the unpadded operands
    (int8 Q·K: the per-token scales taken before the padding)."""
    g = torch.Generator().manual_seed(d * 7 + vd)
    bh, n, kn = 4, 64, 128
    q, k = (torch.randn(bh, x, d, generator=g) for x in (n, kn))
    v = torch.randn(bh, kn, vd, generator=g)
    (qq, qs), (kq, ks) = quantize_int_mm(q), quantize_int_mm(k)
    args = [qq, kq, None, qs[..., 0] * (d ** -0.5), ks[..., 0]]
    kw = {}
    if pv == "bf16":
        args[2] = v.bfloat16()
    elif pv == "token":
        vq, vs = quantize_int_mm(v)
        args[2], kw = vq, dict(v_scale=vs[..., 0], p_block=128)
    else:
        vs = v.abs().amax((1, 2)) / 127.0
        args[2] = torch.round(v / vs[:, None, None]).to(torch.int8)
        kw = dict(v_head_scale=vs, p_block=128)
    want = flash_attention_plain(*args, out_dtype=torch.float32, **kw)
    dk = kernel_head_dim(max(d, vd))
    padded = [_pad_head(t, dk) for t in args[:3]] + args[3:]
    assert padded[0].shape[-1] == dk and padded[2].shape[-1] == dk
    got = flash_attention_plain(*padded, out_dtype=torch.float32,
                                **kw)[..., :vd]
    assert torch.equal(got, want)


def test_softmax_scale_is_the_callers(monkeypatch):
    """At head dim 100 the softmax scale is 100^-0.5, not the padded
    128^-0.5: the JAX package's output, and the padded dim's scale misses
    it by far."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    rng = np.random.default_rng(3)
    q, k, v = (_bf16_exact(rng, (1, 2, x, 100)) for x in (64, 128, 128))
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           matmul_dtype="int8"), np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    good = tattn(tq, tk, tv, matmul_dtype="int8").float().numpy()
    bad = tattn(tq, tk, tv, matmul_dtype="int8",
                scale=kernel_head_dim(100) ** -0.5).float().numpy()
    lim = 1e-3 * np.abs(ref).max()
    assert np.abs(good - ref).max() <= lim
    assert np.abs(bad - ref).max() > 10 * lim
