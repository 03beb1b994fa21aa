"""B3 (flash_attention): the port's ``quantized_attention`` on the CPU (the
kernel's plain version) against the JAX package's, in the bf16 mode
(matmul_dtype=None) and the int8-QK mode, at head dims 64 and 128.

* Against the JAX XLA fallback (fp32, ``exp``): the port keeps fp32
  operands on the CPU and differs only by folding sm_scale·log2(e) into q
  and using ``exp2``: rtol 1e-5 plus 2e-5 of max |out|.
* Against the JAX Pallas kernel body in interpret mode, which casts q, k, v
  and P to bf16: inputs are bf16-representable and the port gets bf16
  tensors (bf16 mode) so q and k round identically; P is rounded to bf16
  against a running max in the kernel and a global max in the plain
  version, and the output is bf16, so the bound is 1e-2 of max |v|."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.kernels.attention import quantized_attention as jattn
from sdnq_tpu_torch.kernels.attention import (
    flash_attention_plain, quantized_attention as tattn,
)


def _qkv(d, n=128, b=1, h=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.normal(size=(b, h, n, d)).astype(np.float32)
        # bf16-representable values, so a bf16 cast is exact on both sides
        out.append(torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    return out


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode,prep", [
    (None, {}), ("int8", {}),
    ("int8", dict(smooth_k=True, use_hadamard=True))])
def test_against_xla_fallback(monkeypatch, d, mode, prep):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "xla")
    q, k, v = _qkv(d, n=96)
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           matmul_dtype=mode, **prep))
    out = tattn(torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v), matmul_dtype=mode, **prep).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", [None, "int8"])
def test_against_kernel_interpret(monkeypatch, d, mode):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    q, k, v = _qkv(d, seed=1)
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           matmul_dtype=mode))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if mode is None:  # bf16 operands, as the JAX kernel path casts them
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
    out = tattn(tq, tk, tv, matmul_dtype=mode).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-2 * np.abs(v).max())


def test_auto_policy_and_kv_prequant():
    from sdnq_tpu.kernels.attention import (
        attn_auto_matmul_dtype as jauto, quantize_kv as jqkv)
    from sdnq_tpu_torch.kernels.attention import (
        attn_auto_matmul_dtype as tauto, quantize_kv as tqkv)
    for n, kn, d in [(4096, 4096, 64), (4608, 4608, 128), (64, 64, 64),
                     (8192, 2048, 32)]:
        assert tauto(n, kn, d) == jauto(n, kn, d)
    q, k, v = _qkv(64, n=64, seed=2)
    jk, jks = jqkv(jnp.asarray(k))
    tk, tks = tqkv(torch.from_numpy(k))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    out = tattn(torch.from_numpy(q), tk.float(), torch.from_numpy(v),
                kv_scales=(tks, None)).numpy()
    ref = tattn(torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v), matmul_dtype="int8").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_plain_version_is_softmax_attention():
    """flash_attention_plain on pre-scaled fp32 q against a float64
    softmax(q k^T) v in base e (q pre-multiplied by log2 e)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(3, 40, 64)) for _ in range(3))
    s = q @ k.transpose(0, 2, 1)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = (p / p.sum(-1, keepdims=True)) @ v
    out = flash_attention_plain(
        torch.from_numpy(q * np.log2(np.e)).float(),
        torch.from_numpy(k).float(), torch.from_numpy(v).float(),
        out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(is_causal=True),
                                dict(pv_matmul_dtype="int8"),
                                dict(matmul_dtype="fp8")])
def test_later_slice_modes_raise(kw):
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(NotImplementedError):
        tattn(q, q, q, **kw)
    with pytest.raises(NotImplementedError):  # grouped KV heads
        tattn(q, q[:, :1], q[:, :1], matmul_dtype=None)
