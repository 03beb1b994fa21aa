"""B3 (flash_attention): the port's ``quantized_attention`` on the CPU (the
kernel's plain version, or ``attention_xla`` where the JAX route takes its
XLA function) against the JAX package's, in the bf16 mode
(matmul_dtype=None) and the int8-QK mode, at head dims 64 and 128.

* Against the JAX XLA fallback (fp32, ``exp``) at N = 96 (not a multiple
  of 128 keys, so both packages take the XLA function): the same fp32
  operations, the port's products in float64: rtol 1e-5 plus 2e-5 of
  max |out|.
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


# ---------------------------------------------------------------------------
# Head-mode int8 P·V and fp8 e4m3 Q·K against the JAX wrapper on both of its
# routes: KN 256 takes the Pallas body (interpret mode; P blocks of 256
# keys), KN 77 (the UNet's text tokens) the XLA function.  Grouped KV heads
# (4 query heads over 2) and a float additive mask (random, with a -inf
# hole) where a case says so.  Each row's error over that row's largest
# output.  Head mode quantizes P at the same points on both sides; where
# exp2 differs by an ulp between XLA and torch a code at a rounding tie
# moves by one step (1/127 of its key's weight), so its limit is token
# mode's, 4e-3 (measured at most 5.2e-7: no code moved).  e4m3 codes are
# exact in both packages, and the products summed in fp32 (JAX) and float64
# (the port) differ by fp32 rounding; with bf16 P·V (one P block of 256
# keys: P rounded to bf16 against the same max) measured at most 7.3e-5:
# 1e-3.
# ---------------------------------------------------------------------------

NEW_MODES = {
    "head_bf16_qk": dict(matmul_dtype=None, pv_matmul_dtype="int8"),
    "head_int8_qk": dict(matmul_dtype="int8", pv_matmul_dtype="int8"),
    "head_e4m3_qk": dict(matmul_dtype="fp8", pv_matmul_dtype="int8"),
    "e4m3_qk_bf16_pv": dict(matmul_dtype="float8_e4m3fn"),
    "e4m3_qk_token_pv": dict(matmul_dtype="fp8", pv_matmul_dtype="int8",
                             pv_scale_mode="token"),
    "head_gqa_float_mask": dict(matmul_dtype="int8", pv_matmul_dtype="int8",
                                gqa=True, float_mask=True),
    "e4m3_gqa_float_mask": dict(matmul_dtype="fp8", gqa=True,
                                float_mask=True),
    "head_e4m3_causal": dict(matmul_dtype="fp8", pv_matmul_dtype="int8",
                             is_causal=True),
}


@pytest.mark.parametrize("kn", [256, 77])
@pytest.mark.parametrize("mode", list(NEW_MODES))
def test_head_pv_and_e4m3_qk_against_jax(monkeypatch, mode, kn):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    kw = dict(NEW_MODES[mode])
    gqa, float_mask = kw.pop("gqa", False), kw.pop("float_mask", False)
    rng = np.random.default_rng(kn + len(mode))
    b, h, d = 1, 4, 64
    kh = 2 if gqa else h
    n = kn if kw.get("is_causal") else 32
    q = _bf16_exact(rng, (b, h, n, d))
    k = _bf16_exact(rng, (b, kh, kn, d))
    v = _bf16_exact(rng, (b, kh, kn, d))
    jkw, tkw = dict(kw), dict(kw)
    if float_mask:
        mask = _bf16_exact(rng, (b, 1, n, kn))
        mask[..., 3] = -np.inf
        jkw["attn_mask"], tkw["attn_mask"] = (jnp.asarray(mask),
                                              torch.from_numpy(mask))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if kw.get("matmul_dtype") is None:
        # bf16 operands (the kernel path casts them), the JAX fp32 output
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
        tkw["out_dtype"] = torch.float32
    ref = np.asarray(jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **jkw))
    out = tattn(tq, tk, tv, **tkw).float().numpy()
    assert np.isfinite(out).all()
    limit = 1e-3 if kw.get("pv_matmul_dtype") is None else 4e-3
    row_err = np.abs(out - ref).max(-1) / np.abs(ref).max(-1)
    assert row_err.max() <= limit, (row_err.max(), limit)


def test_head_mode_routes_and_counts():
    """Head mode takes the constant-p-scale body where the kernel route
    holds and the XLA function (counted in ``attention_xla.head_calls``)
    where it does not; an e4m3 Q·K quantizes to float8_e4m3fn codes."""
    from sdnq_tpu_torch.kernels import attention as ka
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_bf16_exact(rng, (1, 2, 16, 64)))
    k77 = torch.from_numpy(_bf16_exact(rng, (1, 2, 77, 64)))
    k128 = torch.from_numpy(_bf16_exact(rng, (1, 2, 128, 64)))
    calls, head_calls = ka.attention_xla.calls, ka.attention_xla.head_calls
    tattn(q, k128, k128, matmul_dtype="int8", pv_matmul_dtype="int8")
    assert ka.attention_xla.calls == calls
    tattn(q, k77, k77, matmul_dtype="fp8", pv_matmul_dtype="int8")
    assert ka.attention_xla.calls == calls + 1
    assert ka.attention_xla.head_calls == head_calls + 1
    tattn(q, k77, k77, matmul_dtype="fp8", pv_matmul_dtype="int8",
          pv_scale_mode="token")
    assert ka.attention_xla.head_calls == head_calls + 1


# ---------------------------------------------------------------------------
# The serving modes (masks, causal, grouped KV heads, int8 P·V in token
# mode) at KN = 1024, so that token mode has two P blocks of 512 keys,
# against the JAX package's Pallas body in interpret mode; decode (N = 1)
# against its XLA function.  The mask is the LLM's prefill mask with random
# holes (about half the keys hidden), so a version that ignored it would
# move every row.  Each row's error is held against that row's largest
# output: under a causal or prefill mask the first rows attend a few keys
# and their outputs are far larger than the rows that attend a thousand, so
# a limit on the largest output overall would not see a row misweighted.
# bf16 P (bf16 or int8 Q·K) is rounded against a running max in the JAX
# kernel and the final max in the port's plain version (measured up to
# 5.0e-3 of a row's largest output): 1.5e-2.  Token-mode P·V quantizes at
# the same points on both sides, but where exp2 differs by an ulp between
# XLA and torch a P code at a rounding tie moves by one step and its
# output by p_scale·|v|/l (measured up to 1.8e-3): 4e-3.
# ---------------------------------------------------------------------------

B, H, KH, D, KN = 2, 4, 2, 128, 1024


def _bf16_exact(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _cache_mask(n, kn, offset):
    """The LLM's prefill mask key_pos <= q_pos for queries at offset ..
    offset + n - 1, shape (B, 1, N, KN)."""
    q_pos = offset + np.arange(n)
    m = np.arange(kn)[None, :] <= q_pos[:, None]
    return np.broadcast_to(m[None, None], (B, 1, n, kn)).copy()


MODES = {
    "mask_bf16": dict(matmul_dtype=None),
    "mask_int8_qk": dict(matmul_dtype="int8"),
    "mask_token_pv": dict(matmul_dtype="int8", pv_matmul_dtype="int8",
                          pv_scale_mode="token"),
    "mask_int8_kv_cache": dict(kv_scales=True),
    "causal_bf16": dict(matmul_dtype=None, is_causal=True),
    "causal_int8_qk": dict(matmul_dtype="int8", is_causal=True),
    "causal_token_pv": dict(matmul_dtype="int8", is_causal=True,
                            pv_matmul_dtype="int8", pv_scale_mode="token"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_modes_against_kernel_interpret(monkeypatch, mode):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    kw = dict(MODES[mode])
    rng = np.random.default_rng(len(mode))
    causal = kw.get("is_causal", False)
    n = 256 if causal else 64
    kn = n if causal else KN
    q = _bf16_exact(rng, (B, H, n, D))
    k = _bf16_exact(rng, (B, KH, kn, D))
    v = _bf16_exact(rng, (B, KH, kn, D))
    jkw, tkw = dict(kw), dict(kw)
    if not causal:
        mask = _cache_mask(n, kn, kn - n - 8) & (rng.random((B, 1, n, kn))
                                                  < 0.5)
        mask[..., 0] = True
        jkw["attn_mask"] = jnp.asarray(mask)
        tkw["attn_mask"] = torch.from_numpy(mask)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if kw.pop("kv_scales", None):
        from sdnq_tpu.kernels.attention import quantize_kv as jqkv
        from sdnq_tpu_torch.kernels.attention import quantize_kv as tqkv
        jk, jks, jv, jvs = jqkv(jk, jv)
        tk, tks, tv, tvs = tqkv(tk, tv)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jkw["kv_scales"], tkw["kv_scales"] = (jks, jvs), (tks, tvs)
    if kw.get("matmul_dtype", "int8") is None:
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
    ref = np.asarray(jattn(jq, jk, jv, **jkw))
    out = tattn(tq, tk, tv, **tkw).float().numpy()
    limit = 4e-3 if "token" in mode or "kv_cache" in mode else 1.5e-2
    row_err = np.abs(out - ref).max(-1) / np.abs(ref).max(-1)
    assert row_err.max() <= limit, (row_err.max(), limit)


def test_token_mode_p_block_is_part_of_the_function():
    """P quantized per 64-key tile instead of per 512-key P block moves the
    output by percents of max |out|: the P block must be the JAX one."""
    from sdnq_tpu_torch.kernels.attention import attn_p_block
    from sdnq_tpu_torch.quant.core import quantize_int_mm
    assert [attn_p_block(kn) for kn in (128, 384, 1024, 1152, 4096)] == \
        [128, 384, 512, 128, 512]
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(B * H, 64, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B * KH, KN, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B * KH, KN, D)).astype(np.float32))
    qq, qs = quantize_int_mm(q)
    kq, ks = quantize_int_mm(k)
    vq, vs = quantize_int_mm(v)
    mask = torch.from_numpy(_cache_mask(64, KN, KN - 72))
    args = (qq, kq, vq, qs[..., 0] * 0.1, ks[..., 0])
    a, b = (flash_attention_plain(*args, out_dtype=torch.float32, heads=H,
                                  mask=mask, v_scale=vs[..., 0], p_block=pb)
            for pb in (512, 64))
    assert float((a - b).abs().max() / a.abs().max()) > 1e-2


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_against_attn_xla(kv):
    """N = 1 fails the kernel predicate on both sides: the port's
    attention_xla against the JAX XLA function, on the full cache with its
    mask.  The JAX model repeats the 2 KV heads; the port reads them
    grouped.  fp32 softmax on both sides (int8: the same integer dots):
    1e-5 of max |out|."""
    rng = np.random.default_rng(6 + (kv == "int8"))
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, KH, KN, D)).astype(np.float32)
    v = rng.normal(size=(B, KH, KN, D)).astype(np.float32)
    mask = np.arange(KN)[None, None, None, :] <= np.array(
        [700, 900])[:, None, None, None]
    rep = lambda a: jnp.repeat(a, H // KH, axis=1)  # noqa: E731
    if kv == "int8":
        from sdnq_tpu.kernels.attention import quantize_kv as jqkv
        from sdnq_tpu_torch.kernels.attention import quantize_kv as tqkv
        jk, jks, jv, jvs = jqkv(jnp.asarray(k), jnp.asarray(v))
        ref = jattn(jnp.asarray(q), rep(jk), rep(jv),
                    attn_mask=jnp.asarray(mask),
                    kv_scales=(rep(jks), rep(jvs)))
        tk, tks, tv, tvs = tqkv(torch.from_numpy(k), torch.from_numpy(v))
        out = tattn(torch.from_numpy(q), tk, tv,
                    attn_mask=torch.from_numpy(mask), kv_scales=(tks, tvs))
    else:
        ref = jattn(jnp.asarray(q), rep(jnp.asarray(k)), rep(jnp.asarray(v)),
                    attn_mask=jnp.asarray(mask), matmul_dtype=None)
        out = tattn(*(torch.from_numpy(a) for a in (q, k, v)),
                    attn_mask=torch.from_numpy(mask), matmul_dtype=None)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_head_broadcast_mask_equals_full_mask():
    """A (B, 1, N, KN) mask read through its strides gives what the same
    mask materialised per head gives."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, H, 64, D), (B, KH, 256, D), (B, KH, 256, D)))
    m = torch.from_numpy(rng.random((B, 1, 64, 256)) < 0.7)
    m[..., 0] = True
    a = tattn(q, k, v, attn_mask=m, matmul_dtype="int8")
    b = tattn(q, k, v, attn_mask=m.expand(B, H, 64, 256).clone(),
              matmul_dtype="int8")
    assert torch.equal(a, b)
