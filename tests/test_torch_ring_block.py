"""B9 (flash_attention_block): the port's block function on the CPU against
the JAX package's, on the same seeded numpy inputs.

* The kernel route (N % 8, KN % 128, D % 128 all 0): the port's plain
  version against the JAX Pallas body (``_attn_kernel`` with
  ``partial_out=True``) in interpret mode, at BH 4, N 256, KN 256, D 128
  (one KV block) and at KN 1024 (two blocks of 512, so the online softmax
  and the token mode's per-block P quantization run between blocks); bf16,
  int8 and int8 + token-mode P·V, and e4m3 Q·K with bf16 and token-mode
  P·V (e4m3 values exact on both sides, the products summed in fp32 by
  JAX and in float64 by the port); no mask, a full mask, the triangle, and
  random holes with one row hidden everywhere (m = -1e30, every p = 1, l =
  KN).  The int8 scores are the same exact integer products times the same
  fp32 scales on both sides, so m agrees to rounding; bf16 scores sum the
  same bf16 products in another order.  Limits: m within 1e-5 (bf16) or
  1e-6 (int8) of max |s| ≈ 5; l within 1e-5 relative (fp32 sums of up to
  1024 terms in another order); acc / l per row within 4e-3 of that row's
  largest output.  P is rounded (to bf16, or to token-mode codes) at the
  same points on both sides, so most rows agree to 1e-6; where exp differs
  by an ulp between XLA and torch, a p at a rounding tie moves by one step
  (measured up to 1.8e-3 of a row's largest output with bf16 P; as for B3
  in ``test_torch_attention.py``).
* The XLA route (D 64, or KN % 128 != 0): ``attention_block_xla`` against
  ``_attn_block_xla``, both in fp32 (the port's products in float64):
  1e-5 relative."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.kernels.attention import flash_attention_block as jblock
from sdnq_tpu_torch.kernels.attention import (
    attention_block_xla, block_kernel_route, flash_attention_block,
    flash_attention_block_plain,
)

MODES = ("bf16", "int8", "int8_token_pv", "e4m3", "e4m3_token_pv")
MASKS = (None, "full", "triangle", "holes_false_row")


def _inputs(mode, bh, n, kn, d, mask_kind, seed):
    """numpy inputs of both packages' block functions, and their kwargs."""
    rng = np.random.default_rng(seed)
    sm = d ** -0.5
    quantized = mode != "bf16"
    pv = mode.endswith("token_pv")
    if mode.startswith("e4m3"):  # e4m3 values, as fp32 (exact)
        q, k = (torch.randn(s, generator=torch.Generator().manual_seed(seed))
                .mul(64).to(torch.float8_e4m3fn).float().numpy()
                for s in ((bh, n, d), (bh, kn, d)))
    if quantized:
        if not mode.startswith("e4m3"):
            q = rng.integers(-127, 128, (bh, n, d)).astype(np.int8)
            k = rng.integers(-127, 128, (bh, kn, d)).astype(np.int8)
        qs = (rng.random((bh, n)) * 0.02 + 0.005).astype(np.float32) * sm
        ks = (rng.random((bh, kn)) * 0.02 + 0.005).astype(np.float32)
    else:
        q, k = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .to(torch.bfloat16).float().numpy()
                for s in ((bh, n, d), (bh, kn, d)))
        qs = ks = None
    if pv:
        v = rng.integers(-127, 128, (bh, kn, d)).astype(np.int8)
        vs = (rng.random((bh, kn)) * 0.02 + 0.005).astype(np.float32)
    else:
        v = torch.from_numpy(rng.normal(size=(bh, kn, d)).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
        vs = None
    mask = None
    if mask_kind == "full":
        mask = np.ones((1, n, kn), np.int8)
    elif mask_kind == "triangle":
        mask = (np.arange(n)[:, None] >= np.arange(kn)[None, :]).astype(
            np.int8)[None]
    elif mask_kind == "holes_false_row":
        mask = (rng.random((bh, n, kn)) < 0.5).astype(np.int8)
        mask[:, :, 0] = 1
        mask[1, 7] = 0          # one row of one head hidden everywhere
    kw = dict(quantized=quantized, quantized_pv=pv, sm_scale=sm)
    return (q, k, v, qs, ks, vs, mask), kw


def _jax_args(args, mode):
    q, k, v, qs, ks, vs, mask = args
    cast = (lambda a: jnp.asarray(a, jnp.bfloat16))
    jq, jk = ((jnp.asarray(q), jnp.asarray(k)) if mode != "bf16"
              else (cast(q), cast(k)))
    if mode.startswith("e4m3"):
        jq, jk = (a.astype(jnp.float8_e4m3fn) for a in (jq, jk))
    jv = jnp.asarray(v) if mode.endswith("token_pv") else cast(v)
    opt = (lambda a: None if a is None else jnp.asarray(a))
    return (jq, jk, jv, opt(qs), opt(ks), opt(vs), opt(mask))


def _torch_args(args, mode):
    q, k, v, qs, ks, vs, mask = args
    t = (lambda a: None if a is None else torch.from_numpy(a))
    tq, tk = t(q), t(k)
    if mode == "bf16":
        tq, tk = tq.to(torch.bfloat16), tk.to(torch.bfloat16)
    if mode.startswith("e4m3"):
        tq, tk = tq.to(torch.float8_e4m3fn), tk.to(torch.float8_e4m3fn)
    tv = t(v) if mode.endswith("token_pv") else t(v).to(torch.bfloat16)
    return (tq, tk, tv, t(qs), t(ks), t(vs), t(mask))


def _compare(got, want, mode, kernel_route):
    acc, m, l = (np.asarray(a, np.float64) for a in got)
    jacc, jm, jl = (np.asarray(a, np.float64) for a in want)
    assert acc.shape == jacc.shape and m.shape == jm.shape == l.shape
    ms = np.abs(jm[jm > -1e29]).max()
    if kernel_route:
        m_tol = (1e-6 if mode != "bf16" else 1e-5) * ms
        out_tol = 4e-3
    else:
        m_tol, out_tol = 1e-5 * ms, 1e-5
    assert np.abs(m - jm).max() <= m_tol, np.abs(m - jm).max()
    assert (np.abs(l - jl) / jl).max() <= 1e-5
    out, jout = acc / l, jacc / jl
    row = np.abs(out - jout).max(-1) / np.abs(jout).max(-1)
    assert row.max() <= out_tol, (row.max(), out_tol)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_against_kernel_interpret(monkeypatch, mode, mask_kind):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    bh, n, kn, d = 4, 256, 256, 128
    assert block_kernel_route(n, kn, d)
    args, kw = _inputs(mode, bh, n, kn, d, mask_kind,
                       seed=MODES.index(mode) * 10 + MASKS.index(mask_kind))
    want = jblock(*_jax_args(args, mode), **kw)
    got = flash_attention_block(*_torch_args(args, mode), **kw)
    _compare(got, want, mode, kernel_route=True)
    if mask_kind == "holes_false_row":  # the hidden row: m = -1e30, l = KN
        acc, m, l = got
        assert m[1, 7, 0] == torch.tensor(-1e30) and l[1, 7, 0] == kn
        v = _torch_args(args, mode)[2].double()
        if mode == "bf16":  # every p = 1: acc is the sum of v
            torch.testing.assert_close(acc[1, 7].double(), v[1].sum(0),
                                       rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "int8_token_pv"])
def test_plain_against_kernel_interpret_two_blocks(monkeypatch, mode):
    """KN 1024: two KV blocks of 512 keys, the online softmax between them
    and token-mode P quantized once per block."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    bh, n, kn, d = 2, 64, 1024, 128
    args, kw = _inputs(mode, bh, n, kn, d, "holes_false_row", seed=70)
    want = jblock(*_jax_args(args, mode), **kw)
    got = flash_attention_block_plain(*_torch_args(args, mode), **kw)
    _compare(got, want, mode, kernel_route=True)


@pytest.mark.parametrize("shape", [(4, 64, 64, 64), (4, 128, 96, 128),
                                   (2, 12, 256, 128)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mask_kind", [None, "triangle", "holes_false_row"])
def test_xla_route_against_attn_block_xla(monkeypatch, shape, mode,
                                          mask_kind):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "xla")
    bh, n, kn, d = shape
    assert not block_kernel_route(n, kn, d)
    args, kw = _inputs(mode, bh, n, kn, d, mask_kind, seed=sum(shape))
    want = jblock(*_jax_args(args, mode), **kw)
    before = attention_block_xla.calls
    got = flash_attention_block(*_torch_args(args, mode), **kw)
    assert attention_block_xla.calls == before + 1
    _compare(got, want, mode, kernel_route=False)


def test_additive_mask_and_route_counts():
    """A float mask is added to the scores in both routes (the JAX block
    functions' ``mask_is_bool=False``); the kernel route's plain version
    and the XLA function agree on one block of up to 512 keys up to bf16
    P rounding, and the CPU launches no kernel."""
    rng = np.random.default_rng(3)
    bh, n, kn, d = 2, 16, 128, 128
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(
        np.float32)).to(torch.bfloat16) for s in (n, kn, kn))
    bias = torch.from_numpy(rng.normal(size=(1, n, kn)).astype(np.float32))
    kw = dict(quantized=False, sm_scale=d ** -0.5, mask_is_bool=False)
    launches = flash_attention_block.launches
    acc, m, l = flash_attention_block(q, k, v, mask=bias, **kw)
    xacc, xm, xl = attention_block_xla(q, k, v, mask=bias, **kw)
    assert flash_attention_block.launches == launches
    torch.testing.assert_close(m, xm, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l, xl, rtol=1e-5, atol=0)
    torch.testing.assert_close(acc / l, xacc / xl, rtol=0, atol=1e-2)
    nob = flash_attention_block(q, k, v, **kw)
    assert float((nob[1] - m).abs().max()) > 0.1   # the bias moved m
