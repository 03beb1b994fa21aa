"""Host-side pieces of the token-mode attention kernel and of B2's GEMV
(``csrc/flash_attn.cuh``, ``csrc/dequant_gemv.cu``), on the CPU.

* The V^T layout (``_vt_key``, ``_token_vt_plain``: copies of
  ``flash_attn.cuh``'s ``vt_key`` and ``flash_attn_vt_kernel``, which own
  it; the card tests check the kernel's): a permutation of each 16 keys,
  under which the s8 ``wgmma``'s A registers filled from the scores'
  accumulator layout multiply V as P @ V in natural order.
* The kernel's pass scheme over a P block (64-key tiles: scores and row
  max, then p, l, p_eff and its max, then P codes by the multiply with
  the division's fallback, summed against V^T's slots), emulated in torch:
  equal to ``flash_attention_plain`` but for the order of l's sum (1e-5 of
  each row's largest output), and against the JAX package's Pallas body in
  interpret mode at the port's limit for token mode (4e-3 of each row's
  largest output, ``tests/test_torch_attention.py``).
* The quantization shortcut (``quant_fast``), in numpy float32: the same
  codes as rint(e / sc) over random values and values next to half-integers.
* The GEMV's code decode through the fp32 magic number, and the wrapper's
  alignment copies.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.kernels.attention import quantized_attention as jattn
from sdnq_tpu_torch.kernels import attention as ka
from sdnq_tpu_torch.kernels import dequant_mm as kd

MAGIC = np.float32(12582912.0)  # 1.5 * 2^23


def _vt_key(kn: int):
    """The key that each slot of the token kernel's V^T holds, for KN keys
    (``vt_key`` in ``csrc/flash_attn.cuh``): within each 16, slot 4 q + i
    holds key 2 q + (i & 1) + 8 (i >> 1) (q, i < 4).  The s8 ``wgmma``'s A
    operand from registers gives thread q of a row's quad the P of slots
    4 q .. 4 q + 3 of each 16-key half of a k32 step; the scores'
    accumulator gives it keys 2 q, 2 q + 1, 8 + 2 q, 9 + 2 q of each 16."""
    pos = torch.arange(kn)
    return ((pos & ~15) + 2 * ((pos & 15) >> 2) + (pos & 1)
            + 8 * ((pos >> 1) & 1))


def _token_vt_plain(v):
    """The V^T that ``flash_attn_vt_kernel`` writes once a token-mode call:
    v (BKH, KN, D) int8 -> (BKH, D, KN), keys in ``_vt_key``'s order."""
    return v[:, _vt_key(v.shape[1])].transpose(1, 2).contiguous()


@pytest.mark.parametrize("kn", [16, 64, 192, 1024])
def test_vt_key_permutes_each_16_keys(kn):
    key = _vt_key(kn)
    assert sorted(key.tolist()) == list(range(kn))
    assert torch.equal(key // 16, torch.arange(kn) // 16)
    assert key[:16].tolist() == [0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13,
                                 6, 7, 14, 15]


def test_token_vt_plain_layout():
    g = torch.Generator().manual_seed(0)
    v = torch.randint(-128, 128, (3, 192, 64), generator=g, dtype=torch.int8)
    vt = _token_vt_plain(v)
    assert vt.shape == (3, 64, 192) and vt.is_contiguous()
    key = _vt_key(192)
    for pos in (0, 5, 17, 100, 191):
        assert torch.equal(vt[:, :, pos], v[:, key[pos], :])


def _a_from_registers(codes):
    """The 64 x 64 A operand (rows x V^T slots) that the kernel's A
    registers hold for one tile of P codes (64 rows x 64 keys): thread
    (warp w, lane 4 g + t) holds the scores' accumulator values s[4 j + i]
    of row 16 w + g + 8 (i >> 1), key 8 j + 2 t + (i & 1), and packs
    pa[kk][2 h + rr] = bytes of s[4 j + 2 rr], s[4 j + 2 rr + 1], s[4 j + 4 +
    2 rr], s[4 j + 5 + 2 rr] with j = 4 kk + 2 h; wgmma reads register r of
    step kk as row 16 w + g + 8 (r & 1), slots 32 kk + 16 (r >> 1) + 4 t + b
    (byte b), as mma.sync m16n8k32's A."""
    a = torch.full((64, 64), 999, dtype=torch.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3

            def s(idx):
                j, i = idx // 4, idx % 4
                return codes[16 * w + g + 8 * (i >> 1), 8 * j + 2 * t + (i & 1)]
            for kk in range(2):
                for h in range(2):
                    for rr in range(2):
                        j = 4 * kk + 2 * h
                        vals = [s(4 * j + 2 * rr), s(4 * j + 2 * rr + 1),
                                s(4 * j + 4 + 2 * rr), s(4 * j + 5 + 2 * rr)]
                        r = 2 * h + rr
                        for b, val in enumerate(vals):
                            a[16 * w + g + 8 * (r & 1),
                              32 * kk + 16 * (r >> 1) + 4 * t + b] = val
    assert (a != 999).all()
    return a


def test_registers_times_vt_slots_is_p_times_v():
    g = torch.Generator().manual_seed(1)
    codes = torch.randint(0, 128, (64, 64), generator=g)
    v = torch.randint(-128, 128, (1, 64, 128), generator=g, dtype=torch.int8)
    a = _a_from_registers(codes)
    vt = _token_vt_plain(v)[0].long()          # (D, slots)
    assert torch.equal(a @ vt.T, codes @ v[0].long())


def _quant_fast(e, sc, inv):
    """The kernel's quant_fast (with quant_div where it sets ``near``) in
    torch float32, each op rounded once."""
    y = e * inv
    r = y + 12582912.0
    n = r - 12582912.0
    near = (y - n).abs() > 0.499975
    return torch.where(near, torch.round(e / sc), n)


def _token_emulation(q, k, v, qs, ks, vs, heads, mask, causal, p_block):
    """The token kernel's passes in torch (int8 Q.K^T): 64-key tiles, the
    block's row max, p = exp2(s - m_new), l summed a tile at a time, p_eff =
    p vs, p_scale = max(p_eff) / 127 and its rounded reciprocal, the codes
    by ``_quant_fast``, put in V^T's slot order and summed against V^T."""
    bh, n, d = q.shape
    bkh, kn = k.shape[:2]
    qpk = bh // bkh
    k, v = ka._expand_kv(k, qpk), ka._expand_kv(v, qpk)
    ks, vs = ka._expand_kv(ks, qpk), ka._expand_kv(vs.float(), qpk)
    s = (q.double() @ k.double().transpose(1, 2)).float()
    s = s * qs[..., None] * ks[:, None, :]
    s = ka._mask_scores(s, bh // heads, heads, mask, causal, ka.LOG2E)
    vt = _token_vt_plain(v).double()             # (BH, D, KN), slots
    key = _vt_key(kn)
    m = torch.full((bh, n, 1), -1e30)
    l = torch.zeros((bh, n, 1))
    o = torch.zeros((bh, n, d))
    for pb0 in range(0, kn, p_block):
        tiles = range(pb0, pb0 + p_block, 64)
        mx = torch.stack([s[..., t:t + 64].amax(-1) for t in tiles]).amax(0)
        mn = torch.maximum(m, mx[..., None])
        al = torch.exp2(m - mn)
        ps = torch.zeros_like(l)
        pm = torch.zeros_like(l)
        effs = []
        for t in tiles:
            p = torch.exp2(s[..., t:t + 64] - mn)
            ps = ps + p.sum(-1, keepdim=True)
            e = p * vs[:, None, t:t + 64]
            pm = torch.maximum(pm, e.amax(-1, keepdim=True))
            effs.append(e)
        l = l * al + ps
        sc = torch.clamp_min(pm, 1e-20) / torch.tensor(127.0)
        inv = torch.tensor(1.0) / sc
        pv = torch.zeros((bh, n, d), dtype=torch.float64)
        for t, e in zip(tiles, effs):
            codes = _quant_fast(e, sc, inv)[..., key[:64]]   # slot order
            pv = pv + codes.double() @ vt[:, :, t:t + 64].transpose(1, 2)
        o = o * al + pv.float() * sc
        m = mn
    return o / l.clamp_min(1e-30)


def _int8_operands(seed, bh, bkh, n, kn, d=128):
    from sdnq_tpu_torch.quant.core import quantize_int_mm
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((bh, n, d), (bkh, kn, d), (bkh, kn, d)))
    qq, qsc = quantize_int_mm(q)
    kq, ksc, vq, vsc = ka.quantize_kv(k, v)
    return qq, kq, vq, qsc[..., 0] * (d ** -0.5 * ka.LOG2E), ksc, vsc


@pytest.mark.parametrize("kn,mask_kind,causal", [
    (192, None, False), (1024, "bool", False), (256, None, True),
    (512, "float", False)])
def test_emulated_passes_equal_the_plain_version(kn, mask_kind, causal):
    b, h, kh = 2, 4, 2
    n = kn if causal else 72
    qq, kq, vq, qs, ks, vs = _int8_operands(kn, b * h, b * kh, n, kn)
    rng = np.random.default_rng(kn + 1)
    mask = None
    if mask_kind == "bool":
        mask = torch.from_numpy(rng.random((b, 1, n, kn)) < 0.5)
        mask[..., 0] = True
    elif mask_kind == "float":
        mask = torch.from_numpy(rng.normal(size=(1, h, n, kn)).astype(
            np.float32) * 2)
    pb = ka.attn_p_block(kn)
    got = _token_emulation(qq, kq, vq, qs, ks, vs, h, mask, causal, pb)
    want = ka.flash_attention_plain(qq, kq, vq, qs, ks, torch.float32,
                                    heads=h, mask=mask, causal=causal,
                                    v_scale=vs, p_block=pb)
    row = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max()
    assert row <= 1e-5, row


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_passes_against_jax_kernel_interpret(monkeypatch, causal):
    """The JAX package's int8-KV-cache attention (token-mode P.V) in
    interpret mode against the emulation run on the operands that the
    port's ``quantized_attention`` hands its kernel."""
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")
    b, h, kh, d = 2, 4, 2, 128
    n, kn = (256, 256) if causal else (64, 1024)
    rng = np.random.default_rng(11 + causal)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(torch.bfloat16).float().numpy()
               for s in ((b, h, n, d), (b, kh, kn, d), (b, kh, kn, d)))
    kw = dict(is_causal=causal)
    jkw, tkw = dict(kw), dict(kw)
    if not causal:
        mask = (np.arange(kn)[None, :] <= (kn - n - 8 + np.arange(n))[:, None])
        mask = np.broadcast_to(mask[None, None], (b, 1, n, kn)) & (
            rng.random((b, 1, n, kn)) < 0.5)
        mask[..., 0] = True
        jkw["attn_mask"] = jnp.asarray(mask)
        tkw["attn_mask"] = torch.from_numpy(np.ascontiguousarray(mask))
    from sdnq_tpu.kernels.attention import quantize_kv as jqkv
    jk, jks, jv, jvs = jqkv(jnp.asarray(k), jnp.asarray(v))
    tk, tks, tv, tvs = ka.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    ref = np.asarray(jattn(jnp.asarray(q), jk, jv, kv_scales=(jks, jvs),
                           **jkw))
    seen = {}
    real = ka.flash_attention

    def capture(*args, **kwargs):
        seen["args"], seen["kw"] = args, kwargs
        return real(*args, **kwargs)
    monkeypatch.setattr(ka, "flash_attention", capture)
    ka.quantized_attention(torch.from_numpy(q), tk, tv, kv_scales=(tks, tvs),
                           **tkw)
    a, kwargs = seen["args"], seen["kw"]
    out = _token_emulation(*a[:5], kwargs["v_scale"], kwargs["heads"],
                           kwargs["mask"], kwargs["causal"],
                           kwargs["p_block"])
    out = out.to(kwargs.get("out_dtype", torch.float32)).float().numpy()
    out = out.reshape(ref.shape)
    row = (np.abs(out - ref).max(-1) / np.abs(ref).max(-1)).max()
    assert row <= 4e-3, row


def _quant_np(e, sc, fallback=True):
    """quant_fast / quant_div in numpy float32; without ``fallback`` the
    multiply alone."""
    e, sc = np.float32(e), np.float32(sc)
    inv = np.float32(1.0) / sc
    y = (e * inv).astype(np.float32)
    r = (y + MAGIC).astype(np.float32)
    n = (r - MAGIC).astype(np.float32)
    code = (r.view(np.uint32) & 0xFF).astype(np.int64)
    if fallback:
        near = np.abs(y - n) > np.float32(0.499975)
        code = np.where(near, np.rint(e / sc).astype(np.int64) & 0xFF, code)
    return code


def test_quant_fast_equals_the_division():
    rng = np.random.default_rng(3)
    pm = np.float32(10.0) ** rng.uniform(-30, 3, 4000).astype(np.float32)
    sc = (np.maximum(pm, np.float32(1e-20)) / np.float32(127)).astype(
        np.float32)
    want = lambda e, s: np.rint(e / s).astype(np.int64)  # noqa: E731
    # random values in [0, pm], several a row scale
    e = (rng.random((4000, 256)).astype(np.float32) * pm[:, None]).astype(
        np.float32)
    s = np.broadcast_to(sc[:, None], e.shape)
    np.testing.assert_array_equal(_quant_np(e, s), want(e, s))
    # values a few ulps around (k + 0.5) sc: the division's own ties
    kh = rng.integers(0, 127, e.shape).astype(np.float32) + np.float32(0.5)
    e = (kh * s).astype(np.float32)
    for step in range(-4, 5):
        ee = e
        for _ in range(abs(step)):
            ee = np.nextafter(ee, np.float32(np.inf if step > 0 else 0))
        np.testing.assert_array_equal(_quant_np(ee, s), want(ee, s))
    # the multiply alone gets some of those wrong: the fallback is needed
    assert (_quant_np(e, s, fallback=False) != want(e, s)).any()


def test_gemv_magic_number_decode():
    """int8 codes as offset binary (byte ^ 0x80) and uint8 codes under the
    fp32 bits 0x4B0000bb (2^23 + byte), less 2^23 (+ 128): exact."""
    b = np.arange(256, dtype=np.uint32)
    f8 = ((b ^ 0x80) | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f8, b.astype(np.uint8).view(np.int8))
    fu = (b | 0x4B000000).view(np.float32) - np.float32(8388608.0)
    np.testing.assert_array_equal(fu, b.astype(np.float32))


def test_gemv_wrapper_alignment_copies():
    t = torch.zeros(65, dtype=torch.int8)
    assert kd._aligned(t, 16) is t
    view = t[3:].view(2, 31)
    assert view.data_ptr() % 16
    c = kd._aligned(view, 16)
    assert c.data_ptr() % 16 == 0 and torch.equal(c, view)
