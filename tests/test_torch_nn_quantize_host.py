"""B4's nn layout (B1's grad-input GEMM) and B1's row quantizer: what of
their Hopper kernels the CPU can hold.

* ``nn_plan``: the split contraction covers every contraction row once,
  int64 partial sums over its slices equal the whole sum (the kernel adds
  int32 partials, exact in any order), and a narrow output fills the SMs.
* ``gemm_operands``: the nn kernel's operands are copied only where TMA
  cannot read them; nothing is padded to a tile.
* The quantizer's shortcut (common.cuh ``quant_round`` / ``quant_fast``,
  as ``quantize_rows.cu`` runs it): a multiply by the rounded reciprocal,
  the division only within 2.5e-5 of a half-integer, in numpy float32,
  against numpy's division: bit-equal codes for int8 and uint8 (after the
  zero point), on random rows and on quotients planted next to
  half-integers.
* ``scaled_mm_fused_act(..., b_layout="nn", x_colscale=...)`` against the
  JAX Pallas body in interpret mode at M 1 and at K and N off 64 and 4
  (shapes the old wrapper padded).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

jmm = importlib.import_module("sdnq_tpu.kernels.scaled_mm")
tmm = importlib.import_module("sdnq_tpu_torch.kernels.scaled_mm")

# the grad-input GEMMs of the FLUX.1-dev training step: (M, contraction, N)
TRAINING = ((1536, 21504, 3072), (1536, 3072, 15360), (1024, 9216, 3072),
            (1024, 12288, 3072), (1024, 3072, 12288), (512, 9216, 3072),
            (1, 18432, 3072), (1, 9216, 3072))


def _slices(k, splits):
    """The contraction rows of each split of a split tile, as the kernel's
    ``nn_unit`` cuts them: stages [s nk / S, (s + 1) nk / S) of 128 rows."""
    nk = -(-k // tmm.NN_STAGE)
    out = []
    for s in range(splits):
        kb0, kb1 = s * nk // splits, (s + 1) * nk // splits
        out.append((kb0 * tmm.NN_STAGE, min(k, kb1 * tmm.NN_STAGE)))
    return out


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn],
                         ids=["int8", "e4m3"])
@pytest.mark.parametrize("m,k,n", TRAINING + ((1, 1000, 40), (3, 300, 8),
                                              (200, 130, 3000)))
def test_nn_plan_covers_the_contraction(m, k, n, dtype):
    nb, whole, splits = tmm.nn_plan(m, n, k, dtype, 132)
    tiles = -(-m // 128) * -(-n // (128 * nb))
    assert nb in ((1, 2) if dtype == torch.int8 else (1,))
    assert 1 <= splits <= tmm.NN_MAX_SPLITS
    assert splits <= -(-k // tmm.NN_STAGE) and 0 <= whole <= tiles
    assert whole in (tiles, tiles // 132 * 132)   # full rounds, or all
    rows = np.zeros(k, np.int64)
    for lo, hi in _slices(k, splits):
        assert lo <= hi
        rows[lo:hi] += 1
    assert (rows == 1).all()
    counters, slabs = tmm.nn_work_ints(m, n, nb, whole, splits)
    if splits == 1 or whole == tiles:
        assert counters == slabs == 0
    else:
        assert counters == tiles - whole
        assert slabs == splits * (tiles - whole) * 128 * 128 * nb


@pytest.mark.parametrize("m,k,n", TRAINING + ((1, 1000, 40),))
def test_nn_split_partial_sums_are_exact(m, k, n):
    """Int64 sums over the plan's slices add to the whole sum (the kernel's
    int32 partials: exact for K < 2^17), at the contraction of each
    training shape with a few rows and columns."""
    splits = max(tmm.nn_plan(m, n, k, torch.int8, 132)[2], 2)
    rng = np.random.default_rng(k + n)
    a = rng.integers(-128, 128, (min(m, 3), k)).astype(np.int64)
    b = rng.integers(-128, 128, (k, 5)).astype(np.int64)
    parts = [a[:, lo:hi] @ b[lo:hi] for lo, hi in _slices(k, splits)]
    whole = a @ b
    assert np.array_equal(sum(parts), whole)
    assert np.abs(whole).max() < 2 ** 31 and all(
        np.abs(p).max() < 2 ** 31 for p in parts)


def test_nn_plan_fills_the_card_at_narrow_outputs():
    """M = 1 (24 tiles of 128 x 128) splits its contraction so that at
    least 100 of 132 SMs have work; linear1 (288 tiles of 128 x 128 or 144
    of 128 x 256: full rounds and a few more) splits the few so that its
    last round is at least half full."""
    for k in (18432, 9216):
        nb, whole, splits = tmm.nn_plan(1, 3072, k, torch.int8, 132)
        units = whole + (-(-3072 // (128 * nb)) - whole) * splits
        assert whole == 0 and splits > 1 and units >= 100, (k, nb, splits)
    nb, whole, splits = tmm.nn_plan(1536, 3072, 21504, torch.int8, 132)
    tiles = 12 * -(-3072 // (128 * nb))
    assert whole == tiles // 132 * 132 and splits > 1
    last = (tiles - whole) * splits % 132 or 132
    assert last >= 66, (nb, whole, splits)


class _Build:
    """Stands for a loaded build's C entry: the workspace is kept on it."""


def test_nn_workspace_kept_between_calls(monkeypatch):
    """A split call's counters are made once a build, device and stream,
    zeroed when made (the kernel leaves them 0, so no call fills them), and
    reused while they are large enough; its slabs, written before they are
    read, are the call's own, of its plan's size; none without a split."""
    streams = iter([7] * 4 + [8])
    monkeypatch.setattr(tmm._build, "stream", lambda t: next(streams))
    fn, a = _Build(), torch.zeros(1, 18432, dtype=torch.int8)
    plan = tmm.nn_plan(1, 3072, 18432, torch.int8, 132)
    c, s = tmm._nn_work(fn, 1, 3072, plan, a)
    assert c.dtype == s.dtype == torch.int32 and not c.any()
    assert (c.numel(), s.numel()) == tmm.nn_work_ints(1, 3072, *plan)
    c2, s2 = tmm._nn_work(fn, 1, 3072, plan, a)
    assert c2 is c and s2 is not s and s2.numel() == s.numel()
    small = tmm.nn_plan(1, 384, 18432, torch.int8, 132)   # fewer tiles
    cs, ss = tmm._nn_work(fn, 1, 384, small, a)
    assert cs is c and ss.numel() == tmm.nn_work_ints(1, 384, *small)[1]
    big = (1, 0, 16)   # more split tiles than the first plan's
    c3, s3 = tmm._nn_work(fn, 1, 12288, big, a)
    assert c3 is not c and not c3.any()
    assert s3.numel() == tmm.nn_work_ints(1, 12288, *big)[1]
    c4, _ = tmm._nn_work(fn, 1, 3072, plan, a)   # another stream
    assert c4 is not c3 and c4 is not c
    assert tmm._nn_work(_Build(), 1, 3072, (1, 24, 1), a) == (None, None)


def test_nn_workspace_one_a_build(monkeypatch):
    """Each build of the kernel (a fault build swapped in, then the real
    one again) gets a workspace of its own, so none finds counters another
    left."""
    monkeypatch.setattr(tmm._build, "stream", lambda t: 7)
    a = torch.zeros(1, 9216, dtype=torch.int8)
    plan = tmm.nn_plan(1, 3072, 9216, torch.int8, 132)
    one, two = _Build(), _Build()
    c1, _ = tmm._nn_work(one, 1, 3072, plan, a)
    c2, _ = tmm._nn_work(two, 1, 3072, plan, a)
    assert c1 is not c2
    assert tmm._nn_work(one, 1, 3072, plan, a)[0] is c1


def test_nn_operands_copy_only_what_tma_cannot_read():
    """The nn wrapper's operands: A (M, K) and B (K, N) read in place when
    TMA can read them, at any K and N (no padding of K to 64 bytes or of N
    to 4); a view off a 16-byte boundary or with rows not a multiple of 16
    bytes apart is copied, its values kept."""
    a = torch.randint(-128, 128, (37, 2000), dtype=torch.int8)
    b = torch.randint(-128, 128, (2000, 3008), dtype=torch.int8)
    ga, gb = tmm.gemm_operands(a, b, nn=True)
    assert ga is a and gb is b
    view = torch.zeros(5, 48, dtype=torch.int8)[:, :40]   # rows 48 bytes apart
    ga, gb = tmm.gemm_operands(view, b[:40], nn=True)
    assert ga is view and ga.shape == (5, 40) and gb.shape == (40, 3008)
    odd = torch.randint(-128, 128, (1000, 300), dtype=torch.int8)
    big = torch.zeros(1 + 1000 * 300, dtype=torch.int8)
    off = big[1:].view(1000, 300)
    off.copy_(odd)
    a = torch.zeros(3, 1008, dtype=torch.int8)   # K off 64, rows 1008 bytes apart
    ga, gb = tmm.gemm_operands(a, off, nn=True)
    assert ga is a
    assert gb is not off and gb.data_ptr() % 16 == 0
    assert gb.stride(0) % 16 == 0 and torch.equal(gb[:, :300], odd)


# ---- the quantizer's division shortcut, in numpy float32 ------------------
MAGIC = np.float32(12582912.0)   # 1.5 * 2^23


def _codes_shortcut(v, scale):
    """quantize_rows.cu's codes of v / scale (int8 range), float32 as the
    card rounds it: y = v * (1 / scale rounded), clipped, rounded by the
    magic number; the division where y lies within 2.5e-5 of a
    half-integer (a vector at a time on the card; here a value at a time,
    the same codes)."""
    v = v.astype(np.float32)
    scale = np.float32(scale)
    inv = np.float32(1) / scale
    y = np.clip(v * inv, np.float32(-128), np.float32(127)).astype(np.float32)
    r = (y + MAGIC).astype(np.float32)
    rounded = (r - MAGIC).astype(np.float32)
    near = np.abs((y - rounded).astype(np.float32)) > np.float32(0.499975)
    div = np.clip(np.rint(v / scale), -128, 127)
    return np.where(near, div, rounded).astype(np.int64), near


def _codes_division(v, scale):
    return np.clip(np.rint(v.astype(np.float32) / np.float32(scale)),
                   -128, 127).astype(np.int64)


def _rows(rng, n):
    """Rows with the statistics of activations and cotangents: Gaussian,
    heavy-tailed, tiny and huge magnitudes."""
    out = [rng.normal(size=n), rng.standard_t(2, size=n),
           rng.normal(size=n) * 1e-30, rng.normal(size=n) * 1e30,
           rng.uniform(-1, 1, size=n) * 3.7]
    return [o.astype(np.float32) for o in out]


@pytest.mark.parametrize("seed", range(4))
def test_quantize_shortcut_int8_random_rows(seed):
    rng = np.random.default_rng(seed)
    for v in _rows(rng, 200_000):
        amax = np.abs(v).max()
        scale = max(np.float32(amax) / np.float32(127), np.float32(2.0 ** -126))
        got, _ = _codes_shortcut(v, scale)
        assert np.array_equal(got, _codes_division(v, scale))


@pytest.mark.parametrize("seed", range(4))
def test_quantize_shortcut_uint8_random_rows(seed):
    """The asymmetric codes: (v - zp) / scale with zp = min + 128 scale,
    off-centre rows included (large offsets leave quotients past 128)."""
    rng = np.random.default_rng(100 + seed)
    for v in _rows(rng, 200_000) + [
            (rng.normal(size=200_000) * 1e-3 + 1000).astype(np.float32)]:
        vmin, vmax = v.min(), v.max()
        scale = max(np.float32(vmax - vmin) / np.float32(255),
                    np.float32(2.0 ** -126))
        zp = np.float32(vmin + np.float32(scale * np.float32(128)))
        d = (v - zp).astype(np.float32)
        got, _ = _codes_shortcut(d, scale)
        assert np.array_equal(got, _codes_division(d, scale))


@pytest.mark.parametrize("seed", range(3))
def test_quantize_shortcut_near_half_integers(seed):
    """Quotients planted at and next to half-integers (within a few ulps,
    where the multiply and the division can round apart): the shortcut
    sends them to the division, and every code equals the division's.
    Ties (exact half-integers) round to even."""
    rng = np.random.default_rng(200 + seed)
    for scale in (np.float32(2.0 ** -4), np.float32(0.0123457),
                  np.float32(3.1e-7), np.float32(7.77e5)):
        n = rng.integers(-128, 128, 400_000)
        q = (n + 0.5).astype(np.float32)
        ulps = rng.integers(-6, 7, n.shape).astype(np.float32)
        q = (q + ulps * np.spacing(q)).astype(np.float32)
        v = (q.astype(np.float64) * np.float64(scale)).astype(np.float32)
        got, near = _codes_shortcut(v, scale)
        assert np.array_equal(got, _codes_division(v, scale))
        # within an ulp of the half-integer the division decided them
        assert near[np.abs(ulps) <= 1].mean() > 0.99
    # exact ties: x = (n + 1/2) s with s a power of two
    s = np.float32(2.0 ** -4)
    v = ((np.arange(-128, 127) + 0.5) * s).astype(np.float32)
    got, near = _codes_shortcut(v, s)
    assert near.all() and np.array_equal(got, np.rint(v / s))


def test_quantize_shortcut_bound():
    """Where y = v * inv lies more than 2.5e-5 from a half-integer it rounds
    as the division does: |y - v / s| stays under 2.4e-5 for quotients
    below 129 (two roundings of 2^-24 |y| and half an ulp)."""
    rng = np.random.default_rng(7)
    scale = rng.uniform(0.5, 1.0, 2000).astype(np.float32) * np.float32(
        2.0) ** rng.integers(-60, 60, 2000).astype(np.float32)
    q = rng.uniform(-129, 129, (2000, 200)).astype(np.float32)
    v = (q * scale[:, None]).astype(np.float32)
    inv = (np.float32(1) / scale).astype(np.float32)
    y = (v * inv[:, None]).astype(np.float32)
    quot = (v / scale[:, None]).astype(np.float32)
    assert np.abs(y.astype(np.float64) - quot.astype(np.float64)).max() \
        < 2.4e-5


# ---- the grad-input route against the JAX kernel in interpret mode --------
@pytest.mark.parametrize("m,k,o", [(1, 200, 70), (9, 130, 38)])
def test_fused_act_nn_colscale_interpret(monkeypatch, m, k, o):
    """The grad-input route (the cotangent times the weight's row scales,
    quantized per row, then the stored (K, O) weight as it lies) at M 1 and
    at K and O off 64 and 4: against ``_fused_act_mm_pallas(b_dim0=True)``
    in interpret mode (rtol 1e-5 of each output and 1e-5 of the largest,
    or one code step a value on a row where its prologue's reciprocal
    rounds a scale one ulp apart), and bit-equal to the plain
    composition.  The JAX package's XLA route (which divides, as the port)
    agrees within rtol 1e-5 everywhere."""
    rng = np.random.default_rng(m * 100 + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, o)).astype(np.int8)
    cs = rng.uniform(0.001, 0.02, (k,)).astype(np.float32)

    def ref(backend):
        monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", backend)
        return np.asarray(jmm.scaled_mm_fused_act(
            jnp.asarray(x), jnp.asarray(w), None, None, x_fmt="int8",
            out_dtype=jnp.float32, b_layout="nn", x_colscale=jnp.asarray(cs)))
    out = tmm.scaled_mm_fused_act(
        torch.from_numpy(x), torch.from_numpy(w), None, None, x_fmt="int8",
        out_dtype=torch.float32, b_layout="nn",
        x_colscale=torch.from_numpy(cs)).numpy()
    assert out.shape == (m, o)
    for backend in ("interpret", "xla"):
        want = ref(backend)
        tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
        if backend == "interpret":   # one code step a value on a flipped row
            xs = np.abs(x * cs).max(-1, keepdims=True) / 127
            tol = tol + xs * np.abs(w.astype(np.float32)).sum(0, keepdims=True)
        assert (np.abs(out - want) <= tol).all(), backend
    xq, xsc = tmm.quantize_rows_plain(torch.from_numpy(x),
                                      colscale=torch.from_numpy(cs))[:2]
    plain = tmm.scaled_gemm_plain(xq, torch.from_numpy(w), torch.float32,
                                  xsc, b_layout="nn")
    np.testing.assert_array_equal(out, plain.numpy())
