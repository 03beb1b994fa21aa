"""B4 and B10 over an int8 contraction of 2^17 rows or more: what of their
Hopper kernels' plans the CPU can hold.

An int32 sum of int8 products (|a b| <= 2^14) is exact below 2^17 rows.
Past that the kernels split each tile's contraction into parts of at most
``LONG_PART_STAGES`` stages of 128 rows (``long_parts``; hopper.cuh's
``part_stages``), B4's and B10's alike; the parts are added in int64 and
rounded once to fp32.  Here:

* below 2^17 every plan is the one the kernels ran before (``nn_plan``'s
  values at the training shapes and just under 2^17, computed by the
  previous code; ``long_parts`` 1, so no workspace);
* past it the parts cover every contraction row once, each under 2^17
  rows, as the C entries check (nn: every tile split, 128 x 128 tiles);
* int64 sums of the parts' int32 sums, on codes whose total passes 2^31,
  equal the whole sum, and the plain versions (the port's CPU path) give
  it rounded once to fp32;
* the workspaces cover what the kernels index at either tile width.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

tmm = importlib.import_module("sdnq_tpu_torch.kernels.scaled_mm")

# nn_plan before the long contraction (M, contraction, N): (int8, e4m3)
OLD_NN_PLANS = {
    (1536, 21504, 3072): ((1, 264, 5), (1, 264, 5)),
    (1536, 3072, 15360): ((2, 720, 1), (1, 1440, 1)),
    (1, 18432, 3072): ((1, 0, 5), (1, 0, 5)),
    (1, 9216, 3072): ((1, 0, 5), (1, 0, 5)),
    (4096, 130944, 3584): ((2, 448, 1), (1, 792, 5)),
    (4096, 131071, 3584): ((2, 448, 1), (1, 792, 5)),
    (512, 65536, 512): ((1, 0, 8), (1, 0, 8)),
    (1536, 9216, 3072): ((1, 264, 4), (1, 264, 4)),
    (4608, 3072, 12288): ((2, 1728, 1), (1, 3456, 1)),
}
LONG = ((1 << 17), (1 << 17) + 96, 147456, 152064, 1 << 18, 1_000_000)


def _parts(k, parts, stage=128):
    """Each part's contraction rows, as ``part_stages`` cuts them."""
    nk = -(-k // stage)
    return [(p * nk // parts * stage, min(k, (p + 1) * nk // parts * stage))
            for p in range(parts)]


@pytest.mark.parametrize("mkn", list(OLD_NN_PLANS))
def test_plans_below_2_17_unchanged(mkn):
    m, k, n = mkn
    for dtype, want in zip((torch.int8, torch.float8_e4m3fn),
                           OLD_NN_PLANS[mkn]):
        assert tmm.nn_plan(m, n, k, dtype, 132) == want
    assert tmm.long_parts(k) == 1
    assert tmm.tn_work_ints(n, m, 1) == (0, 0)


@pytest.mark.parametrize("k", LONG)
def test_long_parts_cover_the_contraction(k):
    parts = tmm.long_parts(k)
    nk = -(-k // 128)
    assert parts >= 2 and -(-nk // parts) <= tmm.LONG_PART_STAGES
    assert -(-nk // (parts - 1)) > tmm.LONG_PART_STAGES   # the fewest
    rows = np.zeros(k, np.int64)
    for lo, hi in _parts(k, parts):
        assert 0 < hi - lo < 1 << 17
        rows[lo:hi] += 1
    assert (rows == 1).all()
    # B4 nn: every 128 x 128 tile split at least that many ways
    for m, n in ((4096, 3584), (1, 3072), (300, 200)):
        nb, whole, splits = tmm.nn_plan(m, n, k, torch.int8, 132)
        assert (nb, whole) == (1, 0) and splits >= parts
        assert -(-nk // splits) <= tmm.LONG_PART_STAGES
        assert all(hi - lo < 1 << 17 for lo, hi in _parts(k, splits))
        tiles = -(-m // 128) * -(-n // 128)
        assert tmm.nn_work_ints(m, n, nb, whole, splits) == (
            tiles, splits * tiles * 128 * 128)
    # B10: by the same parts, with a workspace
    assert tmm.tn_work_ints(3072, k, parts)[1] > 0


@pytest.mark.parametrize("k", ((1 << 17) + 96, 1 << 18))
def test_long_part_sums_exact(k):
    """Codes of -128 and 127 along a few rows make totals past 2^31: each
    part's sum stays an exact int32, their int64 total is the whole sum,
    and the plain versions round that total once."""
    rng = np.random.default_rng(k)
    a = rng.integers(-128, 128, (3, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, 4)).astype(np.int8)
    a[0], b[:, 0] = -128, -128       # 2^14 k > 2^31
    a[1], b[:, 1] = 127, -128
    whole = a.astype(np.int64) @ b.astype(np.int64)
    assert whole[0, 0] > 2 ** 31 and whole[1, 1] < -2 ** 30
    total = np.zeros_like(whole)
    for lo, hi in _parts(k, tmm.long_parts(k)):
        part = a[:, lo:hi].astype(np.int64) @ b[lo:hi].astype(np.int64)
        assert np.abs(part).max() < 2 ** 31
        total += part
    assert np.array_equal(total, whole)
    want = whole.astype(np.float32)      # the exact total rounded once
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tmm.scaled_gemm_plain(ta, tb.T.contiguous(), torch.float32)
    assert np.array_equal(got.numpy(), want)
    got = tmm.scaled_gemm_plain(ta, tb, torch.float32, b_layout="nn")
    assert np.array_equal(got.numpy(), want)
    got = tmm.scaled_mm_tn_plain(ta.T.contiguous(), tb)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,k", ((3584, 3584, 152064), (100, 300, 1 << 17),
                                   (4096, 3584, 1 << 18)))
def test_long_workspace_sizes(m, n, k):
    """The nt and B10 workspaces cover every counter and slab entry the
    kernels index, at 128 x 128 and at 128 x 256 tiles."""
    parts = tmm.long_parts(k)
    counters, slabs = tmm.nt_work_ints(m, n, parts)
    for nb in (1, 2):
        tiles = -(-m // 128) * -(-n // (128 * nb))
        assert counters >= tiles
        assert slabs >= parts * tiles * 128 * 128 * nb
    # B10: out (N, K) = (n, m) here, tiles of 128 rows x 128 nb columns
    counters, slabs = tmm.tn_work_ints(n, m, parts)
    for nb in (1, 2):
        tiles = -(-n // 128) * -(-m // (128 * nb))
        assert counters >= tiles
        assert slabs >= parts * tiles * 128 * 128 * nb
