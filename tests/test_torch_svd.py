"""SVDQuant's randomized low-rank SVD: the port against the JAX package.

The two packages draw their Gaussian sketches from different generators
(torch.Generator against jax.random), so their factors differ; what must
agree is the subspace they find where it is well defined and the residual
they leave.  fp32 throughout."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from sdnq_tpu.quant import svd as jsvd
from sdnq_tpu_torch.quant import svd as tsvd


def _gapped(m=160, n=128, rank=16, seed=0):
    """A matrix with 16 singular values 40 .. 10 and the rest below 0.02."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, m)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s = np.concatenate([np.linspace(40, 10, rank),
                        rng.uniform(0, 0.02, min(m, n) - rank)])
    return ((u[:, :len(s)] * s) @ v[:, :len(s)].T).astype(np.float32)


def _both(a, rank, niter=8):
    jr, ju, jd = jsvd.apply_svdquant(jnp.asarray(a), rank=rank, niter=niter,
                                     key=jax.random.key(0))
    tr, tu, td = tsvd.apply_svdquant(
        torch.from_numpy(a), rank=rank, niter=niter,
        generator=torch.Generator().manual_seed(0))
    return ((np.asarray(jr), np.asarray(ju), np.asarray(jd)),
            (tr.numpy(), tu.numpy(), td.numpy()))


def test_planted_gap_factors_and_residual():
    """Above a spectral gap the rank-16 approximation is unique: up @ down
    agree to 1e-4 of its norm, and the residuals' Frobenius norms (the
    0.02-level tail) to 1e-3."""
    a = _gapped()
    (jr, ju, jd), (tr, tu, td) = _both(a, 16)
    jl, tl = ju @ jd, tu @ td
    assert np.linalg.norm(tl - jl) <= 1e-4 * np.linalg.norm(jl)
    nj, nt = np.linalg.norm(jr), np.linalg.norm(tr)
    assert abs(nt - nj) <= 1e-3 * nj, (nt, nj)
    np.testing.assert_allclose(tr + tl, a, atol=1e-4)   # W = residual + USV
    assert tu.shape == (160, 16) and td.shape == (16, 128)


def test_random_matrix_residual_near_optimal():
    """Without a gap the factors are not unique; the residual of the rank-32
    sketch stays within 1% of the exact truncated SVD's, on both sides."""
    a = np.random.default_rng(1).normal(size=(192, 256)).astype(np.float32)
    s = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    best = np.sqrt((s[32:] ** 2).sum())
    (jr, _, _), (tr, _, _) = _both(a, 32)
    assert np.linalg.norm(tr) <= 1.01 * best, (np.linalg.norm(tr), best)
    assert np.linalg.norm(jr) <= 1.01 * best
    # factors in the quantizer's dtype: the residual is taken against the
    # rounded factors, as in the JAX package
    r, u, d = tsvd.apply_svdquant(torch.from_numpy(a), rank=32,
                                  dtype=torch.bfloat16)
    assert u.dtype == d.dtype == torch.bfloat16
    torch.testing.assert_close(r + u.float() @ d.float(), torch.from_numpy(a),
                               rtol=0, atol=1e-5)


def test_svd_lowrank_conv_flatten_and_seed():
    """Conv weights flatten to (O, -1); the same generator seed gives the
    same factors."""
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(48, 8, 3, 3)).astype(np.float32))
    r1, u1, d1 = tsvd.apply_svdquant(
        w, rank=8, generator=torch.Generator().manual_seed(5))
    r2, u2, d2 = tsvd.apply_svdquant(
        w, rank=8, generator=torch.Generator().manual_seed(5))
    assert r1.shape == w.shape and d1.shape == (8, 72)
    assert torch.equal(u1, u2) and torch.equal(d1, d2)
    torch.testing.assert_close(r1 + (u1 @ d1).reshape(w.shape), w,
                               rtol=0, atol=1e-5)
