"""SVDQuant low-rank correction.

The JAX package's ``quant.svd``: split W = svd_up @ svd_down + residual with
a rank-``rank`` randomized SVD (subspace iteration with QR, then an exact
SVD of the small projection) and quantize only the residual.  All in fp32
(``torch.linalg.qr`` / ``torch.linalg.svd``); the Gaussian sketch comes from
an explicit ``torch.Generator``.  Its bits differ from ``jax.random``'s, so
the factors differ between the packages while the residual they leave
agrees (the tests compare residuals).
"""

from __future__ import annotations

import torch

__all__ = ["svd_lowrank", "apply_svdquant"]


def svd_lowrank(a: torch.Tensor, rank: int = 32, niter: int = 8,
                generator: torch.Generator | None = None):
    """Randomized low-rank SVD of a (m, n): returns (U (m, r), S (r,),
    Vt (r, n)), r = min(rank, m, n).  Without a generator the sketch is
    drawn from one seeded 0 on a's device."""
    if generator is None:
        generator = torch.Generator(device=a.device).manual_seed(0)
    m, n = a.shape
    r = min(rank, m, n)
    a = a.to(torch.float32)
    g = torch.randn((n, r), generator=generator, device=a.device,
                    dtype=torch.float32)
    q, _ = torch.linalg.qr(a @ g)
    for _ in range(niter):
        q, _ = torch.linalg.qr(a @ (a.T @ q))
    b = q.T @ a                                      # (r, n)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    return q @ ub, s, vt


def apply_svdquant(w: torch.Tensor, rank: int = 32, niter: int = 8,
                   generator: torch.Generator | None = None, dtype=None):
    """Returns (residual, svd_up, svd_down): svd_up = U*S (O, r), svd_down
    = Vt (r, C) (cast to ``dtype`` when given), residual = W - svd_up @
    svd_down in fp32.  Conv weights are flattened to (O, -1) first."""
    shape = w.shape
    flat = w.reshape(shape[0], -1) if w.dim() > 2 else w
    flat = flat.to(torch.float32)
    u, s, vt = svd_lowrank(flat, rank=rank, niter=niter, generator=generator)
    svd_up = u * s[None, :]
    svd_down = vt.contiguous()  # LAPACK's layout would set the products'
    # summation order apart from a stacked copy's
    if dtype is not None:
        svd_up = svd_up.to(dtype)
        svd_down = svd_down.to(dtype)
    residual = flat - svd_up.float() @ svd_down.float()
    return residual.reshape(shape), svd_up, svd_down
