"""Ulysses-style sequence parallelism: all-to-all between heads and
sequence.

The JAX package's ``ulysses_attention`` over ``torch.distributed``: one
all-to-all (``dist.all_to_all_single`` on the mesh axis's group) turns a
rank's (B, H, N/P, D) sequence chunk into (B, H/P, N, D), all of the
sequence for its share of the heads, so that the single-device
``quantized_attention`` (B3 on the card) does the math; a second
all-to-all brings the sequence split back.
"""

from __future__ import annotations

from ..kernels.attention import quantized_attention
from . import _collectives as C

__all__ = ["ulysses_attention"]


def _scatter_heads(x, mesh, axis):
    """(B, H, N/P, D) sequence chunk -> (B, H/P, N, D) head share."""
    p = mesh.shape[axis]
    b, h, nq, d = x.shape
    blocks = x.reshape(b, p, h // p, nq, d).transpose(0, 1)
    got = C.all_to_all(blocks, mesh, axis)      # block j: rank j's chunk
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * nq, d)


def _gather_heads(x, mesh, axis):
    """(B, H/P, N, D) head share -> (B, H, N/P, D) sequence chunk."""
    p = mesh.shape[axis]
    b, hp, n, d = x.shape
    blocks = x.reshape(b, hp, p, n // p, d).permute(2, 0, 1, 3, 4)
    got = C.all_to_all(blocks, mesh, axis)      # block j: rank j's heads
    return got.transpose(0, 1).reshape(b, p * hp, n // p, d)


def ulysses_attention(query, key, value, mesh, *, axis: str = "sequence",
                      is_causal: bool = False, scale: float | None = None,
                      matmul_dtype: str | None = "int8",
                      pv_matmul_dtype: str | None = None, out_dtype=None):
    """query / key / value (B, H, N, D), the global tensors on every rank
    of ``mesh``; returns the global output on every rank.  H (and the KV
    heads) must divide by the ``axis`` size, and N too."""
    b, h, n, d = query.shape
    p = mesh.shape[axis]
    if h % p or key.shape[1] % p:
        raise ValueError(f"heads {h} (KV {key.shape[1]}) not divisible by "
                         f"axis size {p}")
    if n % p:
        raise ValueError(f"sequence {n} not divisible by axis size {p}")
    if out_dtype is None:
        out_dtype = query.dtype

    def attend(q, k, v):
        return quantized_attention(
            q, k, v, is_causal=is_causal, scale=scale,
            matmul_dtype=matmul_dtype, pv_matmul_dtype=pv_matmul_dtype,
            out_dtype=out_dtype)
    if p == 1:
        return attend(query, key, value)
    idx, nq = mesh.get_local_rank(axis), n // p
    q, k, v = (_scatter_heads(t[:, :, idx * nq:(idx + 1) * nq], mesh, axis)
               for t in (query, key, value))
    out = _gather_heads(attend(q, k, v), mesh, axis)
    return C.gather_sequence(out, mesh, axis)
