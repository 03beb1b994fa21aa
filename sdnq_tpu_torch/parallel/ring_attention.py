"""Ring attention: sequence / context-parallel flash attention.

The JAX package's ``ring_attention`` over ``torch.distributed``.  Q, K and
V are split along the sequence over the mesh's ``axis``; each rank keeps
its queries and passes its K / V chunk around the ring (send to rank + 1,
receive from rank - 1, ``dist.batch_isend_irecv``: the counterpart of
``ppermute``), folding each chunk that arrives into its running (acc, m,
l) with the online-softmax merge.  The per-block step is
``flash_attention_block`` (B9 on the card where its route holds), which
returns unnormalised partials in natural-log units.

K and V travel as int8 plus one fp32 scale a token: (2·N·D + 8·N) bytes a
hop against 4·N·D for bf16.  Causal attention uses the zigzag layout
where N % (2P) == 0: rank i owns the chunk pair (i, 2P - 1 - i), which
evens out the causal work; chunk pairs wholly in the future are skipped,
and the only triangular masks come at ring step 0.  Otherwise causal
attention keeps the contiguous layout with a mask on global indices,
blocks from later ranks skipped.

``_local_ring`` runs the same body for P ranks in one process, each
rank's K / V chunk passing to the next within a list: how the P > 1 ring
is checked on one card (NCCL takes one rank a device).
"""

from __future__ import annotations

import dataclasses

import torch

from ..envconfig import env_bool
from ..kernels import attention as _attn
from ..quant.core import quantize_int_mm
from . import _collectives as C

__all__ = ["ring_attention"]

_NEG_INF = -1e30


def _merge(state, part):
    """Online-softmax merge of a block's partials into the running state;
    both (acc, m, l) with acc unnormalised, in natural-log units."""
    acc, m, l = state
    acc_i, m_i, l_i = part
    m_new = torch.maximum(m, m_i)
    a0 = torch.exp(m - m_new)
    a1 = torch.exp(m_i - m_new)
    return acc * a0 + acc_i * a1, m_new, l * a0 + l_i * a1


@dataclasses.dataclass(frozen=True)
class _Ring:
    """What every rank's body needs to know of the call."""
    b: int
    h: int
    d: int
    nq: int            # query rows a rank holds
    p: int
    causal: bool
    balance: bool      # the zigzag layout
    quantized: bool
    quantize_pv: bool
    scale: float
    out_dtype: torch.dtype


def _setup(query, key, value, p_size, scale, causal, matmul_dtype,
           quantize_pv, out_dtype):
    b, h, n, d = query.shape
    if key.shape != query.shape or value.shape != query.shape:
        raise ValueError(
            f"ring attention takes equal Q, K and V shapes (a GQA caller "
            f"repeats its KV heads), got {tuple(query.shape)}, "
            f"{tuple(key.shape)}, {tuple(value.shape)}")
    if n % p_size:
        raise ValueError(f"sequence {n} not divisible by axis size {p_size}")
    quantized = matmul_dtype == "int8"
    if quantize_pv is None:
        quantize_pv = env_bool("SDNQ_TPU_RING_QUANTIZE_PV", True) \
            and quantized
    ring = _Ring(b=b, h=h, d=d, nq=n // p_size, p=p_size, causal=causal,
                 balance=causal and p_size > 1 and n % (2 * p_size) == 0,
                 quantized=quantized,
                 quantize_pv=bool(quantize_pv and quantized),
                 scale=d ** -0.5 if scale is None else float(scale),
                 out_dtype=query.dtype if out_dtype is None else out_dtype)
    perm = None
    if ring.balance:
        c = n // (2 * p_size)
        perm = torch.cat([torch.cat([
            torch.arange(i * c, (i + 1) * c),
            torch.arange((2 * p_size - 1 - i) * c, (2 * p_size - i) * c)])
            for i in range(p_size)]).to(query.device)
    return ring, perm


def _operands(ring, q, k, v):
    """One rank's chunks (B, H, nq, D) -> (q, q_scale), (k, v, k_scale,
    v_scale) as the block step takes them: per-token int8 with q_scale
    carrying the softmax scale, or bf16 without scales; (B·H, nq, ...)."""
    bh = ring.b * ring.h

    def flat(t):
        return None if t is None else t.reshape(bh, ring.nq, *t.shape[3:])
    if ring.quantized:
        q_q, q_s = quantize_int_mm(q.float(), -1)
        k_q, k_s = quantize_int_mm(k.float(), -1)
        q_s, k_s = q_s[..., 0] * ring.scale, k_s[..., 0]
    else:
        q_q, k_q = q.float().to(torch.bfloat16), k.float().to(torch.bfloat16)
        q_s = k_s = None
    if ring.quantize_pv:
        v_q, v_s = quantize_int_mm(v.float(), -1)
        v_s = v_s[..., 0]
    else:
        v_q, v_s = v.float().to(torch.bfloat16), None
    return (flat(q_q), flat(q_s)), (flat(k_q), flat(v_q), flat(k_s),
                                    flat(v_s))


def _flash(ring, q, qs, kv, rows, cols, mask):
    """The block step on query rows ``rows`` against K / V rows ``cols``
    of a chunk."""
    k, v, ks, vs = kv

    def sel(t, r):
        return None if t is None else t[:, r]
    return _attn.flash_attention_block(
        sel(q, rows), sel(k, cols), sel(v, cols), sel(qs, rows),
        sel(ks, cols), sel(vs, cols), mask, quantized=ring.quantized,
        quantized_pv=ring.quantize_pv, sm_scale=ring.scale,
        mask_is_bool=True)


def _init_state(ring, rows, device):
    bh = ring.b * ring.h
    return (torch.zeros((bh, rows, ring.d), device=device),
            torch.full((bh, rows, 1), _NEG_INF, device=device),
            torch.zeros((bh, rows, 1), device=device))


def _step(ring, idx, i, q_op, kv, state):
    """Ring step ``i`` of rank ``idx``, holding the K / V chunk of rank
    (idx - i) mod P."""
    src = (idx - i) % ring.p
    q, qs = q_op
    dev = q.device
    if ring.balance:
        c = ring.nq // 2
        lo, hi = slice(0, c), slice(c, ring.nq)
        # the triangle at step 0 (src == idx); a full block elsewhere (the
        # JAX ring passes a mask of ones there)
        tri = (torch.ones(c, c, dtype=torch.bool, device=dev).tril()[None]
               if i == 0 else None)
        st_lo, st_hi = state
        if src <= idx:   # pair A: lo rows x lo cols
            st_lo = _merge(st_lo, _flash(ring, q, qs, kv, lo, lo, tri))
        # pair B: hi rows x lo cols, always whole
        st_hi = _merge(st_hi, _flash(ring, q, qs, kv, hi, lo, None))
        if src >= idx:   # pair C: hi rows x hi cols
            st_hi = _merge(st_hi, _flash(ring, q, qs, kv, hi, hi, tri))
        return st_lo, st_hi
    every = slice(None)
    if not ring.causal:
        return _merge(state, _flash(ring, q, qs, kv, every, every, None))
    if src > idx:    # wholly in the future
        return state
    rows = idx * ring.nq + torch.arange(ring.nq, device=dev)
    cols = src * ring.nq + torch.arange(ring.nq, device=dev)
    mask = (rows[:, None] >= cols[None, :])[None]
    return _merge(state, _flash(ring, q, qs, kv, every, every, mask))


def _finish(ring, state):
    if ring.balance:
        (acc_lo, _, l_lo), (acc_hi, _, l_hi) = state
        acc, l = torch.cat([acc_lo, acc_hi], 1), torch.cat([l_lo, l_hi], 1)
    else:
        acc, _, l = state
    out = (acc / l.clamp_min(1e-30)).to(ring.out_dtype)
    return out.reshape(ring.b, ring.h, ring.nq, ring.d)


def _run(ring, ranks, q_ops, kvs, shift):
    """The ring body of the ranks ``ranks`` (their query operands and K /
    V chunks in the same order), ``shift`` passing the chunks on after
    each step but the last; returns each rank's output chunk."""
    dev = q_ops[0][0].device
    half = ring.nq // 2
    states = [(_init_state(ring, half, dev), _init_state(ring, half, dev))
              if ring.balance else _init_state(ring, ring.nq, dev)
              for _ in ranks]
    for i in range(ring.p):
        states = [_step(ring, idx, i, q_op, kv, st)
                  for idx, q_op, kv, st in zip(ranks, q_ops, kvs, states)]
        if i < ring.p - 1:
            kvs = shift(kvs)
    return [_finish(ring, st) for st in states]


def _chunk(t, perm, r, nq):
    """Rank r's sequence chunk (in the zigzag order where ``perm``)."""
    rows = slice(r * nq, (r + 1) * nq)
    return t[:, :, rows] if perm is None else t[:, :, perm[rows]]


def _unpermute(out, perm):
    if perm is None:
        return out
    return out[:, :, torch.argsort(perm)]


def ring_attention(query, key, value, mesh, *, axis: str = "sequence",
                   scale: float | None = None, causal: bool = False,
                   matmul_dtype: str | None = "int8",
                   quantize_pv: bool | None = None, out_dtype=None):
    """query / key / value (B, H, N, D), the global tensors on every rank
    of ``mesh`` (equal heads: a GQA caller repeats its KV heads); returns
    the global (B, H, N, D) output on every rank, computed with N split
    over ``axis`` and K / V passed around the ring.  ``matmul_dtype``
    "int8" quantizes q, k per token (else bf16); ``quantize_pv`` (default
    ``SDNQ_TPU_RING_QUANTIZE_PV``, on, for int8) quantizes v per token for
    token-mode int8 P·V.  Causal attention takes the zigzag layout where N
    % (2P) == 0."""
    p_size = mesh.shape[axis]
    ring, perm = _setup(query, key, value, p_size, scale, causal,
                        matmul_dtype, quantize_pv, out_dtype)
    idx = mesh.get_local_rank(axis)
    q_op, kv = _operands(ring, *(_chunk(t, perm, idx, ring.nq)
                                 for t in (query, key, value)))

    def shift(kvs):
        (k, v, ks, vs), = kvs
        moved = iter(C.ring_shift([t for t in (k, v, ks, vs)
                                   if t is not None], mesh, axis))
        return [tuple(None if t is None else next(moved)
                      for t in (k, v, ks, vs))]
    out, = _run(ring, [idx], [q_op], [kv], shift)
    if p_size > 1:
        out = C.gather_sequence(out, mesh, axis)
    return _unpermute(out, perm)


def _local_ring(query, key, value, p_size: int, *, scale=None,
                causal=False, matmul_dtype="int8", quantize_pv=None,
                out_dtype=None):
    """``ring_attention`` over ``p_size`` ranks in one process: the same
    body for every rank, each rank's K / V chunk passed to the next within
    a list.  Equal to the distributed ring bit for bit on the same
    inputs."""
    ring, perm = _setup(query, key, value, p_size, scale, causal,
                        matmul_dtype, quantize_pv, out_dtype)
    ops = [_operands(ring, *(_chunk(t, perm, r, ring.nq)
                             for t in (query, key, value)))
           for r in range(p_size)]
    outs = _run(ring, list(range(p_size)), [o[0] for o in ops],
                [o[1] for o in ops],
                lambda kvs: [kvs[(r - 1) % p_size] for r in range(p_size)])
    return _unpermute(torch.cat(outs, dim=2), perm)
