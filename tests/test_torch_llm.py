"""The LLM serving slice on the CPU: the port's ``models.llm`` against the
JAX package's on the same weights (JAX ``init_llm`` at LLM_TINY_CONFIG,
quantized to int8 by the JAX package and carried across), for the bf16 and
the int8 KV cache, on the weight-only route and with the quantized matmul.
The JAX side runs its Pallas kernels in interpret mode, so prefill (N 120,
cache 128: N % 8 == 0 and KN % 128 == 0) takes the attention kernel on both
sides, and decode (N = 1) the XLA function.

Tolerances, as fractions of max |logits| (dequant dtype float32, so the
linears' outputs are not rounded to bf16):

* weight-only with the bf16 cache: the same fp32 products in another
  order and bf16 attention operands rounded alike; measured 1.9e-4 max
  (prefill): bound 1e-3.
* the int8 cache or the quantized matmul: K/V rows or activation rows are
  quantized per token, and a value at a rounding tie whose fp32 inputs
  differ by an ulp moves its code by one step (the JAX Pallas prologue
  also divides by the reciprocal, ROADMAP queue C); measured up to 1.6e-2
  max and 2e-4 mean: bound 5e-2 max and 2e-3 mean.

Greedy tokens agree exactly at these seeds on every route."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu.models import llm as jl
from sdnq_tpu_torch.convert import (
    params_from_numpy, qtensor_from_numpy, tensor_from_numpy,
)
from sdnq_tpu_torch.layers import qembedding as tqemb
from sdnq_tpu_torch.models import llm as tl

CFG_J, CFG_T = jl.LLM_TINY_CONFIG, tl.LLM_TINY_CONFIG
B, N0, NEW = 2, 120, 8


def carry(tree):
    """JAX params (QTensor leaves included) -> the port's, same bytes."""
    if isinstance(tree, J.QTensor):
        fields = {k: (None if getattr(tree, k) is None
                      else np.asarray(getattr(tree, k)))
                  for k in ("qdata", "scale", "zero_point", "svd_up",
                            "svd_down")}
        return qtensor_from_numpy(fields, dataclasses.asdict(tree.meta),
                                  device="cpu")
    if isinstance(tree, dict):
        return {k: carry(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [carry(v) for v in tree]
    return tensor_from_numpy(np.asarray(tree), "cpu")


def _quantized(qmm: bool):
    params = jl.init_llm(jax.random.key(0), CFG_J)
    qp, _ = J.quantize_model(params, J.QuantConfig(
        weights_dtype="int8", use_quantized_matmul=qmm,
        minimum_allowed_numel=4096, minimum_allowed_channel_size=16,
        dequant_dtype="float32"), arch="LlamaForCausalLM")
    return qp, carry(qp)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("SDNQ_TPU_KERNEL_BACKEND", "interpret")


def _rel(out, ref):
    ref = np.asarray(ref, dtype=np.float32)
    d = np.abs(np.asarray(out, dtype=np.float32) - ref)
    scale = np.abs(ref).max()
    return d.max() / scale, d.mean() / scale


@pytest.mark.parametrize("route", ["weight_only", "quantized_matmul"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_llm_matches_jax(interpret, route, kv):
    """Prefill logits and 5 decode steps' logits (fed JAX's greedy tokens),
    then the greedy tokens of ``generate``, against the JAX package."""
    qp, tp = _quantized(route == "quantized_matmul")
    assert isinstance(tp["layers"][0]["mlp"]["gate_proj"]["weight"],
                      T.QTensor)
    assert not isinstance(tp["lm_head"]["weight"], T.QTensor)
    cj = dataclasses.replace(CFG_J, kv_cache_dtype=kv)
    ct = dataclasses.replace(CFG_T, kv_cache_dtype=kv)
    ids = np.random.default_rng(1).integers(0, CFG_J.vocab_size, (B, N0))
    max_rel, mean_rel = ((1e-3, 1e-3) if (route, kv) == ("weight_only",
                                                        "bfloat16")
                         else (5e-2, 2e-3))

    jtoks = np.asarray(jl.generate(qp, jnp.asarray(ids), cj,
                                   max_new_tokens=NEW))
    ttoks = tl.generate(tp, torch.from_numpy(ids), ct, max_new_tokens=NEW,
                        device="cpu")
    assert ttoks.shape == (B, NEW)
    np.testing.assert_array_equal(ttoks.numpy(), jtoks)

    jc = [c[:-1] + (jnp.asarray(c[-1], jnp.int32),)
          for c in jl.init_cache(cj, B, N0 + NEW)]
    tc = tl.init_cache(ct, B, N0 + NEW, device="cpu")
    assert len(tc[0]) == (5 if kv == "int8" else 3)
    jlog, jc = jax.jit(lambda p, i, c: jl.llm_forward(p, i, cj, caches=c))(
        qp, jnp.asarray(ids), jc)
    tlog, tc = tl.llm_forward(tp, torch.from_numpy(ids), ct, caches=tc,
                              device="cpu")
    assert tc[0][-1] == N0
    mx, mean = _rel(tlog.numpy(), jlog)
    assert mx <= max_rel and mean <= mean_rel, ("prefill", mx, mean)
    step = jax.jit(lambda p, t, c, pos: jl.llm_forward(
        p, t[:, None], cj, positions=jnp.broadcast_to(pos, (B, 1)),
        caches=c))
    for s in range(5):
        tok = jtoks[:, s]
        jlog, jc = step(qp, jnp.asarray(tok), jc,
                        jnp.asarray(N0 + s, jnp.int32))
        tlog, tc = tl.llm_forward(
            tp, torch.from_numpy(tok)[:, None], ct,
            positions=torch.full((B, 1), N0 + s), caches=tc, device="cpu")
        mx, mean = _rel(tlog.numpy(), jlog)
        assert mx <= max_rel and mean <= mean_rel, (s, mx, mean)


def test_cache_free_causal_forward_matches_jax(interpret):
    """The cache-free forward (scoring) at N = 128 takes the causal
    kernel on both sides: q, k, v rounded to bf16 alike, P rounded to bf16
    against a running max in the JAX kernel and the final max in the
    port's plain version (measured 1.2e-3 of max |logits|): bound 3e-3."""
    qp, tp = _quantized(False)
    ids = np.random.default_rng(2).integers(0, CFG_J.vocab_size, (B, 128))
    ref = jl.llm_forward(qp, jnp.asarray(ids), CFG_J)[0]
    out, caches = tl.llm_forward(tp, torch.from_numpy(ids), CFG_T,
                                 device="cpu")
    assert caches is None
    mx, _ = _rel(out.numpy(), ref)
    assert mx <= 3e-3, mx


def test_llm_cache_matches_full_forward():
    """Prefill + decode with the KV cache decodes the same tokens as the
    cache-free causal forward, as tests/test_llm.py holds the JAX model (at
    this size both take the XLA attention)."""
    params = tl.init_llm(CFG_T, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG_T.vocab_size, (1, 8)))
    cached = tl.generate(params, ids, CFG_T, max_new_tokens=5, device="cpu")
    cur, plain = ids, []
    for _ in range(5):
        logits, _ = tl.llm_forward(params, cur, CFG_T, device="cpu")
        nxt = torch.argmax(logits[:, -1], dim=-1)
        plain.append(nxt)
        cur = torch.cat([cur, nxt[:, None]], dim=1)
    assert torch.equal(cached, torch.stack(plain, dim=1))


def test_masked_prefill_matches_causal_forward():
    """At the kernel's shapes the two attention modes agree: prefill of 128
    tokens into a 256-slot bf16 cache (bool mask over the whole cache,
    unfilled slots included) against the cache-free causal forward.  Both
    round q, k, v to bf16; P is rounded against different running maxima:
    bound 3e-3 of max |logits|."""
    params = tl.init_llm(CFG_T, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG_T.vocab_size, (B, 128)))
    causal, _ = tl.llm_forward(params, ids, CFG_T, device="cpu")
    caches = tl.init_cache(CFG_T, B, 256, device="cpu")
    masked, _ = tl.llm_forward(params, ids, CFG_T, caches=caches,
                               device="cpu")
    mx, _ = _rel(masked.numpy(), causal.numpy())
    assert mx <= 3e-3, mx


def test_convert_carries_llm_trees():
    """A JAX ``init_llm`` tree and a JAX quantized LLM tree carry across:
    the same structure as the port's ``init_llm``, the same values, and
    QTensors with the same bytes and metadata."""
    params = jl.init_llm(jax.random.key(3), CFG_J)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    mine = tl.init_llm(CFG_T, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat_j) == sum(1 for _ in _leaves(mine))
    for (path, leaf), (tpath, tleaf) in zip(
            sorted((jax.tree_util.keystr(p), v) for p, v in flat_j),
            sorted(_leaves(tp))):
        assert path == tpath
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(leaf))
    shapes = {p: tuple(v.shape) for p, v in _leaves(mine)}
    assert shapes == {p: tuple(v.shape) for p, v in _leaves(tp)}
    qp, tq = _quantized(True)
    w_j = qp["layers"][1]["self_attn"]["k_proj"]["weight"]
    w_t = tq["layers"][1]["self_attn"]["k_proj"]["weight"]
    assert dataclasses.asdict(w_t.meta) == {
        k: (tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in dataclasses.asdict(w_j.meta).items()}
    np.testing.assert_array_equal(w_t.qdata.numpy(), np.asarray(w_j.qdata))
    np.testing.assert_array_equal(w_t.scale.numpy(), np.asarray(w_j.scale))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("fmt", ["int8", "uint4", "int2"])
def test_qembedding_matches_jax(fmt):
    """Gathering rows of a quantized table dequantizes only those rows:
    the same values as the JAX package's ``qembedding`` (the same codes and
    fp32 scales: rtol 1e-6), and as the whole table dequantized."""
    from sdnq_tpu.layers import qembedding as jqemb
    rng = np.random.default_rng(4)
    table = rng.normal(size=(300, 64)).astype(np.float32)
    jq = J.quantize_tensor(jnp.asarray(table), fmt, layer_kind="embedding",
                           dequant_dtype="float32")
    tq = carry(jq)
    ids = rng.integers(0, 300, (3, 7))
    ref = np.asarray(jqemb(jnp.asarray(ids), jq, scale_multiplier=2.0))
    out = tqemb(torch.from_numpy(ids), tq, scale_multiplier=2.0)
    assert out.shape == (3, 7, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    whole = T.dequantize(tq, dtype=torch.float32)
    torch.testing.assert_close(out, 2.0 * whole[torch.from_numpy(ids)])
    plain = torch.from_numpy(table)
    assert torch.equal(tqemb(torch.from_numpy(ids), plain),
                       plain[torch.from_numpy(ids)])


def test_rope_tables_at_llama3_theta():
    """RoPE at theta 500000 in fp32, positions to 1100: the inverse
    frequencies agree exactly and cos / sin to an ulp (6e-8 measured) on the
    CPU; bound 1e-6.  (On the card a one-ulp difference in theta ** scale
    would move angles near position 1000 by about 1e-4, and a K/V or
    activation code at a rounding tie by one step; the chip run's slice
    check holds the kernels, not this table, to the plain path.)"""
    pos = np.arange(1100)[None]
    jc, js = jl._rope_tables(jnp.asarray(pos), 128, 500000.0)
    tc, ts = tl._rope_tables(torch.from_numpy(pos), 128, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    x = np.random.default_rng(5).normal(size=(1, 2, 1100, 128)).astype(
        np.float32)
    ref = jl._apply_rope(jnp.asarray(x), jc, js)
    out = tl._apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_llama3_8b_config_and_sizes():
    """LLAMA3_8B_CONFIG is meta-llama/Meta-Llama-3-8B's config.json, and
    the port's parameter count at it is the published 8.03 B (counted from
    the shapes of one layer and the embeddings, nothing allocated at
    full size)."""
    c = tl.LLAMA3_8B_CONFIG
    assert (c.vocab_size, c.hidden_size, c.num_layers, c.num_heads,
            c.num_kv_heads, c.head_dim, c.ff_dim, c.rope_theta,
            c.tie_embeddings) == (128256, 4096, 32, 32, 8, 128, 14336,
                                  500000.0, False)
    small = dataclasses.replace(c, hidden_size=64, num_heads=4,
                                num_kv_heads=1, head_dim=16, ff_dim=224,
                                vocab_size=100, num_layers=1)
    lay = tl.init_llm_layer(small, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    d, kv, f = small.hidden_size, small.num_kv_heads * small.head_dim, \
        small.ff_dim
    assert sum(t.numel() for _, t in _leaves(lay)) == \
        2 * d * d + 2 * d * kv + 3 * d * f + 2 * d
    d, kv, f = c.hidden_size, c.num_kv_heads * c.head_dim, c.ff_dim
    per_layer = 2 * d * d + 2 * d * kv + 3 * d * f + 2 * d
    total = c.num_layers * per_layer + 2 * c.vocab_size * d + d
    assert round(total / 1e9, 2) == 8.03
