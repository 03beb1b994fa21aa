"""The MoE slice on the CPU: ``moe_ffn``, ``qlinear_batched``, ``top_k``,
``quantize_moe`` and the conversion of quantized expert banks, each
against the JAX package's ``models/moe.py`` on the same numpy weights and
inputs (the weights drawn by the port's seeded ``init_moe``).

Tolerances, over max |y| of the JAX output:

* Routing is compared exactly: the top-k indices, the arrival positions
  and so the dropped tokens (the router's fp32 logits agree to an ulp;
  the inputs are drawn so that no two probabilities of a token lie within
  1e-4 of each other unless they are tied on purpose).
* Every bank: the expert products agree to fp32 rounding (the same bf16
  operands, or the same int8 codes, summed in another order), but the
  hidden state silu(g) * u that enters the down projection is rounded to
  bf16 (or quantized per row to int8), so an element whose fp32 value
  differs by an ulp may round one bf16 ulp (or one code) apart: 5e-4
  (measured at most 2.0e-4 over three seeds, weight-only int8 at seed 0).
* The aux loss: fp32 means in another order: 1e-6 relative."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sdnq_tpu.models import moe as jmoe
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.models import moe as tmoe
from sdnq_tpu_torch.tensor import QTensor, layer_count, layer_view

TINY = tmoe.MOE_TINY_CONFIG
# top-1 at capacity factor 0.5: an expert takes 16 of 64 tokens, so that
# tokens drop
TOP1 = dataclasses.replace(TINY, top_k=1, capacity_factor=0.5)
RECIPES = {"plain": None,
           "int8_wo": dict(fmt="int8"),
           "uint4_wo": dict(fmt="uint4"),
           "int8_qmm": dict(fmt="int8", use_quantized_matmul=True)}
TOL = 5e-4


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _both(cfg, recipe, seed=0):
    """(JAX params, port params): the port's init, the JAX package's
    quantizer, converted into the port's QTensors."""
    g = torch.Generator().manual_seed(seed)
    tp = tmoe.init_moe(cfg, generator=g, device="cpu")
    jp = _jax_tree(_np_tree(tp))
    if recipe is not None:
        kw = dict(recipe)
        jp = jmoe.quantize_moe(jp, kw.pop("fmt"), **kw)
        tp = params_from_numpy(jp, "cpu")
    return jp, tp


def _x(cfg, t=64, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).normal(
        size=(2, t // 2, cfg.hidden_size)).astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _routing_jax(jp, x, cfg):
    """The JAX function's top-k and keep mask, step by step as moe_ffn."""
    xf = jnp.asarray(x).reshape(-1, cfg.hidden_size)
    t = xf.shape[0]
    cap = max(1, int(cfg.capacity_factor * cfg.top_k * t / cfg.num_experts))
    logits = xf @ jp["router"]["weight"].T
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    oh = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.int32)
    flat = oh.reshape(t * cfg.top_k, -1)
    pos = (jnp.cumsum(flat, 0) - flat).reshape(oh.shape)
    pos = jnp.sum(pos * oh, -1)
    return np.asarray(idx), np.asarray(pos < cap)


@pytest.mark.parametrize("cfg_name", ["tiny", "top1"])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_moe_ffn_matches_jax(cfg_name, recipe):
    cfg = TINY if cfg_name == "tiny" else TOP1
    jp, tp = _both(cfg, RECIPES[recipe])
    x = _x(cfg)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    assert _rel(ty.numpy(), jy) <= TOL
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    if cfg_name == "top1":   # capacity 16 of 64 tokens: some drop
        _, keep = _routing_jax(jp, x, cfg)
        assert not keep.all()
        dropped = ~keep[:, 0]
        # a dropped token's output is 0 in both
        assert np.all(ty.numpy().reshape(-1, cfg.hidden_size)[dropped] == 0)


def test_routing_and_drops_match_jax():
    """The top-k choice, its order and the capacity mask equal the JAX
    package's, over inputs where an expert overflows."""
    cfg = dataclasses.replace(TINY, capacity_factor=0.75)
    jp, tp = _both(cfg, None, seed=3)
    x = _x(cfg, t=128, seed=4)
    jidx, jkeep = _routing_jax(jp, x, cfg)
    xf = torch.from_numpy(x).reshape(-1, cfg.hidden_size)
    probs = torch.softmax(xf @ tp["router"]["weight"].T, -1)
    _, tidx = tmoe.top_k(probs, cfg.top_k)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    assert not jkeep.all()
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
    ty, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    # the rows the capacity drops entirely are 0 on both sides
    gone = ~jkeep.any(-1)
    assert gone.any()
    assert np.all(np.asarray(jy).reshape(-1, cfg.hidden_size)[gone] == 0)
    assert np.all(ty.numpy().reshape(-1, cfg.hidden_size)[gone] == 0)
    assert _rel(ty.numpy(), jy) <= 1e-4


def test_top_k_breaks_ties_by_the_lower_index():
    """Tied probabilities: ``top_k`` takes the lower index first, as
    ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(5)
    p = rng.integers(0, 3, size=(256, 8)).astype(np.float32) / 4.0
    jv, ji = jax.lax.top_k(jnp.asarray(p), 3)
    tv, ti = tmoe.top_k(torch.from_numpy(p), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_ffn_with_tied_router():
    """A zero router ties every probability: each token takes experts 0
    .. k-1 in order, their queues fill in token order, and the rest drop;
    the output and the aux loss match the JAX package's."""
    cfg = TINY
    jp, tp = _both(cfg, RECIPES["int8_wo"], seed=6)
    jp["router"]["weight"] = jnp.zeros_like(jp["router"]["weight"])
    tp["router"]["weight"] = torch.zeros_like(tp["router"]["weight"])
    x = _x(cfg, seed=7)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert _rel(ty.numpy(), jy) <= 1e-4
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_aux_loss_matches_jax_bf16_tokens():
    """bf16 tokens (the card's dtype): the dispatch and combine einsums in
    bf16, y and the aux loss against the JAX package."""
    cfg = TINY
    jp, tp = _both(cfg, RECIPES["int8_wo"], seed=8)
    x = _x(cfg, seed=9)
    xb = torch.from_numpy(x).bfloat16()
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), cfg)
    ty, taux = tmoe.moe_ffn(tp, xb, cfg)
    assert ty.dtype == torch.bfloat16
    # the outputs round to bf16 from fp32 sums in another order: an ulp
    assert _rel(ty.float().numpy(), np.asarray(jy, np.float32)) <= 2 ** -7
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("recipe", ["plain", "int8_wo", "uint4_wo",
                                    "int8_qmm"])
def test_qlinear_batched_matches_jax(recipe):
    jp, tp = _both(TINY, RECIPES[recipe], seed=10)
    x = np.random.default_rng(11).normal(
        size=(TINY.num_experts, 12, TINY.hidden_size)).astype(np.float32)
    jo = jmoe.qlinear_batched(jnp.asarray(x), jp["gate_proj"]["weight"],
                              jnp.float32)
    to = tmoe.qlinear_batched(torch.from_numpy(x), tp["gate_proj"]["weight"],
                              torch.float32)
    assert to.shape == (TINY.num_experts, 12, TINY.ff_dim)
    # the same codes and scales: fp32 sums in another order (the int8 rows'
    # codes are equal, their products exact)
    assert _rel(to.numpy(), jo) <= 1e-5


@pytest.mark.parametrize("recipe", ["int8_wo", "uint4_wo", "int8_qmm"])
def test_quantize_moe_and_convert_match_jax(recipe):
    """The port's ``quantize_moe`` stores the banks as the JAX package's
    does (codes, scales, meta), and a converted JAX bank is such a
    QTensor; an unpacked bank's experts are views of it."""
    g = torch.Generator().manual_seed(12)
    tp = tmoe.init_moe(TINY, generator=g, device="cpu")
    jp = _jax_tree(_np_tree(tp))
    kw = dict(RECIPES[recipe])
    fmt = kw.pop("fmt")
    jq = jmoe.quantize_moe(jp, fmt, **kw)
    tq = tmoe.quantize_moe(tp, fmt, **kw)
    conv = params_from_numpy(jq, "cpu")
    for name in ("gate_proj", "up_proj", "down_proj"):
        a, b, c = tq[name]["weight"], jq[name]["weight"], conv[name]["weight"]
        assert isinstance(a, QTensor) and isinstance(c, QTensor)
        assert a.meta == c.meta
        np.testing.assert_array_equal(a.qdata.view(torch.uint8).numpy(),
                                      np.asarray(b.qdata).view(np.uint8))
        np.testing.assert_allclose(a.scale.numpy(), np.asarray(b.scale),
                                   rtol=1e-6)
        assert torch.equal(a.qdata, c.qdata)
        if c.meta.is_packed:   # packed codes run across the experts' rows
            continue
        e = tmoe._experts(c)
        assert layer_count(e) == TINY.num_experts
        v = layer_view(e, 1)
        assert v.qdata.data_ptr() == c.qdata[1].data_ptr()
