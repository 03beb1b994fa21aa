"""Parameter sharding (``sdnq_tpu_torch.parallel.sharding``) against the
JAX package's ``shard_params`` on conftest's 8-device CPU mesh, on the
same quantized trees (quantized by the port, handed to the JAX package
byte for byte).

Each leaf's placement (the dimension split over which axis, or none)
equals the one non-None entry of JAX's ``NamedSharding`` spec, for the
FLUX_TINY DiT as lists and stacked, int8 weight-only (grouped codes), int8
with the quantized matmul (rowwise codes), uint4 with SVD (packed: row
layers replicate), under ``DIT_TP_RULES`` and under "fsdp", on data 2 x
tensor 4 and tensor 2 meshes.  The port's ranks run as virtual ranks of
one process (``run_virtual``); their shards reassemble to the global
leaves bit for bit.  ``stack_llm_blocks`` stacks the same leaves as the
JAX package's.  Nothing here is compiled: JAX places the arrays only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sdnq_tpu_torch as T
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.models import dit as tdit
from sdnq_tpu_torch.parallel import DIT_TP_RULES, shard_params
from sdnq_tpu_torch.parallel._collectives import run_virtual
from sdnq_tpu_torch.parallel.sharding import Sharded, unshard_params
from sdnq_tpu_torch.tree import tree_leaves_with_paths

FIELDS = ("qdata", "scale", "zero_point", "svd_up", "svd_down")
RECIPES = {
    "int8_wo": dict(weights_dtype="int8", dequant_dtype="float32"),
    "int8_qmm": dict(weights_dtype="int8", use_quantized_matmul=True,
                     dequant_dtype="float32"),
    "uint4_svd": dict(weights_dtype="uint4", use_svd=True, svd_rank=8,
                      dequant_dtype="float32"),
}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.numpy()


def _to_jax(tree):
    """The port's tree as the JAX package's, the same bytes (QTensors with
    the same meta)."""
    import jax.numpy as jnp
    import sdnq_tpu as J
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    if isinstance(tree, T.QTensor):
        return J.QTensor(meta=J.QuantMeta(**dataclasses.asdict(tree.meta)),
                         **{f: None if getattr(tree, f) is None
                            else jnp.asarray(getattr(tree, f).numpy())
                            for f in FIELDS})
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def trees():
    """{recipe: (JAX quantized tree, the port's)}: FLUX_TINY quantized by
    the port (the JAX package's eager SVD takes 18 s here), the same bytes
    in both packages' QTensors."""
    p = tdit.init_dit(tdit.FLUX_TINY_CONFIG, device="cpu")
    out = {}
    for name, kw in RECIPES.items():
        tq, _ = T.quantize_model(p, T.QuantConfig(**kw),
                                 arch="FluxTransformer2DModel", device="cpu")
        out[name] = (_to_jax(tq), tq)
    return out


def _spec_of(ns):
    """(dim, axis) of a NamedSharding's one split dimension, or None."""
    split = [(i, a) for i, a in enumerate(ns.spec) if a is not None]
    assert len(split) <= 1
    return split[0] if split else None


def _placement_of(pl):
    return (pl.dim, pl.axis) if pl.sharded else None


def _jax_specs(jtree, mesh, rules):
    import jax
    import sdnq_tpu as J
    from sdnq_tpu.parallel import shard_params as jshard
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        jshard(jtree, mesh, rules),
        is_leaf=lambda x: isinstance(x, J.QTensor))[0]
    for path, leaf in flat:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        if isinstance(leaf, J.QTensor):
            for f in FIELDS:
                a = getattr(leaf, f)
                if a is not None:
                    out[f"{key}.{f}"] = _spec_of(a.sharding)
        else:
            out[key] = _spec_of(leaf.sharding)
    return out


def _port_specs(sharded):
    out = {}
    for path, leaf in tree_leaves_with_paths(
            sharded, is_leaf=lambda x: isinstance(x, Sharded)):
        if not isinstance(leaf, Sharded):
            continue
        pl = leaf.placement
        if isinstance(pl, T.QTensor):
            for f in FIELDS:
                if getattr(pl, f) is not None:
                    out[f"{path}.{f}"] = _placement_of(getattr(pl, f))
        else:
            out[path] = _placement_of(pl)
    return out


MESHES = {"d2t4": dict(data=2, tensor=4), "t2": dict(tensor=2)}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_match_jax_and_reassemble(trees, recipe, mesh_name,
                                             stacked):
    import jax
    from sdnq_tpu.models import stack_dit_blocks as jstack
    from sdnq_tpu.parallel import create_mesh as jmesh
    shape = MESHES[mesh_name]
    jq, tq = trees[recipe]
    if stacked:
        jq, tq = jstack(jq), tdit.stack_dit_blocks(tq)
    n = int(np.prod(list(shape.values())))
    mesh = jmesh(devices=jax.devices()[:n], **shape)
    want = _jax_specs(jq, mesh, DIT_TP_RULES)

    def rank(m):
        sh = shard_params(tq, m, DIT_TP_RULES)
        return sh, unshard_params(sh)
    res = run_virtual(rank, shape, "cpu")
    got = _port_specs(res[0][0])
    assert got.keys() == want.keys()
    assert got == want
    # every rank's shards reassemble to the global leaves, bit for bit
    flat = dict(tree_leaves_with_paths(
        tq, is_leaf=lambda x: isinstance(x, T.QTensor)))
    for _, whole in res:
        back = dict(tree_leaves_with_paths(
            whole, is_leaf=lambda x: isinstance(x, T.QTensor)))
        assert back.keys() == flat.keys()
        for k, a in flat.items():
            b = back[k]
            if isinstance(a, T.QTensor):
                assert b.meta == a.meta
                for f in FIELDS:
                    if getattr(a, f) is not None:
                        assert torch.equal(getattr(b, f), getattr(a, f)), k
            elif isinstance(a, torch.Tensor):
                assert torch.equal(b, a), k


def test_fsdp_placements_match_jax(trees):
    import jax
    from sdnq_tpu.parallel import create_mesh as jmesh
    jq, tq = trees["int8_wo"]
    rules = {"linear1": "fsdp", "qkv": "fsdp", "proj": None}
    mesh = jmesh(fsdp=4, devices=jax.devices()[:4])
    want = _jax_specs(jq, mesh, rules)
    res = run_virtual(lambda m: shard_params(tq, m, rules), {"fsdp": 4},
                      "cpu")
    assert _port_specs(res[0]) == want


def test_segments_give_whole_heads(trees):
    """A rank's qkv rows are whole heads' q, k and v rows; linear1's also
    its slice of the MLP rows; linear2's input columns follow them."""
    _, tq = trees["int8_qmm"]
    cfg = tdit.FLUX_TINY_CONFIG
    d, mlp = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
    res = run_virtual(lambda m: shard_params(tq, m, DIT_TP_RULES),
                      {"tensor": 2}, "cpu")
    blk = tq["single_transformer_blocks"][0]
    for r, sh in enumerate(res):
        s = sh["single_transformer_blocks"][0]
        rows = torch.cat([torch.arange(i * d + r * d // 2,
                                       i * d + (r + 1) * d // 2)
                          for i in range(3)]
                         + [torch.arange(3 * d + r * mlp // 2,
                                         3 * d + (r + 1) * mlp // 2)])
        assert torch.equal(s["linear1"]["weight"].local.qdata,
                           blk["linear1"]["weight"].qdata[rows])
        cols = torch.cat([torch.arange(r * d // 2, (r + 1) * d // 2),
                          torch.arange(d + r * mlp // 2,
                                       d + (r + 1) * mlp // 2)])
        assert torch.equal(s["linear2"]["weight"].local.qdata,
                           blk["linear2"]["weight"].qdata[:, cols])
        q = s["linear1"]["weight"].local
        assert q.meta.original_shape == ((3 * d + mlp) // 2, d)
        # the row-parallel bias is whole on every rank
        assert torch.equal(s["linear2"]["bias"].local,
                           blk["linear2"]["bias"])


def test_stack_llm_blocks_matches_jax():
    import jax
    import jax.numpy as jnp
    import sdnq_tpu as J
    from sdnq_tpu.models import llm as jl
    p = T.models.init_llm(T.models.LLM_TINY_CONFIG, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, _np(p))
    jq, _ = J.quantize_model(jp, J.QuantConfig(
        weights_dtype="int8", minimum_allowed_numel=4096,
        minimum_allowed_channel_size=16), arch="LlamaForCausalLM")
    tq = params_from_numpy(jq, device="cpu")
    js, ts = jl.stack_llm_blocks(jq), T.models.stack_llm_blocks(tq)
    assert isinstance(ts["layers"], dict)
    jflat = jax.tree_util.tree_flatten_with_path(
        js["layers"], is_leaf=lambda x: isinstance(x, J.QTensor))[0]
    tflat = dict(tree_leaves_with_paths(
        ts["layers"], is_leaf=lambda x: isinstance(x, T.QTensor)))
    assert len(jflat) == len(tflat)
    for path, a in jflat:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        b = tflat[key]
        if isinstance(a, J.QTensor):
            assert dataclasses.asdict(b.meta) == dataclasses.asdict(a.meta)
            for f in FIELDS:
                if getattr(a, f) is not None:
                    np.testing.assert_array_equal(
                        getattr(b, f).numpy(), np.asarray(getattr(a, f)))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # layers of different structures stay a list
    mixed = dict(tq, layers=[tq["layers"][0], p["layers"][1]])
    assert isinstance(T.models.stack_llm_blocks(mixed)["layers"], list)


def test_fsdp_forward_gathers_and_equals(trees):
    """A tree sharded by "fsdp" runs the forward on its gathered layers:
    equal to the unsharded forward bit for bit (virtual ranks)."""
    _, tq = trees["int8_qmm"]
    cfg = tdit.FLUX_TINY_CONFIG
    g = torch.Generator().manual_seed(9)
    img = torch.randn(2, 64, cfg.in_channels, generator=g)
    txt = torch.randn(2, 16, cfg.txt_dim, generator=g)
    t = torch.rand(2, generator=g)
    pooled = torch.randn(2, cfg.vec_dim, generator=g)
    freqs = tdit.make_rope_freqs(cfg, 16, (8, 8), device="cpu")
    rules = {"linear1": "fsdp", "qkv": "fsdp", "fc1": "fsdp"}
    with torch.no_grad():
        ref = tdit.dit_forward(tq, img, txt, t, pooled, cfg, freqs=freqs,
                               device="cpu")
        outs = run_virtual(lambda m: tdit.dit_forward(
            shard_params(tq, m, rules), img, txt, t, pooled, cfg,
            freqs=freqs, device="cpu"), {"fsdp": 4}, "cpu")
    for out in outs:
        assert torch.equal(out, ref)
