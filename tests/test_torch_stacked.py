"""Stacked DiT blocks (the driver's entry runs the stacked tree): ``convert``
carries a stacked JAX tree as the port's stacked QTensors, the port's
``stack_dit_blocks`` / ``dit_forward`` read it layer by layer through views
of the stacked storage, and ``make_staged_dit_forward`` computes
``dit_forward``.

Tolerances: the port's stacked forward, its list forward, the list of
views and the staged forward run the same operations on the same operands,
so they are bit-equal on the CPU.  Against JAX's stacked forward on
rowwise int8 with the quantized matmul, the bound of tests/test_torch_dit.py
(max 4e-2, mean 4e-3 of max |out|: activation codes at rounding ties flip),
and each stacked layer's ``qlinear`` at 40 rows as in its
``test_qlinear_routes`` (rtol 1e-5 plus 2e-5 of max |out|).  Parity with
JAX uses rowwise scales only: the JAX stacked gate reads layer 0's grouped
scales for every layer (a known defect of the reference); grouped stacks are
held against the port's own list forward."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu.models import dit as jdit
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.kernels import scaled_mm as ks
from sdnq_tpu_torch.models import dit as tdit
from sdnq_tpu_torch.tensor import layer_count, layer_view

J_LAYERS = importlib.import_module("sdnq_tpu.layers")
CFG_T = tdit.FLUX_TINY_CONFIG
CFG_J = jdit.FLUX_TINY_CONFIG
B, HW, TXT = 1, (8, 8), 32   # 32 text rows and more: the quantized matmul
QMM = dict(weights_dtype="int8", use_quantized_matmul=True,
           dequant_dtype="float32")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.numpy()


def _keep_q(tree):
    return jax.tree_util.tree_map(
        lambda a: a if isinstance(a, J.QTensor) else np.asarray(a), tree,
        is_leaf=lambda a: isinstance(a, J.QTensor))


@pytest.fixture(scope="module")
def weights():
    """The port's seeded init as numpy (the JAX init takes seconds
    eagerly), and the inputs of one step."""
    np_params = _np(tdit.init_dit(CFG_T, device="cpu"))
    rng = np.random.default_rng(0)
    inputs = dict(img=rng.normal(size=(B, HW[0] * HW[1], CFG_T.in_channels)),
                  txt=rng.normal(size=(B, TXT, CFG_T.txt_dim)),
                  t=np.full((B,), 0.6), pooled=rng.normal(
                      size=(B, CFG_T.vec_dim)), g=np.full((B,), 3.5))
    return np_params, {k: v.astype(np.float32) for k, v in inputs.items()}


def _port(params, inputs, forward=tdit.dit_forward):
    f = lambda k: torch.from_numpy(inputs[k])  # noqa: E731
    return forward(params, f("img"), f("txt"), f("t"), f("pooled"), CFG_T,
                   guidance=f("g"),
                   freqs=tdit.make_rope_freqs(CFG_T, TXT, HW, device="cpu"),
                   device="cpu")


def _stacked_qtensors(tree):
    """{dotted path: QTensor} of the stacked QTensors in the block trees."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}.{i}")
        elif isinstance(x, T.QTensor) and layer_count(x) is not None:
            out[path] = x
    for key in ("transformer_blocks", "single_transformer_blocks"):
        walk(tree[key], key)
    return out


def test_convert_stacked_jax_tree_matches_jax(weights):
    np_params, inputs = weights
    jq, _ = J.quantize_model(jax.tree_util.tree_map(jnp.asarray, np_params),
                             J.QuantConfig(**QMM),
                             arch="FluxTransformer2DModel")
    js = jdit.stack_dit_blocks(jq)
    # the Flux skip keys leave block 0's modulation unquantized
    assert set(js["single_transformer_blocks"]) == {"first", "rest"}
    ts = params_from_numpy(_keep_q(js), "cpu")
    stacked = _stacked_qtensors(ts)
    assert stacked and all(layer_count(q) in (CFG_T.depth_double,
                                              CFG_T.depth_single - 1)
                           for q in stacked.values())
    assert all(q.scale.shape[0] == layer_count(q) for q in stacked.values())
    # each stacked layer's qlinear against JAX's on that layer
    flat, _ = jax.tree_util.tree_flatten_with_path(
        js, is_leaf=lambda a: isinstance(a, J.QTensor))
    jmap = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): a
            for path, a in flat if isinstance(a, J.QTensor)}
    assert set(stacked) <= set(jmap)
    rng = np.random.default_rng(1)
    for path in ("transformer_blocks.img_attn.qkv.weight",
                 "single_transformer_blocks.rest.linear1.weight"):
        q, ja = stacked[path], jmap[path]
        x = rng.normal(size=(40, q.meta.original_shape[1])).astype(
            np.float32)
        for i in range(layer_count(q)):
            ref = np.asarray(J_LAYERS.qlinear(
                jnp.asarray(x), dataclasses.replace(ja, layer=i)))
            out = T.qlinear(torch.from_numpy(x), layer_view(q, i)).numpy()
            np.testing.assert_allclose(out, ref, rtol=1e-5,
                                       atol=2e-5 * np.abs(ref).max())
    f = lambda k: jnp.asarray(inputs[k])  # noqa: E731
    ref = np.asarray(jdit.dit_forward(
        js, f("img"), f("txt"), f("t"), f("pooled"), CFG_J,
        guidance=f("g"), freqs=jdit.make_rope_freqs(CFG_J, TXT, HW)))
    out = _port(ts, inputs).numpy()
    err = np.abs(out - ref)
    scale = np.abs(ref).max()
    assert err.max() < 4e-2 * scale and err.mean() < 4e-3 * scale, (
        err.max() / scale, err.mean() / scale)


def test_convert_refuses_what_it_cannot_read(weights):
    np_params, _ = weights
    jq = J.quantize_tensor(jnp.asarray(np_params["transformer_blocks"][0][
        "img_attn"]["qkv"]["weight"]), "int8")
    bad = dataclasses.replace(jq, qdata=jq.qdata.reshape(-1))
    with pytest.raises(ValueError, match="fit neither"):
        params_from_numpy({"w": bad}, "cpu")
    bad = dataclasses.replace(jq, scale=jnp.stack([jq.scale] * 2))
    with pytest.raises(ValueError, match="does not fit"):
        params_from_numpy({"w": bad}, "cpu")


@pytest.mark.parametrize("qc", [
    QMM, dict(weights_dtype="int8", dequant_dtype="float32")],
    ids=["int8_qmm", "int8_grouped"])
def test_stacked_equals_list_views_share_storage(weights, qc):
    """Rowwise int8 with the quantized matmul and SDNQ's default grouped
    int8 weight-only recipe: the stacked forward, the forward over the
    views and the list forward are bit-equal; every view's arrays lie in
    the stacked storage, contiguous, at layer i's offset."""
    np_params, inputs = weights
    tq, _ = T.quantize_model(params_from_numpy(np_params, "cpu"),
                             T.QuantConfig(**qc),
                             arch="FluxTransformer2DModel", device="cpu")
    st = tdit.stack_dit_blocks(tq)
    views = tdit.unstack_dit_blocks(st)
    ref = _port(tq, inputs)
    assert torch.equal(_port(st, inputs), ref)
    assert torch.equal(_port(views, inputs), ref)
    for q in _stacked_qtensors(st).values():
        for i in range(layer_count(q)):
            v = layer_view(q, i)
            for a, b in ((v.qdata, q.qdata), (v.scale, q.scale)):
                assert a.is_contiguous()
                assert a.untyped_storage().data_ptr() == \
                    b.untyped_storage().data_ptr()
                assert a.data_ptr() == b.data_ptr() + i * b.stride(0) * \
                    b.element_size()


def test_stacked_gemm_reads_the_stacked_codes(weights, monkeypatch):
    """No per-layer weight copy: every int8 GEMM of the stacked blocks'
    linears gets codes inside the stacked storage."""
    np_params, inputs = weights
    tq, _ = T.quantize_model(params_from_numpy(np_params, "cpu"),
                             T.QuantConfig(**QMM),
                             arch="FluxTransformer2DModel", device="cpu")
    st = tdit.stack_dit_blocks(tq)
    spans = [(q.qdata.data_ptr(), q.qdata.data_ptr() + q.qdata.numel())
             for q in _stacked_qtensors(st).values()]
    seen, real = [], ks.scaled_gemm

    def spy(a, b, *args, **kw):
        seen.append(b.data_ptr())
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ks, "scaled_gemm", spy)
    _port(st, inputs)
    inside = [p for p in seen if any(lo <= p < hi for lo, hi in spans)]
    # 8 linears a double block and 2 a single block take the GEMM (the
    # modulation linears at one row take the GEMV)
    n_stacked = 8 * CFG_T.depth_double + 2 * (CFG_T.depth_single - 1)
    assert len(inside) == n_stacked, (len(inside), len(seen))


def test_staged_forward_equals_dit_forward(weights):
    np_params, inputs = weights
    tq, _ = T.quantize_model(params_from_numpy(np_params, "cpu"),
                             T.QuantConfig(**QMM),
                             arch="FluxTransformer2DModel", device="cpu")
    staged = tdit.make_staged_dit_forward(CFG_T)

    def run(params):
        f = lambda k: torch.from_numpy(inputs[k])  # noqa: E731
        return staged(params, f("img"), f("txt"), f("t"), f("pooled"),
                      f("g"), device="cpu")
    ref = _port(tq, inputs)
    assert torch.equal(run(tq), ref)
    assert torch.equal(run(tdit.stack_dit_blocks(tq)), ref)


def test_svd_layer_view_equals_the_list_layer():
    """uint4 + SVD: a layer view of a stack gives the list layer's output
    bit for bit, at the GEMV's one row and above.  The SVD factors are
    stored contiguous (LAPACK's ``Vt`` is not, and its stacked copy is, so
    BLAS would sum the correction in another order)."""
    from sdnq_tpu_torch.models.dit import _stack
    g = torch.Generator().manual_seed(3)
    qt = T.quantize_tensor(torch.randn(256, 512, generator=g), "uint4",
                           use_svd=True, svd_rank=8, svd_steps=2,
                           dequant_dtype="float32")
    assert qt.svd_up.is_contiguous() and qt.svd_down.is_contiguous()
    stacked = _stack([qt, qt])
    for rows in (1, 8, 64):
        x = torch.randn(rows, 512, generator=g)
        ref = T.qlinear(x, qt)
        for i in range(2):
            assert torch.equal(T.qlinear(x, layer_view(stacked, i)), ref)
