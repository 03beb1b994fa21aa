"""The port's parallel layer (``sdnq_tpu_torch.parallel``) on gloo CPU
process groups against the JAX package's on conftest's 8-device CPU mesh,
on the same seeded numpy inputs (the cases of ``test_ring_attention.py``
and ``test_pipeline_parallel.py``).

One ``torch.multiprocessing`` spawn per world size (2, 4, 8) runs all of
that size's cases; the workers import this module, which imports neither
JAX nor the JAX package at its top (the tests import them where they
need them), and run one thread each.  Every rank returns the global
output; the tests check that all ranks agree, hold rank 0's against the
JAX function and against float64 attention, and check that the
in-process ring (``_local_ring``) gives the gloo ring's output bit for
bit.

Limits:
* against the JAX ring, ``max |out - ref| / max |ref|``: 1e-5 where both
  take the XLA block function in fp32 (the port's products in float64);
  4e-3 in token mode, where a P code at a rounding tie moves by one step
  wherever exp differs by an ulp between XLA and torch (measured up to
  6.7e-4; as in ``test_torch_attention.py``);
* against float64 attention: the JAX tests' own, 5e-3 (bf16) and 0.05
  (int8) absolute;
* Ulysses against the JAX function on its XLA route (its Pallas body does
  not run in interpret mode under ``shard_map``), while the port takes
  the kernel route's plain version, which rounds q, k, v and P to bf16
  (measured 7.0e-4 and 1.8e-3 of max |v|): 1e-2 of max |v|, the bound of
  ``test_torch_attention`` for that plain version; equal bit for bit to
  the port's own ``quantized_attention`` on the whole tensors (the same
  per-head arithmetic);
* pipeline: the JAX tests' 1e-5 (tanh) and 1e-4 (quantized blocks)
  absolute, and equal bit for bit to the port's own layer loop.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sdnq_tpu_torch.parallel import (
    create_mesh, pipeline_forward, ring_attention, shard_stage_params,
    ulysses_attention,
)
from sdnq_tpu_torch.parallel.ring_attention import _local_ring


def _qkv(n=256, d=64, seed=0):
    """The inputs of ``test_ring_attention.py``'s cases."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 4, n, d)).astype(np.float32)
            for _ in range(3)]


def _ref(q, k, v, causal=False):
    """float64 softmax attention (``test_ring_attention._ref``)."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    s = np.einsum("bhnd,bhkd->bhnk", q, k) * q.shape[-1] ** -0.5
    if causal:
        n, kn = s.shape[-2:]
        s = np.where(np.arange(n)[:, None] >= np.arange(kn)[None, :], s,
                     -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhnk,bhkd->bhnd", p / p.sum(-1, keepdims=True), v)


# name: (world size, the inputs' shape and seed, keyword arguments)
RING = {
    "bf16_p4": (4, dict(seed=0), dict(matmul_dtype=None)),
    "int8_p4": (4, dict(seed=1), dict(matmul_dtype="int8")),
    "causal_zigzag_p8": (8, dict(seed=2), dict(matmul_dtype="int8",
                                               causal=True)),
    "causal_unbalanced_n132_p4": (4, dict(n=132, seed=5),
                                  dict(matmul_dtype="int8", causal=True)),
    "int8_pv_off_p4": (4, dict(seed=6), dict(matmul_dtype="int8",
                                             quantize_pv=False)),
    "causal_zigzag_d128_p8": (8, dict(n=128, d=128, seed=7),
                              dict(matmul_dtype="int8", causal=True)),
    "bf16_p2": (2, dict(seed=8), dict(matmul_dtype=None)),
    "causal_zigzag_p2": (2, dict(seed=9), dict(matmul_dtype="int8",
                                               causal=True)),
}
ULYSSES = {
    "bf16_p4": (4, dict(seed=3), dict(matmul_dtype=None)),
    "int8_causal_p4": (4, dict(seed=4), dict(matmul_dtype="int8",
                                             is_causal=True)),
}
PIPELINE = {"tanh_l8_p4": 4, "qlinear_l4_p2": 2}
WORLDS = (2, 4, 8)


# ---------------------------------------------------------------------------
# the workers (spawned processes: torch and the port alone)
# ---------------------------------------------------------------------------

def _tanh_block(blk, x):
    return torch.tanh(x @ blk["w"].T)


def _qlinear_block(blk, x):
    from sdnq_tpu_torch import qlinear
    return F.gelu(qlinear(x, blk["w"], out_dtype=torch.float32),
                  approximate="tanh")


BLOCKS = {"tanh_l8_p4": _tanh_block, "qlinear_l4_p2": _qlinear_block}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif hasattr(tree, "qdata"):
        yield from (tree.qdata, tree.scale)
    else:
        yield tree


def _run_cases(world, cases):
    import torch.distributed as dist
    rank = dist.get_rank()
    res = {}
    for name, (_, shape, kw) in RING.items():
        if RING[name][0] != world:
            continue
        q, k, v = (torch.from_numpy(a) for a in _qkv(**shape))
        mesh = create_mesh(sequence=world, device="cpu")
        out = ring_attention(q, k, v, mesh, out_dtype=torch.float32, **kw)
        local = _local_ring(q, k, v, world, out_dtype=torch.float32, **kw)
        res[f"ring/{name}"] = dict(out=out.numpy(),
                                   local_equal=torch.equal(out, local))
    for name, (_, shape, kw) in ULYSSES.items():
        if ULYSSES[name][0] != world:
            continue
        q, k, v = (torch.from_numpy(a) for a in _qkv(**shape))
        mesh = create_mesh(sequence=world, device="cpu")
        res[f"ulysses/{name}"] = dict(out=ulysses_attention(
            q, k, v, mesh, out_dtype=torch.float32, **kw).numpy())
    for name, p in PIPELINE.items():
        if p != world:
            continue
        params, x = cases[name]
        mesh = create_mesh(fsdp=world, device="cpu")
        stage = shard_stage_params(params, mesh)
        base = {t.untyped_storage().data_ptr() for t in _leaves(params)}
        views = all(t.untyped_storage().data_ptr() in base
                    for t in _leaves(stage.params))
        out = pipeline_forward(BLOCKS[name], stage, x, mesh)
        res[f"pipeline/{name}"] = dict(out=out.numpy(), views=views)
    if world == 4:   # the axis groups of a 2 x 2 mesh, and a wrong size
        mesh = create_mesh(data=2, sequence=2, device="cpu")
        res["mesh"] = dict(
            shape=mesh.shape, rank=rank,
            groups={a: dist.get_process_group_ranks(mesh.get_group(a))
                    for a in mesh.axis_names},
            local={a: mesh.get_local_rank(a) for a in mesh.axis_names})
        try:
            create_mesh(sequence=2, device="cpu")
            res["mesh"]["mismatch"] = None
        except ValueError as e:
            res["mesh"]["mismatch"] = str(e)
    return res


def _worker(rank, world, port, case_file, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        cases = torch.load(case_file, weights_only=False)
        torch.save(_run_cases(world, cases),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, cases, tmp):
    import torch.multiprocessing as mp
    case_file = os.path.join(tmp, f"cases{world}.pt")
    out_dir = os.path.join(tmp, f"out{world}")
    os.makedirs(out_dir)
    torch.save(cases, case_file)
    ctx = mp.start_processes(_worker, args=(world, _free_port(), case_file,
                                            out_dir),
                             nprocs=world, join=False)
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"gloo world of {world} did not finish")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the JAX side and the tests
# ---------------------------------------------------------------------------

def _pipeline_cases():
    """The weights and microbatches of ``test_pipeline_parallel.py``, for
    both packages: {name: (JAX params, port params, x)}."""
    import jax
    import jax.numpy as jnp
    from sdnq_tpu import quantize_tensor
    from sdnq_tpu_torch.convert import params_from_numpy

    rng = np.random.default_rng(0)
    ws = rng.normal(size=(8, 64, 64)).astype(np.float32) * 0.1
    x8 = rng.normal(size=(6, 4, 64)).astype(np.float32)
    out = {"tanh_l8_p4": ({"w": jnp.asarray(ws)},
                          {"w": torch.from_numpy(ws)}, x8)}
    rng = np.random.default_rng(1)
    ws = [jnp.asarray(rng.normal(size=(128, 128)).astype(np.float32) * 0.1)
          for _ in range(4)]
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[quantize_tensor(w, "int8") for w in ws])
    x4 = rng.normal(size=(4, 8, 128)).astype(np.float32)
    out["qlinear_l4_p2"] = ({"w": stacked},
                            params_from_numpy({"w": stacked}, device="cpu"),
                            x4)
    return out


@pytest.fixture(scope="module")
def pipe_cases():
    return _pipeline_cases()


@pytest.fixture(scope="module")
def gloo(pipe_cases, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}, one spawn per world."""
    tmp = str(tmp_path_factory.mktemp("gloo"))
    cases = {name: (port, torch.from_numpy(x))
             for name, (_, port, x) in pipe_cases.items()}
    return {w: _spawn(w, cases, tmp) for w in WORLDS}


def _rank0(gloo, key, world):
    ranks = gloo[world]
    for r in ranks[1:]:   # the global output on every rank
        np.testing.assert_array_equal(r[key]["out"], ranks[0][key]["out"])
    return ranks[0][key]


@pytest.mark.parametrize("name", list(RING))
def test_ring_against_jax(gloo, name):
    import jax.numpy as jnp
    from sdnq_tpu.parallel import create_mesh as jmesh
    from sdnq_tpu.parallel import ring_attention as jring
    world, shape, kw = RING[name]
    res = _rank0(gloo, f"ring/{name}", world)
    q, k, v = _qkv(**shape)
    ref = np.asarray(jring(*(jnp.asarray(a) for a in (q, k, v)),
                           jmesh(sequence=world), out_dtype=jnp.float32,
                           **kw))
    out = res["out"]
    token = kw["matmul_dtype"] == "int8" and kw.get("quantize_pv", True)
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel <= (4e-3 if token else 1e-5), rel
    exact = _ref(q, k, v, causal=kw.get("causal", False))
    limit = 0.05 if kw["matmul_dtype"] == "int8" else 5e-3
    assert np.abs(out - exact).max() < limit
    assert res["local_equal"], "the local ring differs from the gloo ring"


@pytest.mark.parametrize("name", list(ULYSSES))
def test_ulysses_against_jax(gloo, name):
    import jax.numpy as jnp
    from sdnq_tpu.parallel import create_mesh as jmesh
    from sdnq_tpu.parallel import ulysses_attention as jul
    from sdnq_tpu_torch.kernels.attention import quantized_attention
    world, shape, kw = ULYSSES[name]
    out = _rank0(gloo, f"ulysses/{name}", world)["out"]
    q, k, v = _qkv(**shape)
    ref = np.asarray(jul(*(jnp.asarray(a) for a in (q, k, v)),
                         jmesh(sequence=world), out_dtype=jnp.float32,
                         **kw))
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(v).max()
    whole = quantized_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                out_dtype=torch.float32, **kw).numpy()
    np.testing.assert_array_equal(out, whole)
    exact = _ref(q, k, v, causal=kw.get("is_causal", False))
    limit = 0.05 if kw["matmul_dtype"] == "int8" else 5e-3
    assert np.abs(out - exact).max() < limit


@pytest.mark.parametrize("name", list(PIPELINE))
def test_pipeline_against_jax(gloo, pipe_cases, name):
    from sdnq_tpu import qlinear as jqlinear
    from sdnq_tpu.parallel import create_mesh as jmesh
    from sdnq_tpu.parallel import pipeline_forward as jpipe
    from sdnq_tpu.parallel import shard_stage_params as jshard
    import jax
    import jax.numpy as jnp
    world = PIPELINE[name]
    res = _rank0(gloo, f"pipeline/{name}", world)
    assert res["views"], "a stage's parameters are not views of the stack"
    jparams, tparams, x = pipe_cases[name]
    if name.startswith("tanh"):
        def jblock(blk, x):
            return jnp.tanh(x @ blk["w"].T)
        atol = 1e-5
    else:
        def jblock(blk, x):
            return jax.nn.gelu(jqlinear(x, blk["w"], out_dtype=jnp.float32))
        atol = 1e-4
    mesh = jmesh(fsdp=world)
    ref = np.asarray(jpipe(jblock, jshard(jparams, mesh), jnp.asarray(x),
                           mesh))
    np.testing.assert_allclose(res["out"], ref, atol=atol, rtol=atol)
    # the port's own loop over the stacked layers, one microbatch at a time
    from sdnq_tpu_torch.parallel.pipeline import _layers, _map, _take
    xs = torch.from_numpy(x)
    for i in range(_layers(tparams)):
        xs = torch.stack([BLOCKS[name](_map(tparams, lambda t: _take(t, i)),
                                       m) for m in xs])
    np.testing.assert_array_equal(res["out"], xs.numpy())


def test_mesh_axis_groups(gloo):
    """A 2 (data) x 2 (sequence) mesh on 4 ranks: each axis group holds
    the ranks that differ only on that axis, in the JAX mesh's order
    (rank = data * 2 + sequence); a mesh of another size raises."""
    for r, res in enumerate(gloo[4]):
        m = res["mesh"]
        assert m["rank"] == r
        assert m["shape"] == dict(data=2, fsdp=1, tensor=1, sequence=2)
        assert m["groups"]["data"] == [r % 2, r % 2 + 2]
        assert m["groups"]["sequence"] == [r - r % 2, r - r % 2 + 1]
        assert m["groups"]["fsdp"] == m["groups"]["tensor"] == [r]
        assert m["local"] == dict(data=r // 2, fsdp=0, tensor=0,
                                  sequence=r % 2)
        assert "needs 2 ranks, the world has 4" in m["mismatch"]


def test_world_of_one_in_process(monkeypatch):
    """Without a process group a mesh of one works in one process, as a
    JAX one-device mesh: the ring, Ulysses and the pipeline at P = 1 are
    the single-device functions; another size raises, and without a card
    the mesh must be asked for on the CPU."""
    mesh = create_mesh(sequence=1, device="cpu")
    assert mesh.size == 1 and mesh.device_mesh is None
    assert mesh.get_group("sequence") is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        create_mesh(data=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_mesh()
    q, k, v = (torch.from_numpy(a) for a in _qkv(n=512, d=128, seed=11))
    for kw in (dict(matmul_dtype=None), dict(causal=True)):
        out = ring_attention(q, k, v, mesh, out_dtype=torch.float32, **kw)
        assert torch.equal(out, _local_ring(q, k, v, 1,
                                            out_dtype=torch.float32, **kw))
        exact = _ref(q, k, v, causal=kw.get("causal", False))
        limit = 5e-3 if kw.get("matmul_dtype", "int8") is None else 0.05
        assert np.abs(out.numpy() - exact).max() < limit
    from sdnq_tpu_torch.kernels.attention import quantized_attention
    assert torch.equal(ulysses_attention(q, k, v, mesh),
                       quantized_attention(q, k, v, matmul_dtype="int8"))
    ws = {"w": torch.randn(4, 16, 16, generator=torch.Generator()
                           .manual_seed(0)) * 0.2}
    x = torch.randn(3, 2, 16, generator=torch.Generator().manual_seed(1))
    fmesh = create_mesh(fsdp=1, device="cpu")
    out = pipeline_forward(_tanh_block, ws, x, fmesh)
    seq = x
    for i in range(4):
        seq = _tanh_block({"w": ws["w"][i]}, seq)
    assert torch.equal(out, seq)


def test_ring_layouts_and_raises():
    """The zigzag permutation puts chunk pair (i, 2P - 1 - i) on rank i,
    and the local ring at P = 2, 4, 8 matches float64 attention in every
    layout; unequal heads (GQA not repeated), a sequence that does not
    split and Ulysses heads that do not split raise."""
    from sdnq_tpu_torch.parallel.ring_attention import _setup
    q = torch.zeros(1, 2, 16, 64)
    ring, perm = _setup(q, q, q, 4, None, True, "int8", None, None)
    assert ring.balance and perm.tolist() == [
        0, 1, 14, 15, 2, 3, 12, 13, 4, 5, 10, 11, 6, 7, 8, 9]
    ring, perm = _setup(q[:, :, :12], q[:, :, :12], q[:, :, :12], 4, None,
                        True, "int8", None, None)
    assert not ring.balance and perm is None
    with pytest.raises(ValueError, match="equal Q, K and V"):
        _local_ring(q, q[:, :1], q[:, :1], 2)
    with pytest.raises(ValueError, match="not divisible"):
        _local_ring(q[:, :, :15], q[:, :, :15], q[:, :, :15], 2)
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention(q, q, q, type("M", (), {"shape": {"sequence": 4}
                                                  })())
    qn, kn, vn = _qkv(n=256, d=128, seed=12)
    exact = _ref(qn, kn, vn, causal=True)
    for p in (2, 4, 8):
        out = _local_ring(*(torch.from_numpy(a) for a in (qn, kn, vn)), p,
                          causal=True, out_dtype=torch.float32)
        assert np.abs(out.numpy() - exact).max() < 0.05
