"""The port's ``io`` against the JAX package's and the ``safetensors``
package: pre-quantized files cross both ways with every component
bit-equal, the port's own safetensors reader and writer agree with the
package's, HF state dicts stream and quantize as the JAX loader does, and
the native reader matches ``safe_open``.

Files are written to pytest's temporary directories; weights come from a
numpy seed.  The port runs on the CPU (``device="cpu"``)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu.io import load_quantized as j_load, save_quantized as j_save
from sdnq_tpu.models.dit import stack_dit_blocks as j_stack
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.io import (
    load_and_quantize_state_dict, load_quantized, save_quantized,
    stream_state_dict,
)
from sdnq_tpu_torch.io import _safetensors as S
from sdnq_tpu_torch.io.hf import CheckpointCoverageError, check_tree_coverage
from sdnq_tpu_torch.native import fast_load_safetensors, native_available
from sdnq_tpu_torch.native import loader as native_loader

ROOT = Path(__file__).resolve().parent.parent
_QT_FIELDS = ("qdata", "scale", "zero_point", "svd_up", "svd_down")


def _w(rng, shape):
    return jnp.asarray(rng.normal(size=shape).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _tree(kind: str):
    """A JAX parameter tree quantized by the JAX package for one storage
    case, and the QuantConfig it was quantized under (made once a case;
    the tests only read them)."""
    rng = np.random.default_rng(7)
    small = dict(minimum_allowed_numel=1024, minimum_allowed_channel_size=16)
    if kind == "stacked_int8":
        cfg = J.QuantConfig(weights_dtype="int8", use_quantized_matmul=True,
                            **small)
        blocks = [{"fc": {"weight": _w(rng, (96, 64)),
                          "bias": _w(rng, (96,))}} for _ in range(3)]
        qp, cfg = J.quantize_model({"transformer_blocks": blocks,
                                    "norm": {"weight": _w(rng, (64,))}}, cfg)
        return j_stack(qp), cfg
    params = {"blocks": [{"attn": {"to_q": {"weight": _w(rng, (128, 256)),
                                            "bias": _w(rng, (128,))}}},
                         {"mlp": {"fc1": {"weight": _w(rng, (64, 256))}}}],
              "norm": {"weight": _w(rng, (256,))}}
    cfg = {"int8_qmm": J.QuantConfig(weights_dtype="int8",
                                     use_quantized_matmul=True, **small),
           "uint4_bitplane": J.QuantConfig(weights_dtype="uint4", **small),
           "uint4_halfsplit": J.QuantConfig(weights_dtype="uint4", **small),
           "e4m3": J.QuantConfig(weights_dtype="float8_e4m3fn",
                                 use_quantized_matmul=True, **small),
           "zero_point": J.QuantConfig(weights_dtype="uint8", **small),
           "svd_r2": J.QuantConfig(weights_dtype="int4", use_svd=True,
                                   svd_rank=2, **small),
           "bf16_leaves": J.QuantConfig(weights_dtype="float16",
                                        use_quantized_matmul=True, **small),
           }[kind]
    if kind == "uint4_bitplane":
        # 255 columns: no group size divides them and half-split needs an
        # even row, so the codes are bit-planes
        params["blocks"][1]["mlp"]["fc1"]["weight"] = _w(rng, (64, 255))
    if kind == "bf16_leaves":
        params["norm"]["weight"] = params["norm"]["weight"].astype(
            jnp.bfloat16)
        params["blocks"][0]["attn"]["to_q"]["bias"] = params["blocks"][0][
            "attn"]["to_q"]["bias"].astype(jnp.bfloat16)
    return J.quantize_model(params, cfg)


CASES = ["int8_qmm", "uint4_bitplane", "uint4_halfsplit", "e4m3",
         "zero_point", "svd_r2", "bf16_leaves", "stacked_int8"]


def _bits(a) -> np.ndarray:
    """The bytes of a JAX array or torch tensor as a same-width integer
    numpy array (bf16 / fp8 by their bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            a = a.view(torch.int16 if a.element_size() == 2 else torch.uint8)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        a = a.view(np.int16 if a.dtype.itemsize == 2 else np.uint8)
    return a


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return np.asarray(a).dtype.name


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of either package (QTensors are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _assert_same_tree(got, want):
    """Same paths; QTensors with equal meta and bit-equal components of
    equal dtypes; plain leaves bit-equal with equal dtypes."""
    fg, fw = _flat(got), _flat(want)
    assert set(fg) == set(fw)
    for path, w in fw.items():
        g = fg[path]
        if hasattr(w, "meta"):
            assert dataclasses.asdict(g.meta) == dataclasses.asdict(w.meta)
            for f in _QT_FIELDS:
                a, b = getattr(g, f), getattr(w, f)
                assert (a is None) == (b is None), (path, f)
                if a is not None:
                    assert _dtype_name(a) == _dtype_name(b), (path, f)
                    assert tuple(a.shape) == tuple(b.shape), (path, f)
                    np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            assert _dtype_name(g) == _dtype_name(w), path
            np.testing.assert_array_equal(_bits(g), _bits(w))


def test_storage_cases_are_what_they_say():
    qp, _ = _tree("uint4_bitplane")
    assert qp["blocks"][1]["mlp"]["fc1"]["weight"].meta.pack_layout \
        == "bitplane"
    qp, _ = _tree("uint4_halfsplit")
    assert qp["blocks"][1]["mlp"]["fc1"]["weight"].meta.pack_layout \
        == "halfsplit"
    qp, _ = _tree("zero_point")
    assert qp["blocks"][0]["attn"]["to_q"]["weight"].zero_point is not None
    qp, _ = _tree("svd_r2")
    assert qp["blocks"][0]["attn"]["to_q"]["weight"].svd_up.shape[-1] == 2
    qp, _ = _tree("bf16_leaves")
    assert qp["blocks"][0]["attn"]["to_q"]["weight"].qdata.dtype \
        == jnp.bfloat16
    qp, _ = _tree("stacked_int8")
    assert qp["transformer_blocks"]["fc"]["weight"].qdata.shape == (3, 96, 64)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", CASES)
def test_quantized_files_cross(tmp_path, case, direction):
    jtree, jcfg = _tree(case)
    if direction == "jax_to_port":
        j_save(jtree, str(tmp_path), jcfg)
        got, cfg = load_quantized(str(tmp_path), device="cpu")
        assert cfg.to_dict() == T.QuantConfig.from_dict(
            jcfg.to_dict()).to_dict()
    else:
        save_quantized(params_from_numpy(jtree, device="cpu"),
                       str(tmp_path), T.QuantConfig.from_dict(
                           jcfg.to_dict()))
        got, cfg = j_load(str(tmp_path))
        assert cfg.weights_dtype == jcfg.weights_dtype
    _assert_same_tree(got, jtree)


@pytest.mark.parametrize("case", ["int8_qmm", "uint4_halfsplit", "e4m3",
                                  "svd_r2", "bf16_leaves", "stacked_int8"])
def test_both_packages_write_the_same_files(tmp_path, case):
    """The same tree saved by each package: equal sidecars, and every
    tensor of the two files with the same tag, shape and bytes."""
    jtree, jcfg = _tree(case)
    j_save(jtree, str(tmp_path / "j"), jcfg)
    save_quantized(params_from_numpy(jtree, device="cpu"),
                   str(tmp_path / "t"))
    for name in ("sdnq_tpu_meta.json",):
        assert json.loads((tmp_path / "j" / name).read_text()) == \
            json.loads((tmp_path / "t" / name).read_text())
    files = [str(tmp_path / d / "model.safetensors") for d in ("j", "t")]
    with safe_open(files[0], "np") as a, safe_open(files[1], "np") as b:
        assert a.metadata() == b.metadata() == {"format": "sdnq_tpu"}
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            x, y = a.get_tensor(k), b.get_tensor(k)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)
    assert S.read_header(files[0])[0] == S.read_header(files[1])[0]


def test_plain_leaves_keep_their_dtypes(tmp_path):
    tree = {"a": torch.randn(4, 8), "b": torch.randn(3).bfloat16(),
            "c": torch.arange(5, dtype=torch.int32),
            "d": torch.randn(6).to(torch.float8_e5m2),
            "blocks": [{"x": torch.ones(2, dtype=torch.int8)},
                       {"x": torch.zeros(2, dtype=torch.int8)}]}
    save_quantized(tree, str(tmp_path))
    got, cfg = load_quantized(str(tmp_path), device="cpu")
    assert cfg is None and isinstance(got["blocks"], list)
    _assert_same_tree(got, tree)
    jgot, _ = j_load(str(tmp_path))
    assert np.asarray(jgot["b"]).dtype.name == "bfloat16"
    assert np.asarray(jgot["d"]).dtype.name == "float8_e5m2"
    np.testing.assert_array_equal(_bits(jgot["d"]), _bits(tree["d"]))


# ---------------------------------------------------------------------------
# the format: the port's reader and writer against the safetensors package
# ---------------------------------------------------------------------------

def _every_tag(rng):
    """One tensor per safetensors tag, as torch tensors."""
    return {
        "f64": torch.from_numpy(rng.normal(size=(3, 5))),
        "f32": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(9,)).astype(
            np.float32)).bfloat16(),
        "i64": torch.from_numpy(rng.integers(-9, 9, (4,))),
        "i32": torch.from_numpy(rng.integers(-9, 9, (2, 2)).astype(np.int32)),
        "i16": torch.from_numpy(rng.integers(-9, 9, (5,)).astype(np.int16)),
        "i8": torch.from_numpy(rng.integers(-9, 9, (3, 1)).astype(np.int8)),
        "u64": torch.from_numpy(rng.integers(0, 9, (2,)).astype(np.uint64)),
        "u32": torch.from_numpy(rng.integers(0, 9, (3,)).astype(np.uint32)),
        "u16": torch.from_numpy(rng.integers(0, 9, (6,)).astype(np.uint16)),
        "u8": torch.from_numpy(rng.integers(0, 255, (5,)).astype(np.uint8)),
        "bool": torch.from_numpy(rng.integers(0, 2, (4,)).astype(bool)),
        "e4m3": torch.from_numpy(rng.normal(size=(8,)).astype(
            np.float32)).to(torch.float8_e4m3fn),
        "e5m2": torch.from_numpy(rng.normal(size=(8,)).astype(
            np.float32)).to(torch.float8_e5m2),
        "empty": torch.zeros((0, 4)),
        "scalar": torch.tensor(2.5),
        "strided": torch.arange(24, dtype=torch.float32).reshape(4, 6).t(),
    }


def test_every_tag_against_the_package(tmp_path):
    from safetensors.torch import load_file, save_file
    tensors = _every_tag(np.random.default_rng(0))
    assert {S.TAGS[t.dtype] for t in tensors.values()} == set(S.DTYPES)
    ours, theirs = str(tmp_path / "ours.st"), str(tmp_path / "theirs.st")
    S.save_file(tensors, ours, metadata={"k": "v"})
    save_file({k: v.contiguous() for k, v in tensors.items()}, theirs,
              metadata={"k": "v"})
    # the data starts on an 8-byte boundary, each tensor at a multiple of
    # its element size
    header, start = S.read_header(ours)
    assert start % 8 == 0
    for k, info in header.items():
        assert info["data_offsets"][0] % tensors[k].element_size() == 0
    for got in (load_file(ours), S.load_file(theirs), S.load_file(ours)):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            np.testing.assert_array_equal(_bits(got[k]), _bits(t))
    with safe_open(ours, "pt") as f:
        assert f.metadata() == {"k": "v"}
    # the same layout as the package's writer
    assert S.read_header(theirs)[0] == header


@pytest.mark.parametrize("index", S.INDEX_NAMES)
def test_sharded_index_and_directories(tmp_path, index):
    rng = np.random.default_rng(1)
    sd = {f"layers.{i}.w": rng.normal(size=(4, 3)).astype(np.float32)
          for i in range(5)}
    shards = {"a-00001.safetensors": ["layers.0.w", "layers.1.w"],
              "a-00002.safetensors": ["layers.2.w", "layers.3.w",
                                      "layers.4.w"]}
    for name, keys in shards.items():
        np_save_file({k: sd[k] for k in keys}, str(tmp_path / name))
    (tmp_path / "stray.safetensors").write_bytes(b"")   # not in the index
    (tmp_path / index).write_text(json.dumps({
        "metadata": {"total_size": 0},
        "weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    got = dict(stream_state_dict(str(tmp_path)))
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), sd[k])
    os.remove(tmp_path / index)
    os.remove(tmp_path / "stray.safetensors")
    assert set(dict(stream_state_dict(str(tmp_path)))) == set(sd)
    assert set(dict(stream_state_dict(
        str(tmp_path / "a-00001.safetensors")))) == set(shards[
            "a-00001.safetensors"])


def test_corrupt_headers_raise(tmp_path):
    p = str(tmp_path / "x.safetensors")
    S.save_file({"a": torch.ones(4)}, p)
    raw = bytearray(Path(p).read_bytes())
    Path(p).write_bytes(bytes(raw[:-4]))       # data cut short
    with pytest.raises(ValueError, match="does not fit"):
        S.read_header(p)
    with pytest.raises(ValueError, match="no safetensors tag"):
        S.save_file({"c": torch.zeros(2, dtype=torch.complex64)}, p)


def test_loaders_need_neither_safetensors_nor_transformers(tmp_path):
    """With ``safetensors`` and ``transformers`` blocked from import, the
    port writes and reads pre-quantized files, streams an HF state dict
    and reads with the native reader."""
    code = f"""
import sys
sys.modules["safetensors"] = None
sys.modules["transformers"] = None
import torch
import sdnq_tpu_torch as T
from sdnq_tpu_torch.io import (save_quantized, load_quantized,
                               load_and_quantize_state_dict)
from sdnq_tpu_torch.io._safetensors import save_file
from sdnq_tpu_torch.native import fast_load_safetensors
d = {str(tmp_path)!r}
g = torch.Generator().manual_seed(0)
w = torch.randn(64, 128, generator=g)
qt = T.quantize_tensor(w, "int8", use_quantized_matmul=True)
save_quantized({{"fc": {{"weight": qt}}}}, d + "/q")
got, _ = load_quantized(d + "/q", device="cpu")
assert torch.equal(got["fc"]["weight"].qdata, qt.qdata)
save_file({{"fc.weight": w}}, d + "/m.safetensors")
p, _ = load_and_quantize_state_dict(
    d + "/m.safetensors", T.QuantConfig(minimum_allowed_numel=1024),
    device="cpu")
assert torch.equal(p["fc"]["weight"].qdata, T.quantize_tensor(
    w, "int8").qdata)
assert torch.equal(fast_load_safetensors(d + "/m.safetensors",
                                         device="cpu")["fc.weight"], w)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


# ---------------------------------------------------------------------------
# streaming and quantizing an HF state dict, against the JAX loader
# ---------------------------------------------------------------------------

def _hf_state_dict(rng):
    def w(shape):
        return rng.normal(size=shape).astype(np.float32)
    return {
        "transformer_blocks.0.attn.to_q.weight": w((256, 256)),
        "transformer_blocks.0.attn.to_q.bias": w((256,)),
        "transformer_blocks.1.ff.fc1.weight": w((512, 256)),
        "transformer_blocks.1.ff.fc2.weight": w((256, 512)),
        "proj_out.weight": w((64, 256)),
        "norm.weight": w((256,)),
        # int32: JAX without x64 would narrow an int64 (the port keeps it)
        "step": np.asarray([3], np.int32),
    }


@pytest.mark.parametrize("qc", [
    dict(weights_dtype="int8", use_quantized_matmul=True),
    dict(weights_dtype="uint4", group_size=32),
])
def test_stream_and_quantize_matches_jax(tmp_path, qc):
    from sdnq_tpu.io import load_and_quantize_state_dict as j_stream
    sd = _hf_state_dict(np.random.default_rng(2))
    path = str(tmp_path / "model.safetensors")
    np_save_file(sd, path)
    jp, jcfg = j_stream(path, J.QuantConfig(**qc),
                        arch="FluxTransformer2DModel")
    tp, tcfg = load_and_quantize_state_dict(
        path, T.QuantConfig(**qc), arch="FluxTransformer2DModel",
        device="cpu")
    assert tcfg.modules_to_not_convert == jcfg.modules_to_not_convert
    _assert_same_tree(tp, jp)
    blocks = tp["transformer_blocks"]
    assert isinstance(blocks[0]["attn"]["to_q"]["weight"], T.QTensor)
    assert not isinstance(tp["proj_out"]["weight"], T.QTensor)  # skip key
    assert blocks[0]["attn"]["to_q"]["bias"].dtype == torch.bfloat16
    assert tp["step"].dtype == torch.int32


def test_dynamic_ladder_chooses_as_jax(tmp_path):
    from sdnq_tpu.io import load_and_quantize_state_dict as j_stream
    # one shape, so that JAX compiles each rung of the ladder once
    rng = np.random.default_rng(3)

    def student_t(shape, nu=3):
        chi2 = sum(rng.normal(size=shape) ** 2 for _ in range(nu))
        return (rng.normal(size=shape) / np.sqrt(chi2 / nu)).astype(
            np.float32)
    sd = {"blocks.0.fc.weight": rng.normal(size=(64, 256)).astype(
        np.float32)}
    sd.update({f"blocks.{i}.fc.weight": student_t((64, 256))
               for i in (1, 2)})
    path = str(tmp_path / "model.safetensors")
    np_save_file(sd, path)
    qc = dict(weights_dtype="int4", use_dynamic_quantization=True)
    jp, _ = j_stream(path, J.QuantConfig(**qc), dtype=jnp.float32)
    tp, _ = load_and_quantize_state_dict(path, T.QuantConfig(**qc),
                                         dtype=torch.float32, device="cpu")
    fj, ft = _flat(jp), _flat(tp)
    fmts = {}
    for path_, j in fj.items():
        t = ft[path_]
        assert hasattr(t, "meta") == hasattr(j, "meta"), path_
        if hasattr(j, "meta"):
            assert dataclasses.asdict(t.meta) == dataclasses.asdict(j.meta)
            np.testing.assert_array_equal(_bits(t.qdata), _bits(j.qdata))
            fmts[path_] = t.meta.fmt
    # the tails push weights 1 and 2 off the start format
    assert fmts and set(fmts.values()) != {"int4"}, fmts


def test_strict_stream_names_unconsumed_keys(tmp_path):
    sd = {"model.w.weight": np.ones((4, 4), np.float32),
          "model.rotary_emb.inv_freq": np.ones((2,), np.float32),
          "junk.weight": np.ones((2,), np.float32)}
    path = str(tmp_path / "m.safetensors")
    np_save_file(sd, path)

    def key_map(k):
        return k[len("model."):] if k.startswith("model.w") else None
    with pytest.raises(CheckpointCoverageError, match="junk.weight"):
        load_and_quantize_state_dict(path, key_map=key_map,
                                     known_skips=("rotary_emb",),
                                     device="cpu")
    p, _ = load_and_quantize_state_dict(path, key_map=key_map,
                                        known_skips=("rotary_emb",),
                                        strict=False, device="cpu")
    assert set(p) == {"w"}


def test_check_tree_coverage_exact_and_mismatch():
    exp = {"a": {"w": 1, "b": 2}, "blocks": [{"w": 3}, {"w": 4}]}
    check_tree_coverage({"a": {"w": 0, "b": 0},
                         "blocks": [{"w": 0}, {"w": 0}]}, exp)
    with pytest.raises(CheckpointCoverageError, match="missing: a.b"):
        check_tree_coverage({"a": {"w": 0},
                             "blocks": [{"w": 0}, {"w": 0}]}, exp)
    with pytest.raises(CheckpointCoverageError, match="unexpected: zz"):
        check_tree_coverage({"a": {"w": 0, "b": 0}, "zz": 9,
                             "blocks": [{"w": 0}, {"w": 0}]}, exp)
    check_tree_coverage({"a": {"w": 0, "b": 0}, "opt": {"x": 1},
                         "blocks": [{"w": 0}, {"w": 0}]}, exp,
                        optional=("opt",))
    check_tree_coverage({"a": {"w": 0}, "blocks": [{"w": 0}, {"w": 0}]},
                        exp, optional=("a.b",))


# ---------------------------------------------------------------------------
# the native reader
# ---------------------------------------------------------------------------

def test_native_library_builds():
    assert native_available(), "g++ build of st_reader.cpp failed"


def test_fast_load_matches_safetensors(tmp_path):
    rng = np.random.default_rng(0)
    tensors = _every_tag(rng)
    tensors["big"] = torch.from_numpy(rng.normal(size=(1 << 20,)).astype(
        np.float32))                         # 4 MiB, split over ranges
    p = str(tmp_path / "m.safetensors")
    S.save_file(tensors, p)
    for threads, chunk in ((4, native_loader.CHUNK), (3, 1 << 16)):
        native_loader.CHUNK = chunk
        try:
            out = fast_load_safetensors(p, num_threads=threads, device="cpu")
        finally:
            native_loader.CHUNK = 16 << 20
        assert set(out) == set(tensors)
        with safe_open(p, "pt") as f:
            for k in tensors:
                assert out[k].dtype == tensors[k].dtype
                np.testing.assert_array_equal(_bits(out[k]),
                                              _bits(f.get_tensor(k)))


def test_fast_load_key_subset(tmp_path):
    p = str(tmp_path / "m.safetensors")
    np_save_file({"x": np.ones((4, 4), np.float32),
                  "y": np.zeros((2,), np.int8)}, p)
    out = fast_load_safetensors(p, keys=["x"], device="cpu")
    assert list(out) == ["x"] and torch.equal(out["x"], torch.ones(4, 4))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "st_reader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_SRC", bad)
    monkeypatch.setattr(native_loader, "_build_dir", lambda: tmp_path / "b")
    p = str(tmp_path / "m.safetensors")
    S.save_file({"x": torch.ones(2)}, p)
    with pytest.raises(RuntimeError, match="building st_reader.cpp failed"):
        fast_load_safetensors(p, device="cpu")
    assert not native_available()


def test_io_entry_points_need_a_device(tmp_path, monkeypatch):
    """Without a card the loaders raise unless the CPU is asked for."""
    from sdnq_tpu_torch.utils.transfer import device_put_packed
    save_quantized({"w": torch.ones(2)}, str(tmp_path))
    st = str(tmp_path / "model.safetensors")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: load_quantized(str(tmp_path)),
                 lambda: load_and_quantize_state_dict(st),
                 lambda: fast_load_safetensors(st),
                 lambda: device_put_packed({"w": torch.ones(2)})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
