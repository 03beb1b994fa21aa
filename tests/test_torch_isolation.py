"""The port stands alone: it imports neither JAX nor the JAX package (nor
``safetensors``, ``transformers`` or ``orbax``, which the card's machine
does not have), and its entry points do not quietly run on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sdnq_tpu_torch as T
from sdnq_tpu_torch.convert import params_from_numpy
from sdnq_tpu_torch.models import FLUX_TINY_CONFIG, dit_forward, init_dit
from sdnq_tpu_torch.pipeline import flux_denoise

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sdnq_tpu_torch"


def test_fresh_import_leaves_jax_out():
    code = ("import sys, sdnq_tpu_torch, sdnq_tpu_torch.kernels, "
            "sdnq_tpu_torch.models, sdnq_tpu_torch.pipeline, "
            "sdnq_tpu_torch.convert, sdnq_tpu_torch.packing, "
            "sdnq_tpu_torch.quant.svd, sdnq_tpu_torch.train, "
            "sdnq_tpu_torch.optim, sdnq_tpu_torch.io, "
            "sdnq_tpu_torch.native, sdnq_tpu_torch.utils, "
            "sdnq_tpu_torch.parallel, sdnq_tpu_torch.parallel.tp, "
            "sdnq_tpu_torch.parallel.sharding, "
            "sdnq_tpu_torch.parallel.dryrun, sdnq_tpu_torch.optim.muon, "
            "sdnq_tpu_torch.models.moe\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'sdnq_tpu.', 'safetensors', "
            "'transformers', 'orbax')) "
            "or m == 'sdnq_tpu']\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert {PKG / "packing.py", PKG / "quant" / "svd.py",
            PKG / "train" / "matmul.py", PKG / "optim" / "base.py",
            PKG / "io" / "hf.py", PKG / "io" / "checkpoint.py",
            PKG / "native" / "loader.py",
            PKG / "utils" / "transfer.py", PKG / "optim" / "muon.py",
            PKG / "parallel" / "sharding.py", PKG / "parallel" / "tp.py",
            PKG / "parallel" / "dryrun.py"} <= set(files)
    for f in files:
        for mod in _imported_roots(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "sdnq_tpu", "flax",
                                "safetensors", "transformers", "orbax"), (
                f, mod)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_device(no_cuda):
    cfg = FLUX_TINY_CONFIG
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_dit(cfg)
    params = init_dit(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.quantize_model(params, T.QuantConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": [1.0]})
    x = torch.zeros(1, 64, cfg.in_channels)
    txt = torch.zeros(1, 8, cfg.txt_dim)
    t = torch.zeros(1)
    pooled = torch.zeros(1, cfg.vec_dim)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dit_forward(params, x, txt, t, pooled, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flux_denoise(params, txt, pooled, cfg, steps=1, height=128,
                     width=128)
    out = dit_forward(params, x, txt, t, pooled, cfg, device="cpu")
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_init_is_seeded_and_sized():
    cfg = FLUX_TINY_CONFIG
    a = init_dit(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = init_dit(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(a["transformer_blocks"][1]["img_attn"]["qkv"]["weight"],
                       b["transformer_blocks"][1]["img_attn"]["qkv"]["weight"])
    n = sum(t.numel() for t in _tensors(a))
    # same parameter count as the JAX package's init at this config
    d, m = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
    per_double = 2 * (6 * d * d + 6 * d) + 2 * (3 * d * d + 3 * d + d * d + d
                                                + 2 * cfg.head_dim) \
        + 2 * (2 * d * m + m + d)
    per_single = 3 * d * d + 3 * d + d * (3 * d + m) + 3 * d + m \
        + (d + m) * d + d + 2 * cfg.head_dim
    assert n == (cfg.in_channels * d + d + cfg.txt_dim * d + d
                 + 2 * (256 * d + d + d * d + d)
                 + cfg.vec_dim * d + d + d * d + d + d * 2 * d + 2 * d
                 + d * cfg.in_channels + cfg.in_channels
                 + cfg.depth_double * per_double
                 + cfg.depth_single * per_single)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree



def test_llm_entry_points_need_a_device(no_cuda):
    from sdnq_tpu_torch.models import (
        LLM_TINY_CONFIG, generate, init_cache, init_llm, llm_forward,
    )
    cfg = LLM_TINY_CONFIG
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_llm(cfg)
    params = init_llm(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    ids = torch.zeros(1, 8, dtype=torch.long)
    for call in (lambda: llm_forward(params, ids, cfg),
                 lambda: generate(params, ids, cfg, max_new_tokens=2),
                 lambda: init_cache(cfg, 1, 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    toks = generate(params, ids, cfg, max_new_tokens=2, device="cpu")
    assert toks.shape == (1, 2)


def test_parallel_entry_points_need_a_device(no_cuda):
    """The tensor-parallel forward over virtual ranks, the training dry
    run and its launcher take the card unless the caller asks for the
    CPU."""
    from sdnq_tpu_torch.parallel import dryrun_multichip, local_tp
    from sdnq_tpu_torch.parallel.dryrun import launch
    cfg = FLUX_TINY_CONFIG
    params = init_dit(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, 64, cfg.in_channels)
    txt = torch.zeros(1, 8, cfg.txt_dim)
    t = torch.zeros(1)
    pooled = torch.zeros(1, cfg.vec_dim)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        local_tp(params, x, txt, t, pooled, cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(1)
    with torch.no_grad():
        out = local_tp(params, x, txt, t, pooled, cfg, 2, device="cpu")
    assert out.shape == x.shape and torch.isfinite(out).all()

