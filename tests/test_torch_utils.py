"""The port's ``utils`` on the CPU: the quality metrics against the JAX
package's to 1e-6 relative, the roofline arithmetic against the JAX
function with the same chip figures, ``device_put_packed`` bit-equal for
every element width, ``detect_chip``'s refusal of an unknown card, and
``chip_smoke.py``'s bounds, whose peaks now come from ``CHIPS``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.utils import metrics as jm
from sdnq_tpu.utils import profiling as jp
from sdnq_tpu_torch import quantize_tensor
from sdnq_tpu_torch.tensor import QTensor
from sdnq_tpu_torch.utils import (
    CHIPS, Timer, detect_chip, matmul_roofline, report_fraction, roofline,
    trace,
)
from sdnq_tpu_torch.utils import metrics as tm
from sdnq_tpu_torch.utils.transfer import device_put_packed

ROOT = Path(__file__).resolve().parent.parent


def _images(seed=0, shape=(2, 20, 24, 3)):
    rng = np.random.default_rng(seed)
    b = rng.uniform(-1, 1, size=shape).astype(np.float32)
    a = (b + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("data_range", [None, 2.0])
def test_metrics_match_jax(data_range):
    a, b = _images()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [(tm.normalized_mse(ta, tb), jm.normalized_mse(ja, jb)),
             (tm.psnr(ta, tb, data_range), jm.psnr(ja, jb, data_range)),
             (tm.ssim(ta, tb, data_range), jm.ssim(ja, jb, data_range)),
             (tm.ssim(ta.bfloat16(), tb.bfloat16(), data_range, win=5),
              jm.ssim(ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16),
                      data_range, win=5))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for bits in (2, 4, 8):
        assert tm.dynamic_loss_threshold(bits) == \
            jm.dynamic_loss_threshold(bits)


def test_roofline_matches_jax_arithmetic():
    h = CHIPS["h100"]
    same = jp.ChipSpec(h.name, h.bf16_tflops, h.int8_tops, h.hbm_gbps)
    for flops, nbytes in ((2e12, 1e9), (1e9, 5e10), (0.0, 1e6)):
        for kind, int8 in (("bf16", False), ("int8", True)):
            got = roofline(flops, nbytes, kind=kind, chip=h)
            want = jp.roofline(flops, nbytes, int8=int8, chip=same)
            assert {k: v for k, v in got.items() if k != "chip"} == \
                {k: v for k, v in want.items() if k != "chip"}
            assert report_fraction(2 * got["t_sol_s"], got) == \
                jp.report_fraction(2 * want["t_sol_s"], want) == 0.5
    got = matmul_roofline(4096, 3072, 3072, kind="int8", chip=h)
    want = jp.matmul_roofline(4096, 3072, 3072, int8=True, chip=same)
    assert got["t_sol_s"] == want["t_sol_s"] and got["bound"] == "compute"


def test_chip_entries_and_detection():
    h = CHIPS["h100"]
    assert (h.bf16_tflops, h.int8_tops, h.fp8_tflops, h.hbm_gbps,
            h.fp32_tflops) == (989.0, 1979.0, 1979.0, 3350.0, 67.0)
    assert list(CHIPS) == ["h100"]      # no TPU figure in the port
    assert detect_chip("NVIDIA H100 80GB HBM3") is h
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite"):
        with pytest.raises(ValueError, match="no peak figures"):
            detect_chip(name)


def test_chip_smoke_bounds_unchanged():
    """The bounds ``chip_smoke.py`` writes into its kernels line, with the
    peaks it held as constants before they moved to ``CHIPS``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hbm = 3.35e12
    peak = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "fp32": 67e12}
    for kind, rate in peak.items():
        for nbytes, ops in ((3.2e8, 0.0), (1e8, 1e14), (5e9, 1e12)):
            t_b, t_o = nbytes / hbm, ops / rate
            want = (max(t_b, t_o) * 1e3,
                    "bytes" if t_b >= t_o else "operations")
            assert cs.bound_ms(nbytes, ops, kind) == want


def _storage(t):
    return t.untyped_storage().data_ptr()


def test_device_put_packed_round_trips_every_width():
    rng = np.random.default_rng(0)
    tree = {
        "u8": torch.from_numpy(rng.integers(0, 255, (9,)).astype(np.uint8)),
        "i8": torch.from_numpy(rng.integers(-99, 99, (3, 3)).astype(np.int8)),
        "bool": torch.from_numpy(rng.integers(0, 2, (5,)).astype(bool)),
        "e4m3": torch.randn(6).to(torch.float8_e4m3fn),
        "bf16": torch.randn(3, 5).bfloat16(),
        "f16": torch.randn(4).half(),
        "f32": torch.randn(17),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "f64": torch.randn(3, dtype=torch.float64),
        "i64": torch.arange(4),
        "scalar": torch.tensor(2.5),
        "strided": torch.randn(4, 6).t(),
        "blocks": [{"q": quantize_tensor(torch.randn(64, 128), "int4",
                                         group_size=32)},
                   {"q": quantize_tensor(torch.randn(64, 128), "uint8")}],
        "none": None, "step": 3,
    }
    out = device_put_packed(tree, "cpu")
    assert out["none"] is None and out["step"] == 3
    for k in ("u8", "i8", "bool", "e4m3", "bf16", "f16", "f32", "i32", "f64",
              "i64", "scalar", "strided"):
        assert out[k].dtype == tree[k].dtype and out[k].shape == tree[k].shape
        bits = (lambda t: t.view(torch.uint8)) if k == "e4m3" else (
            lambda t: t)
        assert torch.equal(bits(out[k]), bits(tree[k])), k
    for got, want in zip(out["blocks"], tree["blocks"]):
        assert isinstance(got["q"], QTensor)
        assert got["q"].meta == want["q"].meta
        for f in ("qdata", "scale", "zero_point"):
            a, b = getattr(got["q"], f), getattr(want["q"], f)
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    # one allocation per element width
    assert _storage(out["f32"]) == _storage(out["i32"]) \
        == _storage(out["blocks"][0]["q"].scale)
    assert _storage(out["u8"]) == _storage(out["e4m3"]) \
        == _storage(out["blocks"][1]["q"].qdata)
    assert _storage(out["bf16"]) == _storage(out["f16"])
    assert len({_storage(out[k]) for k in ("u8", "bf16", "f32", "f64")}) == 4


def test_timer_and_trace_run_on_the_cpu():
    calls = []
    secs, out = Timer(lambda x: calls.append(x) or x * 2)(3, steps=4)
    assert out == 6 and len(calls) == 5 and secs >= 0
    with trace() as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
