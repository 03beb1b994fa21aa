"""Profiling and roofline accounting on the card.

``trace`` records a ``torch.profiler`` trace of a block; ``Timer`` times a
call between device synchronisations; ``roofline`` gives the least time a
piece of work could take on a card, the larger of its operations over the
card's peak rate for their type and its bytes over the memory rate, so
that a kernel's time can be stated as a share of it.  ``CHIPS`` holds the
published dense peaks of the cards the port runs on; ``detect_chip``
raises for a card it has no entry for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["trace", "Timer", "ChipSpec", "CHIPS", "roofline",
           "matmul_roofline", "detect_chip", "report_fraction"]


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block on the CPU and, where there is one, the
    card; yields the profiler (``key_averages()``), and writes a Chrome
    trace to ``log_dir``/trace.json where a directory is given."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Mean host time per call of ``fn`` over ``steps`` calls after
    ``warmup``, between synchronisations of the card."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, steps: int = 20, warmup: int = 1):
        out = None
        for _ in range(warmup):
            out = self.fn(*args)
        _sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = self.fn(*args)
        _sync()
        return (time.perf_counter() - t0) / steps, out


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Dense peak rates: operations/s in 1e12 by operand type, memory
    bytes/s in 1e9."""
    name: str
    bf16_tflops: float
    int8_tops: float
    hbm_gbps: float
    fp8_tflops: float
    fp32_tflops: float

    def peak(self, kind: str) -> float:
        """Operations per second for operands of ``kind`` (bf16, int8,
        fp8, fp32)."""
        return {"bf16": self.bf16_tflops, "int8": self.int8_tops,
                "fp8": self.fp8_tflops, "fp32": self.fp32_tflops}[kind] * 1e12


# NVIDIA's H100 data sheet, SXM part, dense rates without sparsity, at the
# full 700 W power limit
CHIPS = {
    "h100": ChipSpec("NVIDIA H100 SXM", bf16_tflops=989.0, int8_tops=1979.0,
                     hbm_gbps=3350.0, fp8_tflops=1979.0, fp32_tflops=67.0),
}
# device names (torch.cuda.get_device_name) of each entry's part
_DEVICE_NAMES = {"h100": ("H100 80GB HBM3", "H100 SXM")}


def detect_chip(name: str | None = None) -> ChipSpec:
    """The entry of the card named ``name`` (by default the current card's
    name); raises ValueError for a card with no entry."""
    if name is None:
        name = torch.cuda.get_device_name()
    for key, names in _DEVICE_NAMES.items():
        if any(n.lower() in name.lower() for n in names):
            return CHIPS[key]
    raise ValueError(f"no peak figures for the device {name!r}; known: "
                     + ", ".join(c.name for c in CHIPS.values()))


def roofline(flops: float, bytes_moved: float, *, kind: str = "bf16",
             chip: ChipSpec | None = None) -> dict:
    """The least time ``flops`` operations on ``kind`` operands and
    ``bytes_moved`` bytes could take: the larger of the two bounds."""
    chip = chip or detect_chip()
    t_compute = flops / chip.peak(kind)
    t_memory = bytes_moved / (chip.hbm_gbps * 1e9)
    t_sol = max(t_compute, t_memory)
    return {"chip": chip.name, "t_compute_s": t_compute,
            "t_memory_s": t_memory, "t_sol_s": t_sol,
            "bound": "compute" if t_compute >= t_memory else "memory"}


def matmul_roofline(m: int, n: int, k: int, *, a_bytes=1, b_bytes=1,
                    out_bytes=2, kind: str = "int8", chip=None) -> dict:
    """``roofline`` of an (m, k) x (k, n) product: each operand read once,
    the output written once."""
    flops = 2.0 * m * n * k
    bytes_moved = m * k * a_bytes + n * k * b_bytes + m * n * out_bytes
    return roofline(flops, bytes_moved, kind=kind, chip=chip)


def report_fraction(measured_s: float, sol: dict) -> float:
    """Share of the roofline time reached (1.0 = at the roofline)."""
    return sol["t_sol_s"] / max(measured_s, 1e-12)
