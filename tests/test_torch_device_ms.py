"""``chip_smoke.py``'s ``device_ms`` against traces that lose kernel events.

``device_ms`` reads a kernel's device time from torch.profiler's trace of
a few calls.  A trace that lost events would read low (below the bound),
so a reading counts only where the names of the kernels in the trace, in
the order they ran, repeat one call's sequence ``reps`` times.  These
tests give it a stand-in profiler whose traces drop events as scripted.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch.profiler
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
FAKE_TORCH = SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None))


def _event(name, us, start, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start,
                                                      elapsed_us=lambda: us))


class _Profiles:
    """A stand-in for ``torch.profiler.profile``: each call of ``fn`` under
    it launches a 10 us ``vt`` kernel and a 100 us ``tok`` kernel (and a
    host event); the n-th trace keeps the events ``drops[n]`` does not
    name, by their index in the trace (three a call, in launch order);
    they are listed in another order than they ran."""

    def __init__(self, drops):
        self.drops = drops
        self.n = 0
        self.live = None

    def fn(self):
        if self.live is not None:
            t = 200.0 * len(self.live)
            self.live += [_event("flash_attn_vt_kernel<128>", 10.0, t),
                          _event("flash_attn_tok_kernel<128>", 100.0, t + 20),
                          _event("cudaLaunchKernel", 1.0, t, DeviceType.CPU)]

    def __call__(self, activities=None):
        prof = self

        class _Ctx:
            def __enter__(self):
                prof.live = []
                return self

            def __exit__(self, *exc):
                drop = prof.drops.get(prof.n, ())
                self.kept = [e for i, e in enumerate(prof.live)
                             if i not in drop][::-1]
                prof.live = None
                prof.n += 1
                return False

            def events(self):
                return self.kept
        return _Ctx()


EVEN = (0, 4, 6, 10, 12)  # a count of 5 in 5 calls, one kernel a call


@pytest.mark.parametrize("drops, want", [
    ({}, 110.0),                                 # whole traces
    ({0: (3,)}, 110.0),                          # the first trace lost one
    ({0: (1,), 1: (4,)}, 110.0),                 # two lost one each
    ({0: (1,), 1: (4,), 2: (0,)}, None),         # every try lost one
    ({0: (0, 1), 1: (0, 1), 2: (0, 1)}, None),   # a whole call lost
    ({0: EVEN, 1: EVEN, 2: EVEN}, None),         # one kernel a call lost
], ids=["whole", "lost_once", "lost_twice", "lost_always", "lost_a_call",
        "lost_evenly"])
def test_device_ms_counts_only_whole_traces(monkeypatch, drops, want):
    prof = _Profiles(drops)
    monkeypatch.setattr(torch.profiler, "profile", prof)
    seen = set()
    got = CS.device_ms(FAKE_TORCH, prof.fn, ("flash_attn_vt",
                                             "flash_attn_tok"),
                       reps=5, seen=seen)
    if want is None:
        assert got is None and not seen
    else:
        assert got == pytest.approx(want / 1e3)
        assert seen == {"flash_attn_vt_kernel<128>",
                        "flash_attn_tok_kernel<128>"}


def test_device_ms_names_select_kernels(monkeypatch):
    prof = _Profiles({})
    monkeypatch.setattr(torch.profiler, "profile", prof)
    assert CS.device_ms(FAKE_TORCH, prof.fn, "flash_attn_tok",
                        reps=3) == pytest.approx(0.1)
    assert CS.device_ms(FAKE_TORCH, prof.fn, "", reps=3) == pytest.approx(
        0.11)
