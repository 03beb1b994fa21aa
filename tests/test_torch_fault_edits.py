"""The planted faults of ``chip_smoke.py`` against the sources they edit.

Phase 7 of ``chip_smoke.py`` builds a broken copy of a kernel source for
each entry of ``FAULTS`` and needs every one of its edits to apply; an edit
whose text a later change of the source removed would stop the script on
the card.  These tests apply each fault's edits to the sources here, as the
fault builder does (a later edit sees the earlier ones), and so find such a
fault on the CPU.  ``WGMMA_WATCHDOG`` (the barrier watchdog every fault
build of the watched sources gets) is held to the same.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from sdnq_tpu_torch.kernels._build import _HEADERS as HEADERS

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "sdnq_tpu_torch" / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _apply(src: str, edits) -> dict[str, str]:
    """The fault build's files after ``edits``; fails on an edit whose text
    is not in the file it names, or that changes nothing."""
    files = {f: (CSRC / f).read_text() for f in (f"{src}.cu", *HEADERS)}
    for edit in edits:
        name, old, new = edit if len(edit) == 3 else (f"{src}.cu", *edit)
        assert name in files, f"{name} is not a file of {src}'s build"
        assert old in files[name], f"{old!r} not in {name}"
        assert new != old
        files[name] = files[name].replace(old, new)
    return files


@pytest.mark.parametrize("fault", CS.FAULTS, ids=[f[0] for f in CS.FAULTS])
def test_fault_edits_apply(fault):
    tag, src, kernel, label, edits = fault
    assert (CSRC / f"{src}.cu").is_file(), f"{tag}: no csrc/{src}.cu"
    assert edits, tag
    files = _apply(src, CS.build_edits(src, edits))
    assert files[f"{src}.cu"] != (CSRC / f"{src}.cu").read_text() or any(
        files[h] != (CSRC / h).read_text() for h in HEADERS)


@pytest.mark.parametrize("src", CS.WATCHED)
def test_watchdog_edits_apply(src):
    files = _apply(src, CS.WGMMA_WATCHDOG)
    assert "g_watchdog = 1;" in files["hopper.cuh"]
    # the source includes hopper.cuh, itself or through its kernel file
    text = files[f"{src}.cu"]
    home = CS.KERNEL_FILES.get(src)
    if home:
        assert f'#include "{home}"' in text
        text = files[home]
    assert '#include "hopper.cuh"' in text


def test_fault_tags_unique_and_counted():
    tags = [f[0] for f in CS.FAULTS] + [f[0] for f in CS.PY_FAULTS]
    assert len(tags) == len(set(tags))
    assert len(tags) >= 40
    slices = set(CS.SLICE_TOL) | set(CS.LLM_SLICE_TOL) | {
        "qlinear_b8", "train", "ring", "pipeline", "unet", "moe",
        "sd15_fp16", "tp", "muon", "tp_layers"}
    assert {f[3] for f in CS.FAULTS} <= slices
    assert {f[4] for f in CS.PY_FAULTS} <= slices


@pytest.mark.parametrize("fault", CS.PY_FAULTS,
                         ids=[f[0] for f in CS.PY_FAULTS])
def test_py_fault_edits_apply(fault):
    """A fault of a Python wrapper: its edits find their text in the
    module, change it, and the broken text still compiles."""
    tag, rel, sources, kernel, label, edits = fault
    path = ROOT / "sdnq_tpu_torch" / rel
    assert path.is_file(), f"{tag}: no sdnq_tpu_torch/{rel}"
    assert all((CSRC / f"{src}.cu").is_file() for src in sources)
    broken = CS.py_fault_text(rel, edits)
    assert broken != path.read_text()
    compile(broken, str(path), "exec")
