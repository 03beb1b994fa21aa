"""ctypes wrapper for the native threaded safetensors reader.

Python parses and checks the header (``io._safetensors.read_header``) and
allocates the destination; the C++ library (``st_reader.cpp``,
built with ``g++`` at first use into ``_build/``, which git ignores) reads
the byte ranges with a pool of threads into one buffer that holds every
tensor.  Ranges above ``CHUNK`` bytes are split, so one large tensor is
read by several threads.  A failed build raises: there is no fallback
reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from ..io._safetensors import DTYPES, read_header
from ..kernels.dispatch import resolve_device

__all__ = ["fast_load_safetensors", "native_available"]

_SRC = Path(__file__).resolve().parent / "st_reader.cpp"
CHUNK = 16 << 20
_libs: dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "_build"


def _lib() -> ctypes.CDLL:
    """The reader library, built on first use; raises RuntimeError where
    ``g++`` fails."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    if digest in _libs:
        return _libs[digest]
    out = _build_dir() / f"libst_reader-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            r = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o",
                 str(tmp), str(_SRC)],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building {_SRC.name} failed: {e}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {_SRC.name} failed:\n{r.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.st_read_ranges.restype = ctypes.c_int
    lib.st_read_ranges.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, ctypes.c_int]
    _libs[digest] = lib
    return lib


def native_available() -> bool:
    """Whether the reader library builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def fast_load_safetensors(path: str, num_threads: int = 0,
                          keys: list[str] | None = None, device=None
                          ) -> dict[str, torch.Tensor]:
    """{key: CPU tensor} of the file at ``path`` (the ``keys`` given, or
    all), read by the native threads; bf16 and fp8 as torch's own dtypes.
    The tensors are staged for ``device`` (the card unless the CPU is asked
    for): pinned for the card, so that copies to it can be asynchronous."""
    pin = resolve_device(device).type == "cuda"
    lib = _lib()
    header, data_start = read_header(path)
    entries = [(k, info) for k, info in header.items()
               if keys is None or k in keys]
    # one allocation (one pinning) for all: each tensor at a 64-byte
    # aligned offset of it
    at, total = [], 0
    for _, info in entries:
        at.append(total)
        start, end = info["data_offsets"]
        total += -(-(end - start) // 64) * 64
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    out, ranges = {}, []
    for (k, info), o in zip(entries, at):
        start, end = info["data_offsets"]
        out[k] = buf[o:o + end - start].view(DTYPES[info["dtype"]]).reshape(
            info["shape"])
        for c in range(0, end - start, CHUNK):
            ranges.append((data_start + start + c,
                           min(CHUNK, end - start - c),
                           buf.data_ptr() + o + c))
    n = len(ranges)
    offsets = (ctypes.c_uint64 * n)(*(r[0] for r in ranges))
    sizes = (ctypes.c_uint64 * n)(*(r[1] for r in ranges))
    dsts = (ctypes.c_void_p * n)(*(r[2] for r in ranges))
    rc = lib.st_read_ranges(os.fsencode(path), offsets, sizes, dsts, n,
                            num_threads)
    if rc != 0:
        raise OSError(f"native safetensors read failed for {path}")
    return out
