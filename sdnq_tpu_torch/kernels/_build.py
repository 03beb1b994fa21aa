"""Builds the CUDA kernels under ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside
the package (a directory git ignores).  The hash covers the source and the
shared headers, so an edited source builds anew.  ``build()`` compiles
several sources at once, one ``nvcc`` process each.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "library", "build_dir", "command",
           "tma_rows"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_HEADERS = ("common.cuh", "hopper.cuh", "flash_attn.cuh")
SOURCES = ("quantize_rows", "scaled_mm", "dequant_gemv", "decode_weight",
           "wgmma_mm", "flash_attn", "flash_attn_e4m3", "flash_attn_d256",
           "blockdiag_mm", "blockdiag_i8_mm", "scaled_mm_tn")

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return _PKG / "_build"


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def command(src: Path, out: Path) -> list[str]:
    """The nvcc command line that compiles ``src`` into the library ``out``."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas=-v", "-o", str(out), str(src)]


def build(names=SOURCES) -> dict[str, float]:
    """Compile every listed source that has no up-to-date library, all at
    once.  Returns the seconds each build took (0.0 where none was
    needed); raises with the compiler's output if one fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        # the compiler writes to its own copy of the log's descriptor
        with open(build_dir() / f"{name}.log", "w") as log:
            proc = subprocess.Popen(command(_CSRC / f"{name}.cu", tmp),
                                    stdout=log, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        msgs = [f"--- {n} ---\n" + (build_dir() / f"{n}.log").read_text()
                for n in failed]
        raise RuntimeError("kernel build failed:\n" + "\n".join(msgs))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


_fns: dict[tuple[str, str], object] = {}

P, I = ctypes.c_void_p, ctypes.c_int  # argtypes: pointer / stream, int


def function(lib_name: str, symbol: str, argtypes: list):
    """A C entry point with its argtypes declared (pointers and the stream
    as c_void_p, so ctypes never cuts them to 32 bits)."""
    key = (lib_name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def ptr(t):
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def stream(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# activation / output type codes of csrc/common.cuh
def act_kind(dtype) -> int:
    import torch
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in kinds:
        raise ValueError(f"kernels take float32/bfloat16/float16, not {dtype}")
    return kinds[dtype]


def tma_rows(t, k: int | None = None):
    """``t`` if a TMA tensor map can read its first ``k`` entries along the
    last axis (all of them by default) in place: unit stride along that
    axis, every other stride a positive multiple of 16 bytes, the data on a
    16-byte boundary.  Else a copy, the last axis rounded up to 16 bytes with
    zeros.  The Hopper kernels' operands go through it (a misaligned or
    strided view is copied, never refused)."""
    k = t.shape[-1] if k is None else k
    per = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st % per == 0 for st in t.stride()[:-1])):
        return t
    out = t.new_zeros((*t.shape[:-1], -(-k // per) * per))
    out[..., :k] = t[..., :k]
    return out

