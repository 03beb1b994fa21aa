"""The safetensors format, read and written without the ``safetensors``
package.

A file is an 8-byte little-endian header length, a JSON header that maps
each tensor's name to its ``dtype`` tag, ``shape`` and ``data_offsets`` (a
byte range of the data that follows the header) beside an optional
``__metadata__`` of strings, then the raw little-endian bytes.  The writer
pads the header with spaces so that the data starts on an 8-byte boundary
and lays the tensors out in the ``safetensors`` package's order (by
``_RANK`` of their tags, widest element first, then by name), so that each
one starts at a multiple of its element size and both writers lay out a
file alike.  bf16 and fp8 tags read as torch's own dtypes.

A checkpoint is one file, or a directory of shards listed by an index
(transformers' ``model.safetensors.index.json`` or diffusers'
``diffusion_pytorch_model.safetensors.index.json``, by its
``weight_map``), or, without an index, every ``*.safetensors`` file of the
directory.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Iterator

import torch

__all__ = ["DTYPES", "TAGS", "read_header", "save_file", "load_file",
           "iter_file", "checkpoint_files", "INDEX_NAMES"]

# transformers' and diffusers' names of a sharded checkpoint's index
INDEX_NAMES = ("model.safetensors.index.json",
               "diffusion_pytorch_model.safetensors.index.json")

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U64": torch.uint64,
    "U32": torch.uint32, "U16": torch.uint16, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
TAGS = {dt: tag for tag, dt in DTYPES.items()}
# the safetensors package's order of the tags, narrowest first
_RANK = {tag: i for i, tag in enumerate((
    "BOOL", "U8", "I8", "F8_E5M2", "F8_E4M3", "I16", "U16", "F16", "BF16",
    "I32", "U32", "F32", "F64", "I64", "U64"))}

# a header larger than this is refused, as by the safetensors package
_MAX_HEADER = 100_000_000


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, offset of the data) of the file at
    ``path``; raises ValueError where a tensor's tag, shape or byte range
    does not fit the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        n = struct.unpack("<Q", head)[0]
        if n > _MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header length {n} does not fit the "
                             f"file of {size} bytes")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data_start = 8 + n
    for name, info in header.items():
        tag = info["dtype"]
        if tag not in DTYPES:
            raise ValueError(f"{path}: {name} has unknown dtype {tag!r}")
        start, end = info["data_offsets"]
        nbytes = math.prod(info["shape"]) * DTYPES[tag].itemsize
        if end - start != nbytes or start < 0 or data_start + end > size:
            raise ValueError(f"{path}: {name} {tag}{info['shape']} does not "
                             f"fit bytes [{start}, {end}) of the data")
    return header, data_start


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes in C order, as a flat uint8 tensor on the CPU."""
    t = t.detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8)


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (on any device; strided views are written in C
    order) to ``path``."""
    for name, t in tensors.items():
        if t.dtype not in TAGS:
            raise ValueError(f"{name}: no safetensors tag for {t.dtype}")
    order = sorted(tensors,
                   key=lambda k: (-_RANK[TAGS[tensors[k].dtype]], k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            f.write(_bytes_of(tensors[name]).numpy().data)


def _read_into(f, data_start: int, info: dict) -> torch.Tensor:
    start, end = info["data_offsets"]
    buf = torch.empty(end - start, dtype=torch.uint8)
    f.seek(data_start + start)
    if end > start and f.readinto(buf.numpy().data) != end - start:
        raise ValueError(f"{f.name}: short read at {data_start + start}")
    return buf.view(DTYPES[info["dtype"]]).reshape(info["shape"])


def iter_file(path: str, device=None) -> Iterator[
        tuple[str, torch.Tensor]]:
    """(name, tensor) of each tensor of the file, by name, one read each;
    on ``device`` where given, else on the CPU."""
    header, data_start = read_header(path)
    with open(path, "rb") as f:
        for name in sorted(header):
            t = _read_into(f, data_start, header[name])
            yield name, (t if device is None else t.to(device))


def load_file(path: str) -> dict[str, torch.Tensor]:
    return dict(iter_file(path))


def checkpoint_files(path: str) -> list[str]:
    """The files of a checkpoint: ``path`` itself, the shards its index
    names, or every ``*.safetensors`` file of the directory."""
    if not os.path.isdir(path):
        return [path]
    for index in INDEX_NAMES:
        if os.path.exists(os.path.join(path, index)):
            with open(os.path.join(path, index)) as f:
                names = sorted(set(json.load(f)["weight_map"].values()))
            break
    else:
        names = sorted(n for n in os.listdir(path)
                       if n.endswith(".safetensors"))
    return [os.path.join(path, n) for n in names]
