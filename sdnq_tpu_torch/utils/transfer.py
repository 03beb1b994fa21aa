"""Batched host-to-device transfer of a parameter tree.

The JAX package's ``utils.transfer``: the tree's tensors (QTensors'
arrays included) are grouped by element width, each group is packed into
one host buffer of that width (pinned for the card), each buffer crosses
in one non-blocking copy, and every leaf comes back as a same-width
``view(dtype)`` and reshape of its slice of the device buffer.  A handful
of large copies in place of one per leaf.  The leaves of one width share
one allocation, which is freed when the last of them is.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dispatch import resolve_device
from ..tensor import QTensor

__all__ = ["device_put_packed"]

_CARRIER = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_QT_FIELDS = ("qdata", "scale", "zero_point", "svd_up", "svd_down")


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn) for v in tree)
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{
            f: None if getattr(tree, f) is None else fn(getattr(tree, f))
            for f in _QT_FIELDS})
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def device_put_packed(tree, device=None):
    """``tree`` with every tensor on ``device`` (the card unless the CPU is
    asked for), moved in one copy per element width (at most four)."""
    device = resolve_device(device)
    leaves: list[torch.Tensor] = []
    _walk(tree, leaves.append)
    groups: dict[int, list[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.element_size(), []).append(i)

    pin = device.type == "cuda"
    slots: dict[int, tuple[int, int]] = {}
    on_device = {}
    for size, idxs in groups.items():
        carrier = _CARRIER[size]
        total = sum(leaves[i].numel() for i in idxs)
        host = torch.empty(total, dtype=carrier, pin_memory=pin)
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            host[off:off + n].copy_(
                leaves[i].detach().reshape(-1).view(carrier))
            slots[i] = (size, off)
            off += n
        on_device[size] = host.to(device, non_blocking=True)

    it = iter(range(len(leaves)))

    def place(t):
        size, off = slots[next(it)]
        chunk = on_device[size][off:off + t.numel()]
        return chunk.view(t.dtype).reshape(t.shape)

    return _walk(tree, place)
