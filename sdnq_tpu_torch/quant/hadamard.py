"""Hadamard rotation: Kronecker powers of the order-2 and symmetric order-4
seeds, normalised by 1/sqrt(n), applied group-wise as I ⊗ H.

H is symmetric and orthonormal, so rotating twice is the identity; the
weight is stored rotated and a matmul rotates its input instead.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "hadamard_matrix",
    "rotate_hadamard",
    "get_hadamard_group_size",
    "apply_hadamard",
    "next_power_of_2",
]

_N2 = np.array([[1, 1], [1, -1]], dtype=np.float64)
_N4 = np.array(
    [[1, 1, 1, -1], [1, 1, -1, 1], [1, -1, 1, 1], [-1, 1, 1, 1]],
    dtype=np.float64,
)


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def is_pow4(n: int) -> bool:
    return is_pow2(n) and (n.bit_length() & 1) == 1


def next_power_of_2(n: int) -> int:
    return n if is_pow2(n) else 1 << n.bit_length()


@lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    if not is_pow2(n):
        raise ValueError(f"Hadamard group size must be a power of 2, got {n}")
    if n == 1:
        h = np.ones((1, 1), dtype=np.float64)
    elif is_pow4(n):
        h = _N4
        while h.shape[0] < n:
            h = np.kron(h, _N4)
    else:
        h = _N2
        while h.shape[0] < n:
            h = np.kron(h, _N2)
    return (h / np.sqrt(n)).astype(np.float32)


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.from_numpy(_hadamard_np(n)).to(device=device, dtype=dtype)


def rotate_hadamard(x: torch.Tensor, group_size: int = 256) -> torch.Tensor:
    """Right-multiply the last axis by I ⊗ H, in x's dtype."""
    h = hadamard_matrix(group_size, dtype=x.dtype, device=x.device)
    c = x.shape[-1]
    grouped = x.reshape(*x.shape[:-1], c // group_size, group_size)
    return torch.matmul(grouped, h).reshape(x.shape)


def get_hadamard_group_size(channel_size: int, group_size: int):
    """Next power of two of min(channel, group), halved until it divides
    the channel; usable when >= 4."""
    group_size = next_power_of_2(min(channel_size, group_size))
    while channel_size % group_size != 0:
        group_size //= 2
    return group_size >= 4, group_size


def apply_hadamard(w: torch.Tensor, group_size: int = 256,
                   is_conv: bool = False):
    """Rotate a weight along its reduction axis (conv weights over the
    flattened (I, *k) axis).  Returns (rotated, used, group_size)."""
    channel = w.shape[1] if is_conv else w.shape[-1]
    use, group_size = get_hadamard_group_size(channel, group_size)
    if not use:
        return w, False, group_size
    if is_conv:
        shape = w.shape
        w = rotate_hadamard(w.reshape(shape[0], -1), group_size).reshape(shape)
    else:
        w = rotate_hadamard(w, group_size)
    return w, True, group_size
