"""Where a computation runs.

Every kernel wrapper in this package looks at the device of the tensors it
is given: on a CUDA tensor it launches its hand-written Hopper kernel (or
raises, when the kernel does not take the case), on a CPU tensor it runs
the kernel's plain PyTorch version.  Nothing falls back from one to the
other.

Entry points (``init_dit``, ``quantize_model``, ``dit_forward``,
``flux_denoise``) run on the card unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_device", "is_cuda", "route_fp8_to_int8"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CPU run must be asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_device(t: torch.Tensor, device: torch.device, what: str) -> None:
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what} is on {t.device}, expected {device}")


def is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def route_fp8_to_int8() -> bool:
    """The H100 has fp8 tensor cores, so fp8 matmuls are never rerouted to
    int8 execution (the JAX package does so on TPUs without an fp8 unit)."""
    return False
