"""Gradient checkpointing for quantized training.

The JAX package's ``train.remat``: ``checkpoint_block`` recomputes a
block's activations in the backward (``torch.utils.checkpoint``,
non-reentrant) instead of keeping them; ``dots_saveable_policy`` keeps the
results of PyTorch's matrix products and recomputes the rest.  The other
way to save memory, ``train_qlinear(..., save_quantized_activations=True)``,
keeps int8 inputs instead of bf16 ones.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

__all__ = ["checkpoint_block", "dots_saveable_policy"]


def checkpoint_block(fn, policy=None):
    """``fn(*args)`` whose activations are recomputed in the backward;
    ``policy`` is a ``context_fn`` such as ``dots_saveable_policy()``."""
    extra = {} if policy is None else {"context_fn": policy}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **extra,
                                **kwargs)
    return wrapped


_DOTS = ("mm", "bmm", "addmm", "baddbmm", "matmul", "linear", "_int_mm")


def dots_saveable_policy():
    """Selective checkpointing that saves matrix products' outputs."""
    aten = torch.ops.aten
    ops = {getattr(aten, n).default for n in _DOTS if hasattr(aten, n)}

    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                             policy)
