"""Training loop with a non-finite-loss guard.

The JAX package's ``train.loop.fit``.  Its periodic checkpoints and resume
need ``io/checkpoint.py``, which the port does not have yet: a ``ckpt_dir``
raises ``NotImplementedError``.

The JAX step returns the new state and the guard drops it on a bad loss.
The port's optimizers update the parameters in place and read the
gradients from ``.grad``, so dropping a returned state would come too
late.  Here the step returns its loss and a callable that applies the
update; on a bad loss the guard skips that call and drops the step's
gradients, so that the next backward does not add to them.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable

import torch

from ..kernels.dispatch import resolve_device
from ..tree import tree_leaves
from .matmul import TrainQTensor

__all__ = ["fit"]

log = logging.getLogger("sdnq_tpu_torch")


def _drop_grads(params) -> None:
    for leaf in tree_leaves(params,
                            is_leaf=lambda x: isinstance(x, TrainQTensor)):
        holder = leaf.delta if isinstance(leaf, TrainQTensor) else leaf
        if isinstance(holder, torch.Tensor):
            holder.grad = None


def fit(step_fn: Callable, state: Any, num_steps: int, *,
        params: Any = None, generator: torch.Generator | None = None,
        device=None, ckpt_dir: str | None = None,
        on_metrics: Callable | None = None, max_bad_steps: int = 10) -> Any:
    """Run ``loss, apply = step_fn(state, generator)`` for ``num_steps``;
    ``apply()`` makes the update and returns the new state.  A non-finite
    loss skips ``apply``, so the parameters stay as they were, clears the
    ``.grad`` of every leaf of ``params`` (``delta.grad`` of a
    TrainQTensor), and ``max_bad_steps`` of them in a row raise
    ``FloatingPointError``.  Without a ``generator`` the step's random bits
    (stochastic rounding) come from one seeded on ``device``, the card
    unless the CPU is asked for."""
    if ckpt_dir:
        raise NotImplementedError(
            "fit's checkpoints need io/checkpoint.py, not ported yet "
            "(ROADMAP queue A)")
    if generator is None:
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(0)
    bad = 0
    for step in range(num_steps):
        t0 = time.perf_counter()
        loss, apply = step_fn(state, generator)
        loss_val = float(torch.as_tensor(loss).detach())
        if not math.isfinite(loss_val):
            bad += 1
            _drop_grads(params)
            log.warning("non-finite loss at step %d (%d consecutive); "
                        "update skipped", step, bad)
            if bad >= max_bad_steps:
                raise FloatingPointError(
                    f"{bad} consecutive non-finite losses at step {step}")
            continue
        bad = 0
        state = apply()
        if on_metrics is not None:
            on_metrics(step=step, loss=loss_val,
                       step_time=time.perf_counter() - t0)
    return state
