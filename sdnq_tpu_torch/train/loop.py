"""Training loop with periodic checkpoints, resume, and a non-finite-loss
guard.

The JAX package's ``train.loop.fit``: with a ``ckpt_dir`` it resumes from
the newest ``step_N`` there (``io.restore_checkpoint`` into the structure
of the state it is given), saves every ``save_every`` steps and keeps the
``keep`` newest.  The checkpoint holds the state; the random bits of the
steps come from the caller's generator, whose state the caller keeps.

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
import os
import shutil
import time
from typing import Any, Callable

import torch

from ..kernels.dispatch import resolve_device
from ..tree import tree_leaves
from .matmul import TrainQTensor

__all__ = ["fit", "latest_checkpoint_step"]

log = logging.getLogger("sdnq_tpu_torch")


def latest_checkpoint_step(ckpt_dir: str) -> int | None:
    """N of the newest ``step_N`` directory in ``ckpt_dir``, or None."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n[5:]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_") and n[5:].isdigit()]
    return max(steps) if steps else None


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(n[5:]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and n[5:].isdigit())
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def _drop_grads(params) -> None:
    for leaf in tree_leaves(params,
                            is_leaf=lambda x: isinstance(x, TrainQTensor)):
        holder = leaf.delta if isinstance(leaf, TrainQTensor) else leaf
        if isinstance(holder, torch.Tensor):
            holder.grad = None


def fit(step_fn: Callable, state: Any, num_steps: int, *,
        params: Any = None, generator: torch.Generator | None = None,
        device=None, ckpt_dir: str | None = None, save_every: int = 1000,
        keep: int = 3, on_metrics: Callable | None = None,
        max_bad_steps: int = 10) -> Any:
    """Run ``loss, apply = step_fn(state, generator)`` up to step
    ``num_steps``; ``apply()`` makes the update and returns the new state.
    With a ``ckpt_dir``, start from its newest ``step_N`` (the state
    restored into ``state``'s structure and devices, then steps N to
    ``num_steps``), and save ``step_{n}`` after every ``save_every``-th
    step, pruned to the ``keep`` newest.  A non-finite loss skips
    ``apply``, so the parameters stay as they were, clears the ``.grad`` of
    every leaf of ``params`` and of the state (``delta.grad`` of a
    TrainQTensor), and ``max_bad_steps`` of them in a row raise
    ``FloatingPointError``.  Without a ``generator`` the step's random bits
    (stochastic rounding) come from one seeded on ``device``, the card
    unless the CPU is asked for."""
    from ..io import restore_checkpoint, save_checkpoint

    start = 0
    if ckpt_dir:
        last = latest_checkpoint_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(
                os.path.join(ckpt_dir, f"step_{last}"), state)
            start = last
            log.info("resumed from step %d", last)
    if generator is None:
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(0)
    bad = 0
    for step in range(start, num_steps):
        t0 = time.perf_counter()
        loss, apply = step_fn(state, generator)
        loss_val = float(torch.as_tensor(loss).detach())
        if not math.isfinite(loss_val):
            bad += 1
            _drop_grads((params, state))
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
        if ckpt_dir and (step + 1) % save_every == 0:
            save_checkpoint(os.path.join(ckpt_dir, f"step_{step + 1}"), state)
            _prune(ckpt_dir, keep)
    return state
