"""Continuous batching for diffusion denoise loops.

The JAX package's ``pipeline/batching.py`` in torch: the device always runs
a full batch of ``num_slots`` model steps, but each slot carries its own
latent, conditioning and timestep index.  When a slot's trajectory ends,
its latent is read back as the request's result and the next queued
request is admitted into the slot mid-flight, with no drain of the other
slots.  Admission is a deterministic function of the queue (free slots in
order, requests in submission order), and ``efficiency`` reports useful
slot-steps over all slot-steps.

The latents and the conditioning live on the device of the first latent
as slot-stacked tensors (a slot is written in place on admission); the
per-slot step indices and the active flags reach ``step_fn`` as tensors on
that device.

With a ``mesh`` the slot axis is sharded over its ``data_axis`` (whose
size must divide ``num_slots``, as in the JAX package): every rank runs
the same host scheduler, holds and steps only its own slots (``step_fn``
gets the rank's (S / n, ...) slice), and a finished slot's latent is
broadcast from its owner, so every rank reads the same results (JAX's
``_fetch_slot`` all-gather).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_map

__all__ = ["Request", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    request_id: int
    cond: Any                 # conditioning tree (text embeddings, ...)
    num_steps: int
    rng_seed: int = 0
    result: Any = None


class ContinuousBatcher:
    """Host-side slot scheduler around a per-step function.

    step_fn(latents, cond, t_idx, active) -> new_latents
      latents: (S, ...) slot-stacked; cond: a slot-stacked tree; t_idx:
      (S,) int32 per-slot step index; active: (S,) bool.
    The function must treat inactive slots as no-ops (mask or harmless
    compute: the batcher ignores their outputs).  ``init_latent_fn(req)``
    gives a request's first latent (without the slot axis)."""

    def __init__(self, step_fn: Callable, init_latent_fn: Callable,
                 num_slots: int, num_steps_max: int, *,
                 mesh=None, data_axis: str = "data"):
        self.step_fn = step_fn
        self.init_latent_fn = init_latent_fn
        self.num_slots = num_slots
        self.num_steps_max = num_steps_max
        self.mesh = mesh
        self.data_axis = data_axis
        self._comm = None
        self._lo, self._hi = 0, num_slots   # this rank's slots
        if mesh is not None:
            n = mesh.shape[data_axis]
            if num_slots % n != 0:
                raise ValueError(f"num_slots={num_slots} must divide over "
                                 f"{data_axis}={n}")
            self._comm = mesh.comm(data_axis)
            per = num_slots // n
            self._lo = mesh.get_local_rank(data_axis) * per
            self._hi = self._lo + per
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * num_slots
        self.latents = None
        self.cond = None
        self.t_idx = np.zeros((num_slots,), np.int32)
        self.steps_left = np.zeros((num_slots,), np.int32)
        self.completed: list[Request] = []
        self.total_slot_steps = 0
        self.active_slot_steps = 0

    @property
    def efficiency(self) -> float:
        """Useful slot-steps / total slot-steps over the run so far."""
        return (self.active_slot_steps / self.total_slot_steps
                if self.total_slot_steps else 0.0)

    def _alloc(self, lat, cond):
        n = self._hi - self._lo
        z = torch.zeros((n,) + tuple(lat.shape), dtype=lat.dtype,
                        device=lat.device)
        zc = tree_map(lambda c: torch.zeros(
            (n,) + tuple(c.shape), dtype=c.dtype, device=c.device), cond)
        return z, zc

    def _owns(self, s: int) -> bool:
        return self._lo <= s < self._hi

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        changed = False
        for s in range(self.num_slots):
            if self.slots[s] is None and self.queue:
                req = self.queue.popleft()
                self.slots[s] = req
                if self._owns(s) or self.latents is None:
                    lat = self.init_latent_fn(req)
                    if self.latents is None:
                        self.latents, self.cond = self._alloc(lat, req.cond)
                if self._owns(s):
                    i = s - self._lo
                    self.latents[i] = lat
                    tree_map(lambda full, c: full[i].copy_(c), self.cond,
                             req.cond)
                self.t_idx[s] = 0
                self.steps_left[s] = req.num_steps
                changed = True
        return changed

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def _fetch_slot(self, s: int) -> np.ndarray:
        """One slot's latent read back to the host as a numpy array (a
        bf16 latent as float32, which holds it exactly: numpy has no
        bf16).  On a mesh the owner broadcasts it over the data axis, and
        every rank reads it."""
        if self._comm is None:
            lat = self.latents[s].detach()
        else:
            per = self._hi - self._lo
            buf = (self.latents[s - self._lo] if self._owns(s)
                   else torch.empty_like(self.latents[0])).detach()
            lat = self._comm.broadcast(buf.contiguous(), s // per)
        if lat.dtype == torch.bfloat16:
            lat = lat.float()
        return lat.to("cpu", copy=True).numpy()

    def run(self, max_iterations: int = 100000):
        """Drain the queue; returns completed requests in finish order."""
        it = 0
        while self.busy and it < max_iterations:
            it += 1
            self._admit()
            active = np.array([s is not None for s in self.slots])
            if not active.any():
                break
            dev = self.latents.device
            lo, hi = self._lo, self._hi
            self.latents = self.step_fn(
                self.latents, self.cond,
                torch.tensor(self.t_idx[lo:hi], device=dev),
                torch.tensor(active[lo:hi], device=dev))
            self.t_idx += active.astype(np.int32)
            self.steps_left -= active.astype(np.int32)
            self.total_slot_steps += self.num_slots
            self.active_slot_steps += int(active.sum())
            for s in range(self.num_slots):
                if self.slots[s] is not None and self.steps_left[s] <= 0:
                    req = self.slots[s]
                    req.result = self._fetch_slot(s)
                    self.completed.append(req)
                    self.slots[s] = None
        return self.completed
