"""Continuous batching on the CPU: ``ContinuousBatcher`` against the JAX
package's on the same request queue (admission order, the per-slot step
indices each step sees, the finish order, ``efficiency`` and ``busy``),
and a FLUX_TINY batched run whose every request equals the same request
run alone through ``flux_denoise`` at batch 1.

Tolerances: the scheduler's decisions and counts are compared exactly.
A request's latent from the batched run and from its solo run go through
the same operations on rows that do not mix, but at another batch size,
so the CPU's fp32 matmuls may block their sums differently: 1e-5 of max
|latent| (measured 0 on this CPU: the rows are summed alike)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdnq_tpu.pipeline import batching as jb
from sdnq_tpu_torch.models import FLUX_TINY_CONFIG, init_dit
from sdnq_tpu_torch.models.dit import dit_forward, make_rope_freqs
from sdnq_tpu_torch.pipeline import (
    ContinuousBatcher, FlowMatchScheduler, Request, flux_denoise,
)

# (steps, seed) of each request, submitted in this order
QUEUE = ((3, 0), (1, 1), (4, 2), (2, 3), (2, 4), (3, 5), (1, 6))


def _drive(mod, num_slots, array):
    """Run ``mod``'s batcher over QUEUE with a step that adds 1 to each
    active slot; returns (finish order, each step's t_idx and active
    flags, final latents, efficiency, iterations)."""
    seen = []

    def step(lat, cond, t_idx, active):
        seen.append((np.asarray(t_idx).tolist(), np.asarray(active).tolist()))
        add = array(np.asarray(active).astype(np.float32))[:, None]
        return lat + add * cond["w"]

    def init(req):
        return array(np.full((3,), float(req.rng_seed), np.float32))

    b = mod.ContinuousBatcher(step, init, num_slots, 4)
    assert not b.busy
    for i, (n, seed) in enumerate(QUEUE):
        b.submit(mod.Request(i, {"w": array(np.full((3,), 0.5, np.float32))},
                             n, rng_seed=seed))
    assert b.busy
    done = b.run()
    assert not b.busy
    return ([r.request_id for r in done], seen,
            {r.request_id: np.asarray(r.result) for r in done},
            b.efficiency, len(seen))


@pytest.mark.parametrize("num_slots", [1, 3, 4])
def test_scheduling_matches_jax(num_slots):
    jorder, jseen, jres, jeff, jit = _drive(jb, num_slots, jnp.asarray)
    torder, tseen, tres, teff, tit = _drive(
        __import__("sdnq_tpu_torch.pipeline.batching",
                   fromlist=["x"]), num_slots, torch.from_numpy)
    assert torder == jorder
    assert tseen == jseen            # the admission order, step by step
    assert tit == jit
    assert teff == jeff
    for rid in jorder:
        assert isinstance(tres[rid], np.ndarray)
        np.testing.assert_array_equal(tres[rid], jres[rid])
    # each request's latent took exactly its own steps
    for rid, (n, seed) in enumerate(QUEUE):
        np.testing.assert_array_equal(tres[rid], np.full(3, seed + 0.5 * n,
                                                         np.float32))


def test_efficiency_counts_idle_slots():
    b = ContinuousBatcher(lambda lat, c, t, a: lat, lambda r: torch.zeros(2),
                          4, 8)
    assert b.efficiency == 0.0
    b.submit(Request(0, {"w": torch.zeros(1)}, 3))
    b.run()
    # one request over 4 slots for 3 steps
    assert b.total_slot_steps == 12 and b.active_slot_steps == 3
    assert b.efficiency == 0.25


def test_mesh_raises():
    """The slot axis must divide over the mesh's data axis (the JAX
    package's ValueError)."""
    from sdnq_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="must divide over data=2"):
        ContinuousBatcher(lambda *a: a[0], lambda r: torch.zeros(1), 3, 4,
                          mesh=Mesh({"data": 2, "fsdp": 1, "tensor": 1,
                                     "sequence": 1}, "cpu"))


def _flux_step(params, cfg, freqs):
    """Euler flow-matching step of every slot at its own timestep: slot s
    is at step t_idx[s] of its request's schedule cond["ts"][s] (zeros
    past its last step), so t and the next t are gathered per slot."""
    def step(lat, cond, t_idx, active):
        rows = torch.arange(lat.shape[0])
        # an idle slot may stand past its schedule: any in-range index
        i = t_idx.long().clamp(max=cond["ts"].shape[1] - 2)
        t, t_prev = cond["ts"][rows, i], cond["ts"][rows, i + 1]
        g = torch.full((lat.shape[0],), 3.5)
        v = dit_forward(params, lat, cond["txt"], t, cond["pooled"], cfg,
                        guidance=g, freqs=freqs, device="cpu")
        new = lat + (t_prev - t)[:, None, None] * v.float()
        return torch.where(active[:, None, None], new, lat)
    return step


def test_flux_batched_equals_each_request_alone():
    cfg = FLUX_TINY_CONFIG
    params = init_dit(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    side, txt_len, steps_max = 64, 8, 4
    lh = lw = side // 16
    freqs = make_rope_freqs(cfg, txt_len, (lh, lw), device="cpu")
    sched = FlowMatchScheduler(shift=3.0)
    reqs = []
    for i, (n, seed) in enumerate(((2, 10), (3, 11), (1, 12), (4, 13),
                                   (2, 14))):
        g = torch.Generator().manual_seed(seed)
        ts = torch.zeros(steps_max + 1)
        ts[:n] = sched.timesteps(n)
        cond = {"txt": torch.randn(txt_len, cfg.txt_dim, generator=g),
                "pooled": torch.randn(cfg.vec_dim, generator=g), "ts": ts}
        reqs.append(Request(i, cond, n, rng_seed=seed))

    def init(req):
        g = torch.Generator().manual_seed(100 + req.rng_seed)
        return torch.randn(lh * lw, cfg.in_channels, generator=g)

    b = ContinuousBatcher(_flux_step(params, cfg, freqs), init, 3, steps_max)
    for r in reqs:
        b.submit(r)
    done = b.run()
    assert sorted(r.request_id for r in done) == list(range(len(reqs)))
    assert 0 < b.efficiency < 1
    for r in done:
        solo = flux_denoise(params, r.cond["txt"][None],
                            r.cond["pooled"][None], cfg, steps=r.num_steps,
                            height=side, width=side, latents=init(r)[None],
                            device="cpu")
        ref = solo[0].numpy()
        err = np.abs(r.result - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, (r.request_id, err)
