"""The collectives of the parallel layer, on a mesh axis's process group:
the counterparts of JAX's ``ppermute`` (a ring shift), ``all_to_all``,
the gather of a sequence-sharded output, and point-to-point hops (each
called only where the axis has more than one rank); and ``AxisComm``, the
collectives that tensor, expert and data parallelism issue, on a process
group or among the virtual ranks (threads) of one process."""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist


def _peer(mesh, axis: str, step: int) -> int:
    """Global rank of the rank ``step`` places along ``axis``."""
    p = mesh.shape[axis]
    return dist.get_global_rank(
        mesh.get_group(axis), (mesh.get_local_rank(axis) + step) % p)


def exchange(mesh, axis: str, send=None, recv=None):
    """Send the contiguous tensors ``send`` to the next rank along ``axis``
    while receiving into ``recv`` (contiguous tensors of the shapes and
    dtypes to receive) from the previous one; either may be None.  Returns
    ``recv``."""
    group = mesh.get_group(axis)
    ops = []
    if send is not None:
        ops += [dist.P2POp(dist.isend, t, _peer(mesh, axis, 1), group)
                for t in send]
    if recv is not None:
        ops += [dist.P2POp(dist.irecv, t, _peer(mesh, axis, -1), group)
                for t in recv]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def ring_shift(tensors, mesh, axis: str):
    """JAX's ``ppermute`` over pairs (i, i + 1): every rank sends its
    tensors to the next rank along ``axis`` and receives the previous
    rank's."""
    tensors = [t.contiguous() for t in tensors]
    return exchange(mesh, axis, send=tensors,
                    recv=[torch.empty_like(t) for t in tensors])


def gather_sequence(x, mesh, axis: str, dim: int = 2):
    """The ranks' shards along ``dim`` (in rank order along ``axis``),
    concatenated: the global tensor on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def all_to_all(x, mesh, axis: str):
    """``x`` (P, ...): block j goes to rank j along ``axis``; block j of
    the result came from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.get_group(axis))
    return out


# ---------------------------------------------------------------------------
# One mesh axis's collectives for tensor, expert and data parallelism
# ---------------------------------------------------------------------------
#
# ``AxisComm`` is the interface the sharded model functions call: Megatron's
# f (``copy``: identity forward, gradient summed over the axis) and g
# (``sum``: summed forward, identity backward), the gather of a sharded
# output (backward: this rank's slice of the gradient), the maximum of a
# row statistic, a broadcast and a data-parallel mean.  A sum over ranks
# is an all-gather and an add in rank order, ((p0 + p1) + p2) + ..., so
# its result depends neither on the collective's algorithm nor on the
# backend, and the virtual ranks of one process (``run_virtual``) give the
# distributed result bit for bit.


def ordered_sum(parts):
    """The parts added in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _slice(x, dim, r, n):
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class AxisComm:
    """The collectives of one mesh axis, as seen by one rank: ``size``
    ranks, this one ``rank``.  A size-1 axis runs no collective."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank

    # the raw exchanges (no autograd), each rank's tensor in, the list of
    # every rank's out (or one combined result)
    def _gather_list(self, x):
        raise NotImplementedError

    def gather(self, x, dim: int = -1):
        """The ranks' ``x`` concatenated along ``dim`` in rank order; the
        backward keeps this rank's slice of the gradient."""
        if self.size == 1:
            return x
        dim = dim % x.dim()
        if torch.is_grad_enabled() and x.requires_grad:
            return self._autograd("gather", x, dim)
        return torch.cat(self._gather_list(x), dim=dim)

    def sum(self, x):
        """Megatron's g: the ranks' ``x`` summed (every rank gets it); the
        backward passes the gradient through."""
        if self.size == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return self._autograd("sum", x, None)
        return ordered_sum(self._gather_list(x))

    def copy(self, x):
        """Megatron's f: x itself; the backward sums the gradient over
        the ranks."""
        if self.size == 1 or not (torch.is_grad_enabled()
                                  and x.requires_grad):
            return x
        return self._autograd("copy", x, None)

    def amax(self, x):
        """The elementwise maximum over the ranks (no gradient)."""
        if self.size == 1:
            return x
        parts = self._gather_list(x.detach())
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def mean(self, x):
        """The ranks' ``x`` averaged (no gradient): the data-parallel
        mean of a gradient."""
        if self.size == 1:
            return x
        return ordered_sum(self._gather_list(x.detach())) / self.size

    def broadcast(self, x, src: int):
        """Rank ``src``'s ``x`` on every rank (``x`` a buffer of its
        shape and dtype elsewhere)."""
        if self.size == 1:
            return x
        return self._gather_list(x.detach())[src]


class _TrivialComm(AxisComm):
    def __init__(self):
        super().__init__(1, 0)

    def _gather_list(self, x):
        return [x]


class DistComm(AxisComm):
    """An axis of a ``torch.distributed`` mesh: each rank a process."""

    def __init__(self, mesh, axis: str):
        super().__init__(mesh.shape[axis], mesh.get_local_rank(axis))
        self.group = mesh.get_group(axis)

    def _gather_list(self, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return parts

    def broadcast(self, x, src: int):
        if self.size == 1:
            return x
        x = x.contiguous()
        dist.broadcast(x, dist.get_global_rank(self.group, src),
                       group=self.group)
        return x

    def _autograd(self, op, x, dim):
        return _DistOp.apply(x, self, op, dim)


class _DistOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, op, dim):
        ctx.comm, ctx.op, ctx.dim = comm, op, dim
        if op == "copy":
            return x.view_as(x)
        parts = comm._gather_list(x)
        return torch.cat(parts, dim=dim) if op == "gather" \
            else ordered_sum(parts)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        if ctx.op == "gather":
            g = _slice(g, ctx.dim, comm.rank, comm.size)
        elif ctx.op == "copy":
            g = ordered_sum(comm._gather_list(g))
        return g, None, None, None


class _VirtualOp(torch.autograd.Function):
    """One collective over every virtual rank: the ranks' inputs in, the
    ranks' outputs out, one node of the graph that joins them."""

    @staticmethod
    def forward(ctx, op, dim, *xs):
        ctx.op, ctx.dim, ctx.n = op, dim, len(xs)
        if op == "copy":
            return tuple(x.view_as(x) for x in xs)
        out = torch.cat(xs, dim=dim) if op == "gather" else ordered_sum(xs)
        return tuple(out.view_as(out) for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.op == "gather":
            gs = tuple(_slice(g, ctx.dim, r, ctx.n) for r, g in
                       enumerate(gs))
        elif ctx.op == "copy":
            total = ordered_sum(gs)
            gs = tuple(total for _ in gs)
        return (None, None) + tuple(gs)


# Virtual ranks take turns: a rank runs only while it holds the baton and
# gives it up only while it waits for the others at a collective, so they
# share this process's Python state (the kernels' launch counters, their
# caches, generators) as one thread would; they share one device anyway.
_BATON = threading.Lock()


def _wait(barrier) -> int:
    _BATON.release()
    try:
        return barrier.wait()
    finally:
        _BATON.acquire()


class VirtualHub:
    """The meeting point of one axis group's virtual ranks (threads of one
    process): each deposits its tensor, one combines them, and each takes
    its result."""

    TIMEOUT = 1800.0

    def __init__(self, n: int):
        self.n = n
        self.slots = [None] * n
        self.result = None
        self.barrier = threading.Barrier(n, timeout=self.TIMEOUT)

    def exchange(self, rank: int, x, combine):
        self.slots[rank] = x
        if _wait(self.barrier) == 0:
            xs, self.slots = self.slots, [None] * self.n
            self.result = combine(xs)
        _wait(self.barrier)
        out = self.result[rank]
        # every rank has its result before the next exchange's combine
        _wait(self.barrier)
        return out


class VirtualComm(AxisComm):
    """An axis whose ranks are threads of this process (``run_virtual``)."""

    def __init__(self, hub: VirtualHub, rank: int):
        super().__init__(hub.n, rank)
        self.hub = hub

    def _gather_list(self, x):
        return self.hub.exchange(self.rank, x,
                                 lambda xs: [list(xs)] * len(xs))

    def _autograd(self, op, x, dim):
        return self.hub.exchange(
            self.rank, x, lambda xs: _VirtualOp.apply(op, dim, *xs))


def trivial_comm() -> AxisComm:
    return _TrivialComm()


def run_virtual(fn, shape: dict, device_type: str):
    """``fn(mesh)`` on every rank of a mesh of ``shape`` (a dict over the
    mesh axes) run as threads of this process, one a rank, all on this
    process's device; returns the ranks' results in rank order (row-major
    over the axes).  Each thread starts in the caller's grad mode; the
    ranks run one at a time, each until its next collective.  An exception
    in one rank aborts the others' collectives and is raised.  The ranks'
    meshes stay usable in a later call (``local_train_step`` updates in a
    second one).""" 
    from .mesh import AXES, VirtualMesh
    sizes = [shape.get(a, 1) for a in AXES]
    n = 1
    for s in sizes:
        n *= s
    coords = []
    for r in range(n):
        c, rest = [], r
        for s in reversed(sizes):
            c.append(rest % s)
            rest //= s
        coords.append(tuple(reversed(c)))
    hubs = {}
    for ai, a in enumerate(AXES):
        for c in coords:
            key = (a,) + c[:ai] + c[ai + 1:]
            if key not in hubs:
                hubs[key] = VirtualHub(sizes[ai])
    results, errors = [None] * n, []
    grad = torch.is_grad_enabled()

    def body(r):
        with _BATON:
            try:
                with torch.set_grad_enabled(grad):
                    results[r] = fn(VirtualMesh(dict(zip(AXES, sizes)),
                                                device_type, coords[r], hubs))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                for h in hubs.values():
                    h.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    return results
