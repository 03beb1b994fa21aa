"""The collectives of the parallel layer, on a mesh axis's process group:
the counterparts of JAX's ``ppermute`` (a ring shift), ``all_to_all``,
the gather of a sequence-sharded output, and point-to-point hops.  Each
is called only where the axis has more than one rank."""

from __future__ import annotations

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
