"""Device mesh construction.

The JAX package's ``create_mesh`` over ``torch.distributed``: the same
axes, data (DP), fsdp (parameter sharding and pipeline stages), tensor (TP)
and sequence (SP / context parallel), here named dimensions of a
``DeviceMesh`` with one rank a device.  NCCL runs the card's collectives,
gloo the CPU's; the caller starts the process group (address, world size
and rank), as ``torch.distributed.init_process_group`` needs them.  A world
of one needs no process group: its mesh has every axis of size 1 and no
collective runs on it, as on JAX's one-device mesh.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from ..kernels.dispatch import resolve_device

__all__ = ["create_mesh", "Mesh", "VirtualMesh", "AXES"]

AXES = ("data", "fsdp", "tensor", "sequence")


class Mesh:
    """Ranks on the axes ``AXES``: ``shape`` maps each axis to its size (a
    JAX mesh's ``shape``); ``device_mesh`` is the ``DeviceMesh`` beneath
    (None in a world of one without a process group)."""

    axis_names = AXES

    def __init__(self, shape: dict, device_type: str, device_mesh=None):
        self.shape = dict(shape)
        self.device_type = device_type
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def get_group(self, axis: str):
        """This rank's process group along ``axis`` (None without a
        process group)."""
        return (None if self.device_mesh is None
                else self.device_mesh.get_group(axis))

    def get_local_rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return (0 if self.device_mesh is None
                else self.device_mesh.get_local_rank(axis))

    def comm(self, axis: str):
        """The collectives along ``axis`` (``_collectives.AxisComm``)."""
        from ._collectives import DistComm, trivial_comm
        if self.shape[axis] == 1:
            return trivial_comm()
        return DistComm(self, axis)


class VirtualMesh(Mesh):
    """One virtual rank of a mesh whose ranks are threads of one process
    (``_collectives.run_virtual``): its coordinates on the axes and the
    axis groups' meeting points.  It has no process group; its
    collectives meet the other threads'."""

    def __init__(self, shape: dict, device_type: str, coords: tuple,
                 hubs: dict):
        super().__init__(shape, device_type)
        self.coords = dict(zip(AXES, coords))
        self._hubs = hubs

    @property
    def index(self) -> int:
        """This rank's place in row-major order over the axes (its
        result's index in ``run_virtual``)."""
        i = 0
        for a in AXES:
            i = i * self.shape[a] + self.coords[a]
        return i

    def get_group(self, axis: str):
        return None

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]

    def comm(self, axis: str):
        from ._collectives import VirtualComm, trivial_comm
        if self.shape[axis] == 1:
            return trivial_comm()
        i = AXES.index(axis)
        c = tuple(self.coords[a] for a in AXES)
        return VirtualComm(self._hubs[(axis,) + c[:i] + c[i + 1:]],
                           self.coords[axis])


def create_mesh(data: int = 1, fsdp: int = 1, tensor: int = 1,
                sequence: int = 1, *, device=None) -> Mesh:
    """A mesh of data x fsdp x tensor x sequence ranks, which must be the
    world's size (``ValueError`` otherwise).  The ranks' devices are the
    card's unless the caller asks for ``device="cpu"``; a card mesh needs
    an NCCL process group, a CPU mesh a gloo one."""
    device = resolve_device(device)
    shape = dict(zip(AXES, (data, fsdp, tensor, sequence)))
    if min(shape.values()) < 1:
        raise ValueError(f"mesh axes must be >= 1: {shape}")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} "
                         f"ranks, the world has {world}")
    if not grouped:
        return Mesh(shape, device.type)
    backend = dist.get_backend()
    want = "nccl" if device.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a {device.type} mesh runs on {want}, the process "
                         f"group on {backend}")
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(shape, device.type, init_device_mesh(
        device.type, tuple(shape.values()), mesh_dim_names=AXES))
