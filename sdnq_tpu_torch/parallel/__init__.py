"""The multi-device layer on ``torch.distributed``: the mesh, ring and
Ulysses sequence parallelism, GPipe pipeline stages over stacked blocks,
parameter sharding with the DiT's tensor parallelism, and the tensor x
data parallel training step."""

from .dryrun import dryrun_multichip, local_train_step, train_step
from .mesh import Mesh, VirtualMesh, create_mesh
from .pipeline import Stage, pipeline_forward, shard_stage_params
from .ring_attention import ring_attention
from .sharding import (
    DIT_TP_RULES, DIT_TP_SEGMENTS, Placement, Sharded, gather_batch,
    logical_axis_rules, qtensor_shardings, shard_batch, shard_params,
    unshard_params,
)
from .tp import local_tp
from .ulysses import ulysses_attention

__all__ = [
    "create_mesh", "Mesh", "VirtualMesh", "ring_attention",
    "ulysses_attention", "pipeline_forward", "shard_stage_params", "Stage",
    "qtensor_shardings", "shard_params", "unshard_params", "DIT_TP_RULES",
    "DIT_TP_SEGMENTS", "logical_axis_rules", "Placement", "Sharded",
    "shard_batch", "gather_batch", "local_tp", "train_step",
    "local_train_step", "dryrun_multichip",
]
