"""The multi-device layer on ``torch.distributed``: the mesh, ring and
Ulysses sequence parallelism, and GPipe pipeline stages over stacked
blocks.  (Tensor parallelism and parameter sharding, the JAX package's
``parallel/sharding.py``, are a later slice of the port.)"""

from .mesh import Mesh, create_mesh
from .pipeline import Stage, pipeline_forward, shard_stage_params
from .ring_attention import ring_attention
from .ulysses import ulysses_attention

__all__ = [
    "create_mesh", "Mesh", "ring_attention", "ulysses_attention",
    "pipeline_forward", "shard_stage_params", "Stage",
]
