"""The device mesh and its collectives (counterpart of ``pevit_tpu/parallel``)."""

from .collectives import Axis
from .mesh import (
    Mesh,
    RowShard,
    clip_param_specs,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = ["Axis", "Mesh", "RowShard", "clip_param_specs", "make_mesh", "replicate",
           "shard_batch", "shard_params"]
