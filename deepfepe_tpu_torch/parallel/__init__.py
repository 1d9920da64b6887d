"""Data-, tensor- and correspondence-parallel layers over torch.distributed."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_grads, init_distributed,
                   make_hybrid_mesh, make_mesh, shard, shard_batch, shard_params)
from .nshard import make_nsharded_fit
from .tp import shard_params_tp

__all__ = [k for k in dir() if not k.startswith("_")]
