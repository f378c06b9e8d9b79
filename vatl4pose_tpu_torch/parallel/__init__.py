"""Process mesh and sharded steps (counterpart of vatl4pose_tpu/parallel:
data parallel over ranks, one process a rank; see mesh.py)."""

from .mesh import (Mesh, Sharding, active_mesh, all_gather, all_reduce_,
                   all_reduce_grads, all_reduce_sum, broadcast_module,
                   broadcast_object, data_sharding, init_distributed,
                   init_multihost, is_primary, make_mesh, replicated,
                   shard_batch, world_size)
from .steps import build_sharded_eval_step, build_sharded_train_step
