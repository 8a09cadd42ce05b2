"""The node-sharded mesh: its layout and the sharded routes
(kube_batch_tpu/parallel/)."""

from .mesh import (NODE_AXIS, Mesh, ShardedTensor, default_mesh, make_mesh,
                   shard_solver_inputs, use_mesh)

__all__ = ["NODE_AXIS", "Mesh", "ShardedTensor", "default_mesh", "make_mesh",
           "shard_solver_inputs", "use_mesh"]
