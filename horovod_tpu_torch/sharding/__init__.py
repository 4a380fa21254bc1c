"""ZeRO-1 sharded weight update and the mesh executor (port of
``horovod_tpu/sharding``): reduce-scatter the gradients, step the
optimizer on this rank's 1/N block, allgather the parameters.
``ShardedDistributedOptimizer`` on the default process group,
``ZeroDistributedOptimizer`` on the eager plane's named collectives (over
a process group with ``group=``); ``MeshExecutor``, the eager plane's
executor over a mesh's ``dp`` axis (``HVD_TPU_EXECUTOR=mesh``).
``sharded_state_wrap``/``unwrap`` are not ported (``sharding/zero.py``)."""

from horovod_tpu_torch.sharding.mesh_executor import MeshExecutor  # noqa: F401
from horovod_tpu_torch.sharding.zero import (  # noqa: F401
    ShardedDistributedOptimizer,
    ZeroDistributedOptimizer,
    flat_shard,
    gather_zero_state,
    reshard_zero_state,
    shard_chunk_size,
    zero_shard_layout,
)
