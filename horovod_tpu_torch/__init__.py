"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

Horovod's training surface on ``torch.distributed`` (NCCL on the card,
gloo on the CPU), with the JAX package's Pallas kernels rewritten as CUDA
kernels for the H100 (``horovod_tpu_torch/csrc``), and Horovod's eager
collective plane: named async collectives negotiated across ranks, fused
and run on NCCL (``mpi_ops``, Horovod's torch surface with integer
handles, over ``ops/eager.py`` and ``ops/controller.py``); ZeRO-1
(``sharding``); process groups (``new_group``, ``grid``); and model
parallelism (``parallel``: the mesh, ring, zigzag and Ulysses attention,
tensor parallelism, the pipeline and the switch MoE); Adasum
(``op=hvd.Adasum``); elastic state with durable checkpoints
(``elastic``, ``checkpoint``), the input pipeline (``utils.data``),
the training-loop helpers (``callbacks``), the launcher (``run``:
``hvdrun-torch`` / ``python -m horovod_tpu_torch.run``, and
``run.run(fn)``) and elastic membership (``elastic.run`` re-forms the
world around a lost or drained rank, ``elastic.wait_for_membership``
admits a late joiner).
Entry points run on the card unless the caller passes ``device="cpu"``.

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    total = hvd.allreduce(torch.ones(3, device=hvd.device()), op=hvd.Sum)
    h = hvd.allreduce_async_(grad)   # an integer handle
    hvd.synchronize(h)               # grad now holds the average
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    abort,
    cross_rank,
    cross_size,
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.common.compression import Compression  # noqa: F401
from horovod_tpu_torch.common.handles import (  # noqa: F401
    HvdAbortedError,
    HvdDrainedError,
    HvdError,
    HvdReconfigureError,
)
from horovod_tpu_torch.common.objects import broadcast_object  # noqa: F401
from horovod_tpu_torch.groups import (  # noqa: F401
    Grid,
    GroupUnsatisfiableError,
    ProcessGroup,
    grid,
    new_group,
)
from horovod_tpu_torch.common.ops_enum import (  # noqa: F401
    Adasum,
    Average,
    ReduceOp,
    Sum,
)
from horovod_tpu_torch.mpi_ops import (  # noqa: F401
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allgather,
    grouped_allgather_async,
    grouped_allreduce,
    grouped_allreduce_,
    grouped_allreduce_async,
    grouped_allreduce_async_,
    join,
    poll,
    reduce_scatter,
    reduce_scatter_async,
    synchronize,
)
from horovod_tpu_torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.sharding import (  # noqa: F401
    ShardedDistributedOptimizer,
    ZeroDistributedOptimizer,
    gather_zero_state,
    reshard_zero_state,
    shard_chunk_size,
)
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm  # noqa: F401
from horovod_tpu_torch import callbacks, checkpoint, elastic  # noqa: F401,E402
