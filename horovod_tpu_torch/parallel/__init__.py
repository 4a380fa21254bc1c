"""Model parallelism (port of ``horovod_tpu/parallel``): the rank mesh,
sequence parallelism (ring, zigzag and Ulysses attention over
``parallel/_comm.py``), tensor parallelism, the GPipe pipeline and the
switch Mixture-of-Experts.  ``shard_global_batch`` is not ported
(``parallel/mesh.py``)."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshAxes,
    data_parallel_mesh,
    hierarchical_mesh,
    make_mesh,
)
from horovod_tpu_torch.parallel.moe import (  # noqa: F401
    init_moe_params,
    switch_moe,
    switch_route,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipelined,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    reference_attention,
    ring_attention,
    ring_self_attention,
)
from horovod_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    constrain,
    params_shardings,
    shard_params,
    transformer_sharding_rules,
)
from horovod_tpu_torch.parallel.ulysses import (  # noqa: F401
    heads_to_seq,
    seq_to_heads,
    ulysses_attention,
    ulysses_self_attention,
)
from horovod_tpu_torch.parallel.zigzag_attention import (  # noqa: F401
    zigzag_ring_attention,
    zigzag_ring_self_attention,
    zigzag_shard,
    zigzag_unshard,
)
