"""Sequence parallelism (port of ``horovod_tpu/parallel``): ring, zigzag
and Ulysses attention over the sequence axis (``parallel/_comm.py``).
The mesh, tensor, pipeline and MoE modules come with ROADMAP A.9b."""

from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    reference_attention,
    ring_attention,
    ring_self_attention,
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
