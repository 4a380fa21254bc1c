"""Reduction-op and request enums (copy of
``horovod_tpu/common/ops_enum.py``: ``ReduceOp``, ``RequestType``, the
reduce-scatter partition and ``INT8_BLOCK``)."""

import enum

# Block-scaled int8 compression: one fp32 scale per this many elements.
INT8_BLOCK = 256


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM


class RequestType(enum.IntEnum):
    """What a rank asks the negotiation for (reference: message.h
    RequestType)."""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    REDUCE_SCATTER = 6


def reduce_scatter_split_sizes(dim0, num_ranks):
    """First-dimension block sizes for REDUCE_SCATTER, np.array_split
    style: the first ``dim0 % num_ranks`` ranks get one extra row."""
    base, extra = divmod(int(dim0), int(num_ranks))
    return [base + 1 if r < extra else base for r in range(num_ranks)]
