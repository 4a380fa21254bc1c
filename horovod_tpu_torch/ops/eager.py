"""The eager plane's submit layer: named asynchronous tensor operations
that return :class:`~horovod_tpu_torch.common.handles.Handle` objects.

Port of ``horovod_tpu/ops/eager.py`` (auto-generated names, Average/Sum
ops, prescale/postscale, ``join``), run by the plane of
:mod:`horovod_tpu_torch.ops.controller` on NCCL (the card) or gloo (the
CPU).  The public surface over it is :mod:`horovod_tpu_torch.mpi_ops`
(integer handles, Horovod's torch API).  Tensors must lie on
``hvd.device()``; the result of an op is a new tensor there.

**The input is aliased until ``synchronize``.**  The plane reads the
tensor when its cycle runs the collective, not when it is submitted; do
not write to it between the ``*_async`` call and ``synchronize`` (the
reference's adapters have the same rule, ``torch/adapter_v2.h:42``).  On
the card the plane's stream waits for the work queued on the caller's
stream before the submit, so a tensor that kernels are still writing is
read once they are done; :func:`wait` makes the caller's current stream
wait for the result.

``group=`` (a ``ProcessGroup`` from ``hvd.new_group``/``hvd.grid``) scopes
a collective to the group's members: only they call it, ranks are
global (a broadcast's root too), and an Average divides by the group's
size; a non-member's call raises.

``op=Adasum`` submits an ``ADASUM`` request, which the plane runs one
tensor at a time (never fused: Adasum's coefficients belong to one
tensor) and always on the exact wire, since Adasum combines full-precision
vectors (reference: ``horovod_tpu/ops/eager.py:78-82,131-132``);
``reduce_scatter`` refuses it.

Each submitted request is a hit of the fault point named after its type
(``allreduce``, ``adasum``, ``allgather``, ``broadcast``, ``alltoall``,
``reduce_scatter``; ``common/faults.py``), before negotiation, as the
reference's submit path is: a ``drop`` leaves the request out of the
negotiation, and its handle fails with the job's abort.
"""

import threading

import torch

from horovod_tpu_torch import groups
from horovod_tpu_torch.common import basics, faults
from horovod_tpu_torch.common.compression import resolve_compression
from horovod_tpu_torch.common.handles import Handle
from horovod_tpu_torch.common.ops_enum import (Adasum, Average, ReduceOp,
                                               RequestType, Sum)
from horovod_tpu_torch.ops.controller import Request, Signature, dtype_name

_tls = threading.local()


def _auto_name(kind: str) -> str:
    """Per-thread sequence-numbered names, matching across ranks when the
    call order matches (reference: handle-derived names in mpi_ops.py)."""
    counters = getattr(_tls, "counters", None)
    if counters is None:
        counters = _tls.counters = {}
    n = counters.get(kind, 0)
    counters[kind] = n + 1
    return f"{kind}.noname.{n}"


def _resolve_op(op, average):
    """Reference semantics (torch/mpi_ops.py:94-129): at most one of op /
    average may be set; the default is Average."""
    if op is not None and average is not None:
        raise ValueError("cannot specify both op and average")
    if op is None:
        op = Average if average in (None, True) else Sum
    return ReduceOp(op)


def _reduction(op):
    """The request type of a reduction with ``op``."""
    return RequestType.ADASUM if op == Adasum else RequestType.ALLREDUCE


def _group(group, name):
    """(the group's id, its ranks); ("", None) for the world.  A
    non-member's collective could never complete, so it raises here
    (reference: ``horovod_tpu/ops/eager.py:59-75``)."""
    gid, granks = groups.resolve(group)
    if gid:
        me = basics.rank()
        if me not in granks:
            raise ValueError(
                f"collective '{name}': rank {me} is not a member of "
                f"process group {group.name!r} (ranks {list(granks)})")
    return gid, granks


def _ready_event(device):
    """The event at which the work queued so far on the caller's stream
    is done (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _request(req_type, tensor, name, *, op=Sum, root_rank=-1,
             prescale_factor=1.0, postscale_factor=1.0, splits=None,
             compression=None, ready=None, group=("", None)):
    """``ready``: the event of a grouped submission, shared by its
    members; else one is recorded for this tensor."""
    state = basics._get_state()
    if req_type == RequestType.ADASUM:
        compression = "none"
    if not torch.is_tensor(tensor):
        raise TypeError(f"collective '{name}': expected a torch.Tensor, got "
                        f"{type(tensor).__name__}")
    if tensor.device != state.device:
        raise ValueError(
            f"collective '{name}': the tensor is on {tensor.device}, the "
            f"eager plane runs on {state.device}")
    sig = Signature(
        req_type=req_type, dtype=dtype_name(tensor.dtype),
        shape=tuple(tensor.shape), op=ReduceOp(op), root_rank=root_rank,
        prescale_factor=float(prescale_factor),
        postscale_factor=float(postscale_factor),
        splits=None if splits is None else tuple(int(s) for s in splits),
        # the job's default, as the autotuner may have switched it
        compression=resolve_compression(
            compression, default=state.controller.compression),
        group=group[0], group_ranks=group[1])
    req = Request(sig=sig, name=name, tensor=tensor, handle=Handle(name))
    if tensor.device.type == "cuda":
        req.stream = torch.cuda.current_stream(tensor.device)
        req.ready = ready or _ready_event(tensor.device)
    return req


def _submit(requests):
    controller = basics._get_state().controller
    live = []
    for req in requests:
        if faults.check(req.sig.req_type.name.lower()):
            controller.hold(req)   # silently never contributes
        else:
            live.append(req)
    controller.enqueue(live)
    return [r.handle for r in requests]


# ------------------------------------------------------------- allreduce
def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    compression=None, group=None) -> Handle:
    """``compression``: ``None`` (the job's default,
    ``HVD_TPU_COMPRESSION``), ``"none"``, ``"bf16"``, ``"fp16"``,
    ``"int8"`` or a :class:`horovod_tpu_torch.Compression` member: the
    format on the wire of this allreduce."""
    op = _resolve_op(op, average)
    name = name or _auto_name("allreduce")
    return _submit([_request(
        _reduction(op), tensor, name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=_group(group, name))])[0]


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            compression=None, group=None):
    """Submit the tensors in one cycle, as ``{name}.{i}``, so that fusion
    batches them; -> one handle each."""
    op = _resolve_op(op, average)
    base = name or _auto_name("grouped_allreduce")
    gid = _group(group, base)
    ready = _ready_event(basics.device())
    return _submit([_request(
        _reduction(op), t, f"{base}.{i}", op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, ready=ready, group=gid)
        for i, t in enumerate(tensors)])


# -------------------------------------------------------- reduce_scatter
def reduce_scatter_async(tensor, op=None, average=None, name=None,
                         prescale_factor=1.0, postscale_factor=1.0,
                         compression=None, group=None) -> Handle:
    """Reduce across ranks, then scatter row blocks of the first
    dimension: rank ``r`` receives rows ``split_sizes[r]`` of the reduced
    tensor (np.array_split partition: the first ``dim0 % size`` ranks get
    one extra row)."""
    op = _resolve_op(op, average)
    if op == Adasum:
        raise ValueError("reduce_scatter does not support the Adasum op")
    name = name or _auto_name("reduce_scatter")
    return _submit([_request(
        RequestType.REDUCE_SCATTER, tensor, name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=_group(group, name))])[0]


# ------------------------------------------------------------- allgather
def allgather_async(tensor, name=None, group=None) -> Handle:
    """Concatenation along dim 0 of every rank's tensor; the first
    dimension may differ from rank to rank."""
    name = name or _auto_name("allgather")
    return _submit([_request(RequestType.ALLGATHER, tensor, name,
                             group=_group(group, name))])[0]


def grouped_allgather_async(tensors, name=None, group=None):
    """Submit the allgathers in one cycle, as ``{name}.{i}``; -> one
    handle each."""
    base = name or _auto_name("grouped_allgather")
    gid = _group(group, base)
    ready = _ready_event(basics.device())
    return _submit([
        _request(RequestType.ALLGATHER, t, f"{base}.{i}", ready=ready,
                 group=gid)
        for i, t in enumerate(tensors)])


# ------------------------------------------------------------- broadcast
def broadcast_async(tensor, root_rank, name=None, group=None) -> Handle:
    name = name or _auto_name("broadcast")
    return _submit([_request(RequestType.BROADCAST, tensor, name,
                             root_rank=int(root_rank),
                             group=_group(group, name))])[0]


# -------------------------------------------------------------- alltoall
def alltoall_async(tensor, splits=None, name=None, group=None) -> Handle:
    """``splits[i]`` rows of dim 0 go to rank i (equal parts by
    default); the handle's result is ``(received, received_splits)``."""
    name = name or _auto_name("alltoall")
    gid = _group(group, name)
    if splits is None:
        n = len(gid[1]) if gid[0] else basics.size()
        dim0 = int(tensor.shape[0])
        if dim0 % n != 0:
            raise ValueError(
                f"alltoall without explicit splits requires the first "
                f"dimension ({dim0}) to be divisible by size ({n})")
        splits = [dim0 // n] * n
    return _submit([_request(RequestType.ALLTOALL, tensor, name,
                             splits=list(splits), group=gid)])[0]


# ------------------------------------------------------------ completion
def wait(handle: Handle, timeout=None):
    """Block until the op completes and return its result; on the card the
    caller's current stream then waits for the result (reference:
    HandleManager.WaitForCompletion)."""
    result = handle.wait(timeout)
    if handle.event is not None:
        torch.cuda.current_stream().wait_event(handle.event)
    return result


def join() -> int:
    """Signal that this rank has no more data; outstanding allreduces of
    the other ranks proceed with zeros from this rank.  Blocks until every
    rank has joined and returns the last rank to join (reference:
    torch/mpi_ops_v2.cc:240 DoJoin)."""
    handle = Handle("join")
    basics._get_state().controller.join(handle)
    return handle.wait()
