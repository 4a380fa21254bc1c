"""Horovod's torch collective surface with integer handles: the port's
public collective API, exported by ``horovod_tpu_torch``.

Port of ``horovod_tpu/torch/mpi_ops.py:101-357`` (reference:
``horovod/torch/mpi_ops.py``): every op has sync / async variants,
allreduce and broadcast in-place ones (``_``) too; async ops return
integer handles resolved by ``synchronize`` / ``poll`` through a
:class:`HandleManager`, and ``synchronize`` releases the handle.  The
ops run on the eager plane (:mod:`horovod_tpu_torch.ops.eager`, its
submit layer).

**The input is aliased until ``synchronize``**: the plane reads the
tensor when its cycle runs the collective, not when it is submitted, so
do not write to it in between (the reference's adapters have the same
rule, ``torch/adapter_v2.h:42``).  On the card ``synchronize`` makes the
caller's current stream wait for the result; the in-place variants copy
it into the input on that stream.

``compression`` (``None``: the job's default, ``HVD_TPU_COMPRESSION``;
the in-place forms take it too, which the reference's do not;
``"none"``, ``"bf16"``, ``"fp16"``, ``"int8"`` or a :class:`Compression`
member) is the format on the wire of a reduction: a cast, or
block-scaled int8 (``common/compression.py``).  ``group=`` (a
``ProcessGroup`` from ``hvd.new_group``/``hvd.grid``) runs a collective
over the group's members alone (``ops/eager.py``).  ``op=Adasum``
combines the ranks' tensors with Adasum (``ops/adasum.py``), each tensor
on its own and on the exact wire; ``reduce_scatter`` refuses it.
"""

import time

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.handles import HandleManager
from horovod_tpu_torch.common.ops_enum import Adasum, Average, Sum  # noqa: F401 — re-exported
from horovod_tpu_torch.ops import eager

_handle_manager = HandleManager()


class _TorchHandle:
    __slots__ = ("core_handle", "finalize")

    def __init__(self, core_handle, finalize):
        self.core_handle = core_handle
        self.finalize = finalize

    def poll(self):
        return self.core_handle.poll()

    def wait(self, timeout=None):
        return self.finalize(eager.wait(self.core_handle, timeout))


def _register(core_handle, finalize=lambda result: result) -> int:
    return _handle_manager.allocate(_TorchHandle(core_handle, finalize))


class _GroupHandle:
    """One handle over a grouped submission's member handles (reference
    contract: ``synchronize`` on it returns the list of results).
    ``wait`` drains every member before it raises the first error, so a
    partial failure leaks no member; the timeout is a deadline for the
    whole group, and members resolved before a timeout keep their outcome
    for the retry."""

    def __init__(self, members):
        self._members = list(members)
        self._done = {}   # member index -> ("ok" | "err", value)
        self.name = "grouped"

    def poll(self) -> bool:
        return all(i in self._done or _handle_manager.poll(h)
                   for i, h in enumerate(self._members))

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        for i, h in enumerate(self._members):
            if i in self._done:
                continue
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                self._done[i] = ("ok", _handle_manager.wait(h, remaining))
            except TimeoutError:
                raise   # the pending member stays registered for a retry
            except Exception as exc:  # noqa: BLE001 — drain, then raise
                self._done[i] = ("err", exc)
        errors = [v for kind, v in self._done.values() if kind == "err"]
        if errors:
            raise errors[0]
        return [self._done[i][1] for i in range(len(self._members))]


def _register_group(cores, finalizers=None) -> int:
    finalizers = finalizers or [lambda result: result] * len(cores)
    return _handle_manager.allocate(_GroupHandle([
        _register(core, fin) for core, fin in zip(cores, finalizers)]))


def _copy_into(tensor):
    def finalize(result):
        tensor.copy_(result.reshape(tensor.shape))
        return tensor
    return finalize


def synchronize(handle: int):
    """Block until the async op completes and return the result (a list
    of results for a group handle); the handle is released."""
    return _handle_manager.wait(handle)


def poll(handle: int) -> bool:
    """True once the op is done and ``synchronize`` will not block."""
    return _handle_manager.poll(handle)


def join() -> int:
    return eager.join()


def barrier(group=None, name=None):
    """Block until every rank has entered the barrier: a one-element
    allreduce under its own name, through the ordinary negotiation."""
    allreduce(torch.zeros(1, dtype=torch.int32, device=basics.device()),
              op=Sum, name=name or eager._auto_name("barrier"), group=group)


# -------------------------------------------------------------- allreduce
def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    compression=None, group=None) -> int:
    return _register(eager.allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group))


def allreduce(tensor, average=None, name=None, compression=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0, group=None):
    return synchronize(allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     group=None, compression=None) -> int:
    """In-place variant: the result is copied back into ``tensor``."""
    return _register(eager.allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group), _copy_into(tensor))


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0, group=None,
               compression=None):
    return synchronize(allreduce_async_(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        group=group, compression=compression))


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            compression=None, group=None) -> int:
    """One group handle for the burst; the members are submitted in one
    cycle as ``{name}.{i}``, so that fusion batches them."""
    return _register_group(eager.grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      compression=None, group=None):
    return synchronize(grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group))


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             group=None, compression=None) -> int:
    """In-place grouped variant: results copy back into ``tensors``."""
    return _register_group(eager.grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group),
        [_copy_into(t) for t in tensors])


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       group=None, compression=None):
    return synchronize(grouped_allreduce_async_(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        group=group, compression=compression))


# --------------------------------------------------------- reduce_scatter
def reduce_scatter_async(tensor, op=None, average=None, name=None,
                         prescale_factor=1.0, postscale_factor=1.0,
                         compression=None, group=None) -> int:
    """Reduce across ranks; rank ``r`` receives the reduced tensor's rows
    ``np.array_split``'s ``r``-th block of dim 0."""
    return _register(eager.reduce_scatter_async(
        tensor, op=op, average=average, name=name,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group))


def reduce_scatter(tensor, op=None, average=None, name=None,
                   prescale_factor=1.0, postscale_factor=1.0,
                   compression=None, group=None):
    return synchronize(reduce_scatter_async(
        tensor, op=op, average=average, name=name,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, group=group))


# -------------------------------------------------------------- allgather
def allgather_async(tensor, name=None, group=None) -> int:
    """Concatenation along dim 0 of every rank's tensor; the first
    dimension may differ from rank to rank."""
    return _register(eager.allgather_async(tensor, name=name, group=group))


def allgather(tensor, name=None, group=None):
    return synchronize(allgather_async(tensor, name=name, group=group))


def grouped_allgather_async(tensors, name=None, group=None) -> int:
    return _register_group(eager.grouped_allgather_async(
        tensors, name=name, group=group))


def grouped_allgather(tensors, name=None, group=None):
    return synchronize(grouped_allgather_async(tensors, name=name,
                                               group=group))


# -------------------------------------------------------------- broadcast
def broadcast_async(tensor, root_rank, name=None, group=None) -> int:
    return _register(eager.broadcast_async(tensor, root_rank, name=name,
                                           group=group))


def broadcast(tensor, root_rank, name=None, group=None):
    return synchronize(broadcast_async(tensor, root_rank, name=name,
                                       group=group))


def broadcast_async_(tensor, root_rank, name=None, group=None) -> int:
    return _register(eager.broadcast_async(tensor, root_rank, name=name,
                                           group=group),
                     _copy_into(tensor))


def broadcast_(tensor, root_rank, name=None, group=None):
    return synchronize(broadcast_async_(tensor, root_rank, name=name,
                                        group=group))


# --------------------------------------------------------------- alltoall
def alltoall_async(tensor, splits=None, name=None, group=None) -> int:
    """``splits[i]`` rows of dim 0 go to rank i (equal parts by default).
    With ``splits`` given as a tensor, the result is ``(received,
    received_splits)`` with the splits as an int32 tensor (reference
    parity), else the received tensor alone."""
    splits_was_tensor = splits is not None and torch.is_tensor(splits)
    if splits_was_tensor:
        splits = splits.tolist()
    core_handle = eager.alltoall_async(tensor, splits=splits, name=name,
                                       group=group)

    def finalize(result):
        out, recv_splits = result
        if splits_was_tensor:
            return out, torch.tensor(recv_splits, dtype=torch.int32)
        return out

    return _register(core_handle, finalize)


def alltoall(tensor, splits=None, name=None, group=None):
    return synchronize(alltoall_async(tensor, splits=splits, name=name,
                                      group=group))
