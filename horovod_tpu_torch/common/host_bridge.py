"""Host arrays in and out of the eager plane: the one bridge under the
framework bindings (``tensorflow``, ``keras``, ``mxnet``).

A framework binding holds numpy arrays (``tf.Tensor.numpy()``, an
NDArray's ``asnumpy()``); the eager plane (``ops/eager.py``) takes
tensors on ``hvd.device()``, the card unless the job runs on the CPU.
This module moves an array to that device and a result back to numpy
in the caller's dtype, and submits the plane's collectives on host
arrays: ``submit(eager.allreduce_async, array, ...)`` returns a
:class:`HostHandle` whose ``wait()`` gives the result as numpy.

A bfloat16 array (``ml_dtypes.bfloat16`` or numpy's ``|V2``) crosses as
its 16-bit patterns (``common/arrays.py``) and comes back viewed as the
caller's own dtype.  This module never imports ``ml_dtypes``.

The device side is always a tensor of its own: a read-only or
non-contiguous array is copied first, and on the CPU the tensor is a
copy, so that neither the plane nor the caller sees the other's writes.

``stats()`` counts the seconds, bytes and calls of each direction
(``to_device``, ``to_host``) on the host's clock; ``reset_stats()``
sets them to 0.  On the card ``to_device`` of pageable memory returns
once the bytes are staged, and ``to_host`` waits for the card.
"""

import threading
import time

import numpy as np
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.arrays import (array_from_tensor, is_bf16,
                                             tensor_from_array)
from horovod_tpu_torch.ops import eager

_lock = threading.Lock()
_stats = {}


def reset_stats():
    with _lock:
        for way in ("to_device", "to_host"):
            _stats[way] = {"seconds": 0.0, "bytes": 0, "calls": 0}


def stats():
    """-> {"to_device": {"seconds", "bytes", "calls"}, "to_host": ...}."""
    with _lock:
        return {way: dict(v) for way, v in _stats.items()}


def _count(way, seconds, nbytes):
    with _lock:
        entry = _stats[way]
        entry["seconds"] += seconds
        entry["bytes"] += nbytes
        entry["calls"] += 1


reset_stats()


def to_device(array):
    """``array`` (anything ``np.asarray`` takes) as a tensor of its own on
    ``hvd.device()``."""
    array = np.asarray(array)
    device = basics.device()
    start = time.perf_counter()
    private = not (array.flags.c_contiguous and array.flags.writeable)
    if private:
        # np.array keeps a 0-d array 0-d (ascontiguousarray would not)
        array = np.array(array, order="C")
    host = tensor_from_array(array)
    out = host.to(device, copy=not private or device.type != "cpu")
    _count("to_device", time.perf_counter() - start, array.nbytes)
    return out


def to_host(tensor, dtype):
    """A result of the plane as numpy in the caller's ``dtype`` (a
    bfloat16 result under the caller's 2-byte dtype)."""
    start = time.perf_counter()
    host = tensor.detach().cpu()
    want_bf16 = is_bf16(dtype)
    if want_bf16 != (host.dtype == torch.bfloat16):
        host = host.to(torch.bfloat16 if want_bf16 else torch.float64)
    out = array_from_tensor(host, dtype)
    _count("to_host", time.perf_counter() - start, out.nbytes)
    return out


class HostHandle:
    """A plane handle whose result comes back to the host: ``wait()`` ->
    numpy in the dtype of the submitted array (``alltoall``'s received
    rows alone)."""

    __slots__ = ("_handle", "_dtype")

    def __init__(self, handle, dtype):
        self._handle = handle
        self._dtype = dtype

    def wait(self):
        result = eager.wait(self._handle)
        if isinstance(result, tuple):   # alltoall: (rows, splits)
            result = result[0]
        return to_host(result, self._dtype)


def submit(collective, array, /, *args, **kwargs):
    """``collective``, an ``ops/eager.py`` ``*_async`` function, on
    ``array`` moved to the device (``kwargs`` may hold ``op=``); -> a
    :class:`HostHandle`."""
    array = np.asarray(array)
    return HostHandle(collective(to_device(array), *args, **kwargs),
                      array.dtype)


def grouped_allreduce_async(arrays, **kwargs):
    """One cycle's submission of every array (``{name}.{i}``); -> one
    handle each."""
    arrays = [np.asarray(a) for a in arrays]
    handles = eager.grouped_allreduce_async(
        [to_device(a) for a in arrays], **kwargs)
    return [HostHandle(h, a.dtype) for h, a in zip(handles, arrays)]
