"""numpy arrays and CPU tensors, bfloat16 included, for the host bridge
(``common/host_bridge.py``) and the data store (``cluster/store.py``).

numpy has no bfloat16.  TensorFlow's ``bfloat16`` arrays (``ml_dtypes``)
and the ``|V2`` arrays numpy saves them as both have a 2-byte dtype of
kind ``V``: they cross as their 16-bit patterns, read as
``torch.bfloat16``.  This module imports only numpy and torch, and never
``ml_dtypes``."""

import numpy as np
import torch

_BF16_VOID = np.dtype("V2")


def is_bf16(dtype):
    """A 2-byte numpy dtype of kind ``V``: ``ml_dtypes.bfloat16`` or the
    ``|V2`` that numpy saves it as."""
    dtype = np.dtype(dtype)
    return dtype.kind == "V" and dtype.itemsize == 2 and not dtype.names


def tensor_from_array(array):
    """A CPU tensor over ``array``'s memory (bfloat16 bit patterns read as
    ``torch.bfloat16``); the array must be writable and C-contiguous."""
    if is_bf16(array.dtype):
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def array_from_tensor(tensor, dtype=None):
    """A CPU tensor's values as numpy: a bfloat16 tensor as its bit
    patterns under ``dtype`` (default ``|V2``), any other in its own
    dtype, or cast to ``dtype`` when one is given."""
    if tensor.dtype == torch.bfloat16:
        bits = tensor.contiguous().view(torch.int16).numpy()
        return bits.view(_BF16_VOID if dtype is None else dtype)
    out = tensor.numpy()
    return out if dtype is None else out.astype(dtype, copy=False)
