"""Data and checkpoint store (port of ``horovod_tpu/cluster/store.py``;
reference: ``horovod/spark/common/store.py:30,149``: ``Store`` abstracts
the location of a training job's intermediate data and checkpoints;
``LocalStore`` is the filesystem flavour).

Training data is one ``.npz`` shard a rank, in the JAX package's layout,
so that each package reads the other's shards.  A column is a numpy
array or a tensor.  numpy has no bfloat16: a ``torch.bfloat16`` column is
written as its 16-bit patterns under the 2-byte void dtype (``|V2``),
which is how numpy saves the JAX package's ``ml_dtypes.bfloat16`` arrays,
and a ``|V2`` array reads back as a ``torch.bfloat16`` tensor; every other
column reads back as a numpy array."""

import os

import numpy as np
import torch

from horovod_tpu_torch.common.arrays import (array_from_tensor, is_bf16,
                                             tensor_from_array)
from horovod_tpu_torch.utils.logging import get_logger


def to_numpy(col):
    """A column as numpy for a file: a tensor's values on the host, a
    bfloat16 tensor as its bit patterns under ``|V2``."""
    if torch.is_tensor(col):
        return array_from_tensor(col.detach().cpu())
    return np.asarray(col)


def from_numpy(arr):
    """A column read from a file: a ``|V2`` array (bfloat16 bit
    patterns) becomes a ``torch.bfloat16`` tensor, any other array stays
    numpy."""
    if is_bf16(arr.dtype):
        return tensor_from_array(np.array(arr, order="C"))
    return arr


class Store:
    """Locations and (de)serialization for one training job."""

    def train_data_path(self, rank=None):
        raise NotImplementedError

    def checkpoint_path(self):
        raise NotImplementedError

    def save_shard(self, rank, arrays, split="train"):
        raise NotImplementedError

    def load_shard(self, rank, split="train"):
        raise NotImplementedError

    def exists(self, path):
        raise NotImplementedError


class LocalStore(Store):
    """Filesystem store (reference: ``store.py`` LocalStore /
    FilesystemStore)."""

    def __init__(self, prefix_path):
        self.prefix_path = prefix_path
        os.makedirs(prefix_path, exist_ok=True)

    def train_data_path(self, rank=None):
        base = os.path.join(self.prefix_path, "intermediate_train_data")
        if rank is None:
            return base
        return os.path.join(base, f"part_{rank:05d}.npz")

    def val_data_path(self, rank=None):
        base = os.path.join(self.prefix_path, "intermediate_val_data")
        if rank is None:
            return base
        return os.path.join(base, f"part_{rank:05d}.npz")

    def checkpoint_path(self):
        return os.path.join(self.prefix_path, "checkpoints")

    def _split_base(self, split):
        return {"train": self.train_data_path,
                "val": self.val_data_path}[split]

    def save_shard(self, rank, arrays, split="train"):
        os.makedirs(self._split_base(split)(), exist_ok=True)
        path = self._split_base(split)(rank)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: to_numpy(v) for k, v in arrays.items()})
        os.replace(tmp, path)
        return path

    def load_shard(self, rank, split="train"):
        with np.load(self._split_base(split)(rank)) as data:
            return {k: from_numpy(data[k]) for k in data.files}

    def exists(self, path):
        return os.path.exists(path)


def load_rank_shard(store, rank, size, split="train"):
    """A rank's shard from either store protocol: disjoint row-group
    reads from a sharded-dataset store (``ParquetStore``: ``cur_shard=
    rank, shard_count=size``, the reference's Petastorm reader contract),
    else the rank's npz file."""
    if hasattr(store, "read_shard"):
        # the train split trims every shard to the smallest, so that the
        # ranks step in lockstep; the validation pass is one forward and a
        # row-weighted sum and must see every row
        return store.read_shard(cur_shard=rank, shard_count=size,
                                split=split,
                                trim_to_min=(split == "train"))
    return store.load_shard(rank, split=split)


def _split(col, parts):
    """``np.array_split``'s cut of ``col`` (a numpy array or a tensor)."""
    if torch.is_tensor(col):
        return torch.tensor_split(col, parts)
    return np.array_split(col, parts)


def _column(col):
    return col if torch.is_tensor(col) else np.asarray(col)


def split_validation(x, y, validation):
    """The reference's float ``validation`` (``spark/common/params.py``:
    a fraction in (0, 1)): the last fraction of the rows is held out as
    the validation set."""
    if not 0.0 < validation < 1.0:
        raise ValueError(
            f"validation must be a float in (0, 1), got {validation}")
    x, y = _column(x), _column(y)
    n_val = max(1, int(len(x) * validation))
    if n_val >= len(x):
        raise ValueError(
            f"validation={validation} leaves no training rows "
            f"({len(x)} total)")
    return x[:-n_val], y[:-n_val], x[-n_val:], y[-n_val:]


def materialize_shards(store, x, y, num_ranks, x_val=None, y_val=None):
    """Cut ``(x, y)`` into a shard a rank and write them to the store
    (the front half of every estimator's ``fit``; reference: the
    DataFrame -> Parquet materialization of ``spark/common/store.py``);
    ``(x_val, y_val)`` likewise as the validation split.  -> the train
    columns."""
    x, y = _column(x), _column(y)
    if len(x) < num_ranks:
        raise ValueError(
            f"need at least one sample per rank ({num_ranks}), "
            f"got {len(x)}")
    if x_val is not None and len(x_val) < num_ranks:
        raise ValueError(
            f"validation split has {len(x_val)} rows — fewer than one "
            f"per rank ({num_ranks}); lower num_proc or raise the "
            f"validation fraction")
    if hasattr(store, "materialize"):
        # a sharded-dataset store: one dataset whose row groups the ranks
        # read apart; the reader's trim to the smallest shard makes the
        # shards equal, and the store sizes its groups for num_ranks
        val = None if x_val is None else {"x": _column(x_val),
                                          "y": _column(y_val)}
        store.materialize({"x": x, "y": y}, validation=val,
                          num_ranks=num_ranks)
        return x, y
    if x_val is not None:
        for rank, (xs, ys) in enumerate(
                zip(_split(_column(x_val), num_ranks),
                    _split(_column(y_val), num_ranks))):
            store.save_shard(rank, {"x": xs, "y": ys}, split="val")
    # equal shards: a rank with more batches than its peers would pair
    # gradients of different steps and then wait on the remainder forever
    even = (len(x) // num_ranks) * num_ranks
    if even != len(x):
        get_logger().warning(
            "dropping %d trailing sample(s) so every rank gets an "
            "equal shard (%d each)", len(x) - even, even // num_ranks)
        x, y = x[:even], y[:even]
    for rank, (xs, ys) in enumerate(
            zip(_split(x, num_ranks), _split(y, num_ranks))):
        store.save_shard(rank, {"x": xs, "y": ys})
    return x, y
