"""Parquet shard store (port of ``horovod_tpu/cluster/parquet_store.py``;
reference: ``horovod/spark/common/store.py:30,149``, ``Store`` /
``FilesystemStore`` / ``HDFSStore`` with ``intermediate_train_data`` /
``intermediate_val_data`` Parquet directories, read by each rank through
Petastorm with ``cur_shard=hvd.rank(), shard_count=hvd.size()``).

The JAX package's layout, so that each package reads the other's
datasets:

- **Row groups are the unit of sharding.**  Rank *r* of *n* owns the row
  groups ``rg % n == r``; it picks them from the footer and reads only
  their bytes.
- **Static shapes.**  A column of two or more dimensions is an Arrow
  ``FixedSizeList`` with its trailing shape in the file's metadata, so
  every rank rebuilds dense arrays of one shape.
- **Equal shards.**  Every shard is trimmed to the smallest, counted from
  the footer alone, so that every rank runs the same number of steps.
- **dtypes round-trip.**  Each column's source dtype is in the metadata.
  Parquet holds no 16-bit float: float16 and bfloat16 columns travel as
  float32 (exact) and are cast back on the way out.  numpy has no
  bfloat16, so a ``torch.bfloat16`` tensor is written from its float32
  values under the dtype name ``bfloat16`` (the JAX package's
  ``ml_dtypes`` name), and such a column reads back as a
  ``torch.bfloat16`` tensor: the same bit patterns as the JAX package's
  ``ml_dtypes.bfloat16`` array.  Every other column reads back as numpy.

``pyarrow`` is needed only to build a store: ``import
horovod_tpu_torch.cluster`` does not import it.
"""

import json
import math
import os

import numpy as np
import torch

from horovod_tpu_torch.cluster.store import Store, from_numpy
from horovod_tpu_torch.utils.logging import get_logger

_TRAIN_DIR = "intermediate_train_data"
_VAL_DIR = "intermediate_val_data"
_PART = "part-00000.parquet"
_META_PREFIX = "hvd_tpu."


def _require_pyarrow():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "ParquetStore requires pyarrow; install it or use LocalStore "
            "(npz shards)") from exc


def _host_column(col):
    """-> (the dtype name to record, a numpy array Parquet can hold)."""
    if torch.is_tensor(col):
        col = col.detach().cpu()
        if col.dtype == torch.bfloat16:
            return "bfloat16", col.float().numpy()
        col = col.numpy()
    col = from_numpy(np.asarray(col))
    if torch.is_tensor(col):  # bfloat16 bit patterns under |V2
        return "bfloat16", col.float().numpy()
    if col.dtype == np.dtype("float16"):
        return "float16", col.astype(np.float32)
    return str(col.dtype), col


class ParquetStore(Store):
    """Filesystem Parquet store with disjoint row-group reads a rank.

    ``rows_per_row_group`` fixes the sharding granularity when a split is
    written; by default a split aims at ``default_row_groups`` groups
    (64, which 2/4/8/16/32 ranks divide), at least one row each.
    """

    #: default number of row groups a materialized split aims for
    default_row_groups = 64

    def __init__(self, prefix_path, rows_per_row_group=None):
        _require_pyarrow()
        self.prefix_path = prefix_path
        self.rows_per_row_group = rows_per_row_group
        os.makedirs(prefix_path, exist_ok=True)

    # ------------------------------------------------------------- paths --
    def train_data_path(self, idx=None):
        d = _TRAIN_DIR if idx is None else f"{_TRAIN_DIR}.{idx}"
        return os.path.join(self.prefix_path, d)

    def val_data_path(self, idx=None):
        d = _VAL_DIR if idx is None else f"{_VAL_DIR}.{idx}"
        return os.path.join(self.prefix_path, d)

    def runs_path(self):
        return os.path.join(self.prefix_path, "runs")

    def run_path(self, run_id):
        return os.path.join(self.runs_path(), str(run_id))

    def checkpoint_path(self, run_id=None):
        if run_id is None:
            return os.path.join(self.prefix_path, "checkpoints")
        return os.path.join(self.run_path(run_id), "checkpoints")

    def logs_path(self, run_id):
        return os.path.join(self.run_path(run_id), "logs")

    def exists(self, path):
        return os.path.exists(path)

    # ------------------------------------------------- dataset inspection --
    def is_parquet_dataset(self, path):
        return os.path.isfile(os.path.join(path, _PART))

    def get_parquet_dataset(self, path):
        import pyarrow.parquet as pq

        return pq.ParquetFile(os.path.join(path, _PART))

    # --------------------------------------------------------- write path --
    def materialize(self, data, validation=None, idx=None,
                    rows_per_row_group=None, num_ranks=None):
        """Write ``data`` (a ``{column: array or tensor}`` dict or a
        pandas DataFrame) as the train split, and ``validation`` likewise
        as the val split, each a Parquet dataset cut into equal row groups
        (reference: ``prepare_data`` materializing the DataFrame with
        ``df.repartition``).  -> the train path.

        An explicit ``rows_per_row_group`` (argument, else the store's)
        wins; otherwise ``num_ranks`` sizes the groups so that every rank
        gets several and the trim to equal shards stays small."""
        def granularity(split_data):
            if rows_per_row_group is not None \
                    or self.rows_per_row_group is not None \
                    or not num_ranks:
                return rows_per_row_group
            n = len(next(iter(split_data.values()))) \
                if isinstance(split_data, dict) else len(split_data)
            # per split: a small val split with the train split's group
            # size would have fewer groups than ranks
            return max(1, n // max(num_ranks * 8,
                                   self.default_row_groups))

        train = self._write_split(self.train_data_path(idx), data,
                                  granularity(data))
        if validation is not None:
            self._write_split(self.val_data_path(idx), validation,
                              granularity(validation))
        return train

    def _write_split(self, path, data, rows_per_row_group=None):
        import pyarrow.parquet as pq

        table, schema, n, per_group = self._build_table(
            data, rows_per_row_group)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _PART + ".tmp")
        with pq.ParquetWriter(tmp, schema) as writer:
            for start in range(0, n, per_group):
                writer.write_table(table.slice(start, per_group))
        os.replace(tmp, os.path.join(path, _PART))
        with open(os.path.join(path, "_SUCCESS"), "w"):
            pass  # the completion marker of Spark's output contract
        return path

    def _build_table(self, data, rows_per_row_group=None):
        import pyarrow as pa

        if hasattr(data, "to_dict") and hasattr(data, "columns"):
            data = {c: np.asarray(data[c]) for c in data.columns}
        if not data:
            raise ValueError("empty dataset")
        n_rows = {k: len(v) for k, v in data.items()}
        if len(set(n_rows.values())) != 1:
            raise ValueError(f"column lengths differ: {n_rows}")
        n = next(iter(n_rows.values()))
        if n == 0:
            raise ValueError("dataset has zero rows")

        fields, arrays, meta = [], [], {}
        for name, col in data.items():
            dtype, col = _host_column(col)
            meta[f"{_META_PREFIX}dtype.{name}"] = dtype
            meta[f"{_META_PREFIX}shape.{name}"] = json.dumps(
                list(col.shape[1:]))
            if col.ndim == 1:
                arr = pa.array(col)
            else:
                flat = np.ascontiguousarray(col).reshape(len(col), -1)
                values = pa.array(flat.ravel())
                arr = pa.FixedSizeListArray.from_arrays(
                    values, flat.shape[1])
            arrays.append(arr)
            fields.append(pa.field(name, arr.type))

        schema = pa.schema(fields, metadata={
            k.encode(): str(v).encode() for k, v in meta.items()})
        table = pa.Table.from_arrays(arrays, schema=schema)

        per_group = rows_per_row_group or self.rows_per_row_group or max(
            1, math.ceil(n / self.default_row_groups))
        return table, schema, n, per_group

    # ---------------------------------------------------------- read path --
    def shard_row_counts(self, shard_count, split="train", idx=None,
                         parquet_file=None):
        """Each shard's row count from the footer alone (no data read):
        every rank derives the same smallest shard.  ``parquet_file``
        reuses an open file's footer."""
        pf = parquet_file or self._open(split, idx)
        counts = [0] * shard_count
        for rg in range(pf.metadata.num_row_groups):
            counts[rg % shard_count] += pf.metadata.row_group(rg).num_rows
        return counts

    def read_shard(self, cur_shard, shard_count, split="train", idx=None,
                   columns=None, trim_to_min=True):
        """This rank's row groups (``rg % shard_count == cur_shard``) as
        ``{column: array}`` with the source dtypes and shapes (reference:
        ``horovod/spark/keras/remote.py``: ``cur_shard=hvd.rank(),
        shard_count=hvd.size()``)."""
        if not 0 <= cur_shard < shard_count:
            raise ValueError(
                f"cur_shard {cur_shard} outside [0, {shard_count})")
        pf = self._open(split, idx)
        mine = [rg for rg in range(pf.metadata.num_row_groups)
                if rg % shard_count == cur_shard]
        counts = self.shard_row_counts(shard_count, split, idx,
                                       parquet_file=pf)
        min_rows = min(counts)
        if min_rows == 0:
            raise ValueError(
                f"shard {counts.index(0)} of {shard_count} would be "
                f"empty ({pf.metadata.num_row_groups} row groups, "
                f"{pf.metadata.num_rows} rows) — rewrite with smaller "
                f"rows_per_row_group or fewer ranks")
        table = pf.read_row_groups(mine, columns=columns)
        limit = min_rows if trim_to_min else table.num_rows
        if trim_to_min and table.num_rows > limit:
            get_logger().warning(
                "shard %d/%d trims %d of %d rows to match the smallest "
                "shard (%d rows) — rewrite with smaller "
                "rows_per_row_group to reduce the loss",
                cur_shard, shard_count, table.num_rows - limit,
                table.num_rows, limit)
        return self._to_numpy(table, pf.schema_arrow.metadata, limit)

    def _open(self, split, idx):
        path = {"train": self.train_data_path,
                "val": self.val_data_path}[split](idx)
        return self.get_parquet_dataset(path)

    @staticmethod
    def _to_numpy(table, metadata, limit):
        import pyarrow as pa

        metadata = metadata or {}
        out = {}
        for name in table.column_names:
            col = table.column(name).combine_chunks()
            shape_key = f"{_META_PREFIX}shape.{name}".encode()
            dtype_key = f"{_META_PREFIX}dtype.{name}".encode()
            trailing = json.loads(metadata.get(shape_key, b"[]"))
            if isinstance(col.type, pa.FixedSizeListType):
                arr = np.asarray(col.values)
                arr = arr.reshape(len(col), *trailing) if trailing else \
                    arr.reshape(len(col), -1)
            else:
                arr = np.asarray(col)
            arr = arr[:limit]
            want = metadata.get(dtype_key)
            want = None if want is None else want.decode()
            if want == "bfloat16":
                # the float32 carrier holds bfloat16 values exactly
                out[name] = torch.from_numpy(
                    np.array(arr, dtype=np.float32)).to(torch.bfloat16)
                continue
            if want is not None and arr.dtype.name != want:
                arr = arr.astype(want)
            out[name] = np.ascontiguousarray(arr)
        return out

    # --------------------------------------- the per-rank file protocol --
    def save_shard(self, rank, arrays, split="train"):
        raise NotImplementedError(
            "ParquetStore shards by row group — use materialize() + "
            "read_shard() (per-rank npz files are the LocalStore "
            "protocol)")

    def load_shard(self, rank, split="train"):
        raise NotImplementedError(
            "ParquetStore shards by row group — use read_shard(rank, n)")


class FilesystemStore(ParquetStore):
    """``ParquetStore`` over a ``pyarrow.fs`` URI, the HDFS/S3 analog of
    the reference's ``HDFSStore`` (``store.py:149``): the data path goes
    through the pyarrow filesystem, and ``sync_run_dir`` uploads a local
    run directory (checkpoints, logs) as the reference's ``sync_fn``
    pushes local output to HDFS.  ``hdfs://`` and ``s3://`` work where
    pyarrow has those filesystems."""

    def __init__(self, prefix_url, rows_per_row_group=None):
        _require_pyarrow()
        from pyarrow import fs as pafs

        self._fs, prefix = pafs.FileSystem.from_uri(prefix_url)
        self.prefix_url = prefix_url
        if isinstance(self._fs, pafs.LocalFileSystem):
            super().__init__(prefix, rows_per_row_group)
        else:
            self.prefix_path = prefix
            self.rows_per_row_group = rows_per_row_group
            self._fs.create_dir(prefix, recursive=True)

    def exists(self, path):
        from pyarrow import fs as pafs

        return self._fs.get_file_info(path).type != pafs.FileType.NotFound

    def get_parquet_dataset(self, path):
        import pyarrow.parquet as pq

        return pq.ParquetFile(os.path.join(path, _PART),
                              filesystem=self._fs)

    def is_parquet_dataset(self, path):
        return self.exists(os.path.join(path, _PART))

    def _write_split(self, path, data, rows_per_row_group=None):
        from pyarrow import fs as pafs

        if isinstance(self._fs, pafs.LocalFileSystem):
            return super()._write_split(path, data, rows_per_row_group)
        # an object store has no atomic rename: write the final name,
        # then the _SUCCESS marker
        import pyarrow.parquet as pq

        table, schema, n, per_group = self._build_table(
            data, rows_per_row_group)
        self._fs.create_dir(path, recursive=True)
        with pq.ParquetWriter(os.path.join(path, _PART), schema,
                              filesystem=self._fs) as writer:
            for start in range(0, n, per_group):
                writer.write_table(table.slice(start, per_group))
        with self._fs.open_output_stream(
                os.path.join(path, "_SUCCESS")):
            pass
        return path

    def sync_run_dir(self, local_dir, run_id):
        """Copy a local run directory into the store, recursively
        (reference: ``Store.sync_fn``, local training output pushed to the
        remote store after each epoch)."""
        from pyarrow import fs as pafs

        dest = self.run_path(run_id)
        self._fs.create_dir(dest, recursive=True)
        pafs.copy_files(local_dir, dest,
                        destination_filesystem=self._fs)
        return dest
