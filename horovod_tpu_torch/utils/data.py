"""Input pipeline: batches over a rank's in-memory shard, batches
streamed from a rank's Parquet row groups, and device prefetch (port of
``horovod_tpu/utils/data.py``).

- :class:`BatchIterator` batches ``{name: array}`` dicts, tuples or one
  array, reshuffled every epoch with ``seed + epoch``: the same numpy
  generator calls as the JAX iterator, so the same batches.
- :class:`ParquetShardIterator` streams this rank's row groups of a
  ``cluster.ParquetStore`` dataset (``rg % shard_count == cur_shard``),
  one group in memory at a time; :func:`lockstep_plan` and
  :func:`lockstep_shard_batches` cap every rank at the smallest shard's
  steps.  The same generator calls as the JAX package's, so the same
  batches and the same shuffle.
- :func:`prefetch_to_device` copies the next batches to the card while
  the training loop computes: a producer thread pins each batch in host
  memory and copies it on a CUDA stream of its own; the consumer's
  stream waits on the copy's event before it uses the batch, and
  ``record_stream`` tells the caching allocator that the consumer's
  stream uses the memory.

A column is a numpy array or a tensor (a ``torch.bfloat16`` column, which
numpy cannot hold, comes out of the stores as a tensor).  Not ported: the
reference's ``sharding=`` and ``mesh=`` arguments (a ``jax.sharding``
layout, or a global ``jax.Array`` built from every process's rows): a
torch process feeds its own card, whose rows are already its shard.
"""

import queue
import threading
import time

import numpy as np
import torch

__all__ = ["BatchIterator", "ParquetShardIterator", "prefetch_to_device",
           "lockstep_plan", "lockstep_shard_batches", "min_shard_rows",
           "require_sharded_store"]


def _tree_rows(data):
    """Leading-dim length of a {name: array} dict / tuple / array."""
    if isinstance(data, dict):
        arrays = list(data.values())
    elif isinstance(data, (tuple, list)):
        arrays = list(data)
    else:
        arrays = [data]
    if not arrays:
        raise ValueError("empty batch structure")
    rows = {int(np.shape(a)[0]) for a in arrays}
    if len(rows) != 1:
        raise ValueError(f"ragged leading dims: {sorted(rows)}")
    return rows.pop()


def _tree_map(fn, data):
    if isinstance(data, dict):
        return {k: fn(v) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(fn(v) for v in data)
    return fn(data)


class BatchIterator:
    """Deterministic batches of in-memory per-rank shard data.

    ``data``: a ``{name: array}`` dict, a tuple of arrays or one array
    (numpy arrays or tensors); batches keep the structure.  ``shuffle``
    reshuffles every epoch with ``seed + epoch``, so runs are
    reproducible and ranks holding disjoint shards need no coordination
    (the reference gets the same from ``DistributedSampler.set_epoch``).
    ``epochs=None`` iterates forever."""

    def __init__(self, data, batch_size, *, shuffle=False, seed=0,
                 drop_remainder=True, epochs=1):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {batch_size}")
        self._data = data
        self._rows = _tree_rows(data)
        if self._rows == 0:
            raise ValueError("shard has zero rows")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epochs = epochs
        if drop_remainder and self._rows < batch_size:
            raise ValueError(
                f"shard rows ({self._rows}) < batch_size ({batch_size}) "
                f"with drop_remainder — every epoch would be empty")

    @property
    def batches_per_epoch(self):
        if self.drop_remainder:
            return self._rows // self.batch_size
        return -(-self._rows // self.batch_size)

    def __iter__(self):
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            if self.shuffle:
                order = np.random.default_rng(
                    self.seed + epoch).permutation(self._rows)
            else:
                order = np.arange(self._rows)
            stop = (self._rows - self._rows % self.batch_size
                    if self.drop_remainder else self._rows)
            for lo in range(0, stop, self.batch_size):
                idx = order[lo:lo + self.batch_size]
                yield _tree_map(lambda v: v[idx], self._data)
            epoch += 1


def _concat(a, b):
    if torch.is_tensor(a):
        return torch.cat([a, b])
    return np.concatenate([a, b])


class ParquetShardIterator:
    """Stream this rank's Parquet row groups into batches, one group in
    memory at a time.

    ``ParquetStore.read_shard``'s rows (the disjoint row groups ``rg %
    shard_count == cur_shard``; reference: the Petastorm readers of
    ``horovod/spark/keras/remote.py``) without the whole shard in memory:
    the rows left when a group runs out carry into the next group's
    batches, so batch boundaries do not show the group size.  ``shuffle``
    permutes the rank's group order each epoch and the rows inside each
    group (a window shuffle bounded by one row group, as Petastorm's
    shuffling buffer is).
    """

    def __init__(self, store, cur_shard, shard_count, batch_size, *,
                 split="train", idx=None, columns=None, shuffle=False,
                 seed=0, drop_remainder=True, epochs=1):
        if not 0 <= cur_shard < shard_count:
            raise ValueError(
                f"cur_shard {cur_shard} outside [0, {shard_count})")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {batch_size}")
        self._store = store
        self._cur_shard = cur_shard
        self._shard_count = shard_count
        self._split = split
        self._idx = idx
        self._columns = columns
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epochs = epochs
        pf = store._open(split, idx)
        self._groups = [rg for rg in range(pf.metadata.num_row_groups)
                        if rg % shard_count == cur_shard]
        if not self._groups:
            raise ValueError(
                f"shard {cur_shard}/{shard_count} holds no row groups "
                f"({pf.metadata.num_row_groups} total) — rewrite with "
                f"smaller rows_per_row_group or fewer ranks")
        rows = sum(pf.metadata.row_group(rg).num_rows
                   for rg in self._groups)
        if drop_remainder and rows < batch_size:
            # BatchIterator's check: an epoch that yields nothing fails
            # here, not as a run of zero training steps
            raise ValueError(
                f"shard {cur_shard}/{shard_count} rows ({rows}) < "
                f"batch_size ({batch_size}) with drop_remainder — "
                f"every epoch would be empty")

    def _read_group(self, pf, rg, schema_meta):
        table = pf.read_row_groups([rg], columns=self._columns)
        return self._store._to_numpy(table, schema_meta, table.num_rows)

    def __iter__(self):
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            rng = (np.random.default_rng(self.seed + epoch)
                   if self.shuffle else None)
            groups = list(self._groups)
            if rng is not None:
                rng.shuffle(groups)
            pf = self._store._open(self._split, self._idx)
            schema_meta = pf.schema_arrow.metadata
            pending = None  # the rows left over, fewer than a batch
            for rg in groups:
                chunk = self._read_group(pf, rg, schema_meta)
                if rng is not None:
                    order = rng.permutation(_tree_rows(chunk))
                    chunk = _tree_map(lambda v: v[order], chunk)
                if pending is not None:
                    chunk = {k: _concat(pending[k], v)
                             for k, v in chunk.items()}
                rows = _tree_rows(chunk)
                stop = rows - rows % self.batch_size
                for lo in range(0, stop, self.batch_size):
                    yield _tree_map(
                        lambda v: v[lo:lo + self.batch_size], chunk)
                pending = (_tree_map(lambda v: v[stop:rows], chunk)
                           if stop < rows else None)
            if pending is not None and not self.drop_remainder:
                yield pending
            epoch += 1


def require_sharded_store(store):
    """Fail before any I/O when a store has no row groups to stream."""
    if not hasattr(store, "shard_row_counts"):
        raise ValueError(
            "streaming=True needs a sharded-dataset store "
            "(ParquetStore/FilesystemStore); this store has no "
            "row-group layout to stream")


def min_shard_rows(store, num_ranks):
    """The smallest shard's row count (from the footer alone), with
    ``read_shard``'s error for an empty shard."""
    counts = store.shard_row_counts(num_ranks)
    if min(counts) == 0:
        raise ValueError(
            f"shard {counts.index(0)} of {num_ranks} would be empty — "
            f"rewrite with smaller rows_per_row_group or fewer ranks")
    return min(counts)


def lockstep_plan(store, num_ranks, batch_size, epochs):
    """-> (batch_size clamped to the smallest shard, steps an epoch,
    steps in all), the same on every rank: a rank that runs more
    collective rounds than its peers hangs the job.  The streamed
    counterpart of ``read_shard``'s trim to equal shards."""
    rows = min_shard_rows(store, num_ranks)
    batch_size = min(batch_size, rows)
    steps_per_epoch = max(rows // batch_size, 1)
    return batch_size, steps_per_epoch, epochs * steps_per_epoch


def lockstep_shard_batches(store, rank, num_ranks, batch_size, epochs):
    """One rank's streamed batches, capped by :func:`lockstep_plan`."""
    import itertools

    batch_size, _, steps = lockstep_plan(store, num_ranks, batch_size,
                                         epochs)
    return itertools.islice(
        iter(ParquetShardIterator(store, rank, num_ranks, batch_size,
                                  epochs=None)), steps)


def _default_device(device):
    """The job's device (``hvd.device()``), else the card; asking for the
    card without one raises."""
    from horovod_tpu_torch.common import basics

    if device is None and basics.is_initialized():
        return basics.device()
    return basics.resolve_device(device)


def prefetch_to_device(iterator, size=2, device=None):
    """Stage up to ``size`` batches of ``iterator`` on ``device`` (default:
    the job's device, ``hvd.device()``) ahead of the training loop; ->
    a generator of batches of tensors there.

    On the card a producer thread copies each batch from pinned host
    memory on a stream of its own; the consumer's current stream waits
    for that copy before the batch is handed out.  Errors of the source
    iterator re-raise at the consumer's ``next()``; ``close()`` (or
    leaving the loop) stops the producer and releases the staged
    batches."""
    if size <= 0:
        raise ValueError(f"size must be > 0, got {size}")
    device = _default_device(device)
    cuda = device.type == "cuda"

    q = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def _put(item):
        # a put that gives up when the consumer has stopped: a plain put
        # would block this thread, and pin its batches, forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if cuda:
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)

                def put(x):
                    host = torch.as_tensor(x).pin_memory()
                    with torch.cuda.stream(stream):
                        return host.to(device, non_blocking=True)
            else:
                def put(x):
                    return torch.as_tensor(x).to(device, copy=True)
            for batch in iterator:
                staged = _tree_map(put, batch)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(stream)
                if stop.is_set() or not _put((staged, event)):
                    return
            _put(sentinel)
        except BaseException as exc:  # noqa: BLE001 — re-raised consumer-side
            _put((sentinel, exc))

    # staging starts now, not at the first next(): the first batch should
    # be on the card before the loop asks for it
    producer_thread = threading.Thread(target=producer, daemon=True,
                                       name="hvd-torch-prefetch")
    producer_thread.start()

    def consume():
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if item[0] is sentinel:
                    raise item[1]
                staged, event = item
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    _tree_map(lambda t: t.record_stream(current), staged)
                yield staged
        finally:
            # release the producer and every staged batch.  A producer
            # already inside q.put when stop is set can land one more
            # item after a first drain: keep draining until it has exited
            # or its put window (0.2 s) has passed; never wait on the
            # source iterator, which may legally stall
            stop.set()
            deadline = time.monotonic() + 1.0
            while True:
                try:
                    q.get_nowait()
                    continue
                except queue.Empty:
                    pass
                producer_thread.join(timeout=0.05)
                if not producer_thread.is_alive() \
                        or time.monotonic() > deadline:
                    break
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    return consume()
