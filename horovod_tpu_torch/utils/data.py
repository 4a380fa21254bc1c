"""Input pipeline: batches over a rank's in-memory shard, and device
prefetch (port of ``horovod_tpu/utils/data.py``'s ``BatchIterator`` and
``prefetch_to_device``).

- :class:`BatchIterator` batches ``{name: array}`` dicts, tuples or one
  array, reshuffled every epoch with ``seed + epoch``: the same numpy
  generator calls as the JAX iterator, so the same batches.
- :func:`prefetch_to_device` copies the next batches to the card while
  the training loop computes: a producer thread pins each batch in host
  memory and copies it on a CUDA stream of its own; the consumer's
  stream waits on the copy's event before it uses the batch, and
  ``record_stream`` tells the caching allocator that the consumer's
  stream uses the memory.

Not ported: the reference's ``sharding=`` and ``mesh=`` arguments (a
``jax.sharding`` layout, or a global ``jax.Array`` built from every
process's rows): a torch process feeds its own card, whose rows are
already its shard.  ``ParquetShardIterator`` and the ``lockstep_*``
helpers read the Spark store, which the port does not have yet
(ROADMAP A.13).
"""

import queue
import threading
import time

import numpy as np
import torch

__all__ = ["BatchIterator", "prefetch_to_device"]


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
