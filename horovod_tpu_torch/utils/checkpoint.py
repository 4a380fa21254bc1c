"""Checkpoint and resume conventions (port of
``horovod_tpu/utils/checkpoint.py``).

The reference has no core checkpointing; its conventions are rank 0
writes, and the ranks resume from rank 0's view
(``examples/keras_imagenet_resnet50.py``: ``resume_from_epoch =
hvd.broadcast(resume_from_epoch, 0)``).  This module packages them:

- :func:`save_checkpoint`: rank 0 writes ``target`` and renames it into
  place atomically; the other ranks do nothing; old checkpoints are
  pruned;
- :func:`restore_checkpoint`: load the latest (or a given) step;
- :func:`resume_step`: every rank receives rank 0's latest step;
- :class:`AsyncCheckpointManager`: the same, written from a thread.

A checkpoint is ``torch.save`` of ``target`` (a ``state_dict``, or any
nesting of tensors and Python values), ``ckpt_{step}.pt``, loaded with
``weights_only=True`` onto the host, where the JAX package writes flax
msgpack (``ckpt_{step}.msgpack``).
"""

import os
import re
import threading

import torch

from horovod_tpu_torch.elastic.state import _host_copy

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def _ckpt_path(directory, step):
    return os.path.join(directory, f"ckpt_{step}.pt")


def _steps_in(directory):
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, entries) if m)


def latest_step(directory):
    """Highest checkpoint step in ``directory``, or None."""
    steps = _steps_in(directory)
    return steps[-1] if steps else None


def _current_rank():
    from horovod_tpu_torch.common import basics

    return basics.rank() if basics.is_initialized() else 0


def save_checkpoint(directory, target, step, keep=3, rank=None):
    """Rank 0 writes ``target``; ``rank`` defaults to ``hvd.rank()`` when
    initialised, else 0.  ``keep`` checkpoints stay (0: only the one
    just written; None: all).  -> the path on rank 0, None elsewhere."""
    if rank is None:
        rank = _current_rank()
    if rank != 0:
        return None
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    tmp = path + ".tmp"
    torch.save(target, tmp)
    os.replace(tmp, path)  # atomic publish
    if keep is not None:
        steps = _steps_in(directory)
        old = ([s for s in steps if s != step] if keep == 0
               else steps[:-keep])
        for s in old:
            try:
                os.remove(_ckpt_path(directory, s))
            except FileNotFoundError:
                pass
    return path


def restore_checkpoint(directory, target, step=None):
    """Load checkpoint ``step`` (default: the latest) onto the host.
    -> ``(restored, step)``, or ``(target, None)`` when there is none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return target, None
    return torch.load(_ckpt_path(directory, step), map_location="cpu",
                      weights_only=True), step


def resume_step(directory):
    """Rank 0's latest step, on every rank: a rank with a stale view of
    the file system cannot resume from another step.  Above one rank a
    collective (an eager broadcast named ``checkpoint.resume_step``)."""
    from horovod_tpu_torch import mpi_ops
    from horovod_tpu_torch.common import basics

    step = latest_step(directory)
    if not basics.is_initialized() or basics.size() == 1:
        return step
    mine = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                        device=basics.device())
    value = int(mpi_ops.broadcast(mine, 0, name="checkpoint.resume_step")[0])
    return None if value < 0 else value


class AsyncCheckpointManager:
    """``save`` copies ``target`` to the host and returns; a writer
    thread writes it with :func:`save_checkpoint` (the reference's
    orbax manager, which the port does not have).  Rank 0 writes, the
    other ranks do nothing; ``keep`` prunes old steps.  Call :meth:`wait`
    before reading a step just saved, and :meth:`close` at the end."""

    def __init__(self, directory, keep=3, rank=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._rank = rank
        self._cond = threading.Condition()
        self._queue = []        # (step, host copy); guarded by _cond
        self._busy = False      # guarded by _cond
        self._stop = False      # guarded by _cond
        self.errors = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-async-ckpt")
        self._thread.start()

    def _is_writer(self):
        rank = self._rank if self._rank is not None else _current_rank()
        return rank == 0

    def save(self, step, target):
        """Queue a save of ``target`` at ``step`` (rank 0).  -> True when
        one was queued."""
        if not self._is_writer():
            return False
        item = (step, _host_copy(target))
        with self._cond:
            self._queue.append(item)
            self._cond.notify_all()
        return True

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if not self._queue:
                    return
                step, target = self._queue.pop(0)
                self._busy = True
            try:
                save_checkpoint(self.directory, target, step,
                                keep=self.keep, rank=0)
            except Exception as exc:  # noqa: BLE001 — surfaced by wait()
                self.errors.append(exc)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def wait(self):
        """Block until every queued save is on disk; a failed write
        raises here."""
        with self._cond:
            self._cond.wait_for(lambda: not self._queue and not self._busy)
        if self.errors:
            raise self.errors.pop(0)

    def restore(self, target, step=None):
        """-> ``(restored, step)`` or ``(target, None)``."""
        self.wait()
        return restore_checkpoint(self.directory, target, step)

    def latest_step(self):
        self.wait()
        return latest_step(self.directory)

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()
        if self.errors:
            raise self.errors.pop(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
