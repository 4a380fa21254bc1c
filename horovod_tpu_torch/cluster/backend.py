"""Execution backends (port of ``horovod_tpu/cluster/backend.py``;
reference: ``horovod/spark/common/backend.py:90``: ``Backend.run(fn)``
says where the ranks' training processes live: Spark tasks there, here
this process or processes the port's launcher starts, and Spark tasks
through ``spark.SparkBackend``).

``InProcessBackend`` runs this process's own rank.  In the JAX package it
runs one thread a device rank; a torch process drives one card, so the
port runs no rank threads: ``num_proc`` above 1 raises and names
``ProcessBackend``."""

import functools

from horovod_tpu_torch.common import basics


class Backend:
    def num_processes(self):
        raise NotImplementedError

    def run(self, fn, args=(), kwargs=None):
        """Run ``fn(rank, *args, **kwargs)`` once a rank; -> the ranks'
        results in rank order."""
        raise NotImplementedError


class InProcessBackend(Backend):
    """This process's rank on ``device`` (default: the card).  Joins a
    one-rank job when nothing is initialized, and uses the job this
    process is in otherwise, which must have one rank."""

    def __init__(self, num_proc=None, device=None):
        if num_proc is not None and num_proc != 1:
            raise ValueError(
                f"InProcessBackend(num_proc={num_proc}): a torch process "
                f"drives one card and runs one rank; use "
                f"ProcessBackend({num_proc}) for a process a rank")
        self._device = device

    def num_processes(self):
        if not basics.is_initialized():
            basics.init(device=self._device)
        if basics.size() != 1:
            raise RuntimeError(
                f"InProcessBackend runs this process's one rank, but "
                f"horovod_tpu_torch is initialized with {basics.size()} "
                f"ranks; use ProcessBackend, or shut down first")
        return 1

    def run(self, fn, args=(), kwargs=None):
        self.num_processes()
        return [fn(basics.rank(), *args, **(kwargs or {}))]


def _rank_main(fn, device, *args, **kwargs):
    """One launched rank: join the job on ``device``, run ``fn(rank,
    ...)``, leave."""
    basics.init(device=device)
    try:
        return fn(basics.rank(), *args, **kwargs)
    finally:
        basics.shutdown()


class ProcessBackend(Backend):
    """One process a rank through the port's ``run(fn)`` (reference
    analog: ``horovod.spark.run`` driving task processes), each on its
    card unless ``device="cpu"``.

    Without cloudpickle (the card's machine has none) ``run(fn)`` pickles
    by name, so ``fn``, its arguments and an estimator's
    ``model_factory`` and ``loss`` must be importable: module-level
    functions or classes, or ``functools.partial`` of them.  The rank's
    wrapper is one such partial."""

    def __init__(self, num_proc, hosts=None, extra_env=None, device=None):
        self._num_proc = num_proc
        self._hosts = hosts
        self._extra_env = extra_env
        self._device = device

    def num_processes(self):
        return self._num_proc

    def run(self, fn, args=(), kwargs=None):
        from horovod_tpu_torch.run.api import run as hvd_run

        return hvd_run(functools.partial(_rank_main, fn, self._device),
                       args=args, kwargs=kwargs or {}, np=self._num_proc,
                       hosts=self._hosts, extra_env=self._extra_env)
