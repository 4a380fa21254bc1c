"""Spark backend for the estimators (port of
``horovod_tpu/spark/backend.py``; reference:
``horovod/spark/common/backend.py``: ``SparkBackend.run`` places one
training task a rank through ``horovod.spark.run``), so that
``TorchEstimator(backend=SparkBackend(2), ...)`` trains in barrier Spark
tasks."""

import functools

from horovod_tpu_torch.cluster.backend import Backend
from horovod_tpu_torch.spark import runner


def _with_rank(fn, *args, **kwargs):
    """The Backend contract's ``fn(rank, ...)`` inside a task's job."""
    from horovod_tpu_torch.common import basics

    return fn(basics.rank(), *args, **kwargs)


class SparkBackend(Backend):
    def __init__(self, num_proc=None, use_barrier=True, verbose=False,
                 device=None):
        self._num_proc = num_proc
        self._use_barrier = use_barrier
        self._verbose = verbose
        self._device = device

    def num_processes(self):
        if self._num_proc is not None:
            return self._num_proc
        runner._require_pyspark()
        from pyspark.sql import SparkSession

        sc = SparkSession.builder.getOrCreate().sparkContext
        return max(int(sc.defaultParallelism), 1)

    def run(self, fn, args=(), kwargs=None):
        return runner.run(functools.partial(_with_rank, fn), args=args,
                          kwargs=kwargs, num_proc=self.num_processes(),
                          use_barrier=self._use_barrier,
                          verbose=self._verbose, device=self._device)
