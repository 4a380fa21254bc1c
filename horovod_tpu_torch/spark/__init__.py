"""Spark attachment (port of ``horovod_tpu/spark``; reference:
``horovod/spark/__init__.py``).

``horovod_tpu_torch.spark.run(fn)`` runs a training function in Spark
tasks, a rank each (``runner.py``; needs PySpark, checked when it is
called).  The estimators, the Store and the Backends live Spark-free in
:mod:`horovod_tpu_torch.cluster`; ``SparkBackend`` trains them in Spark
tasks."""

from horovod_tpu_torch.spark.runner import run  # noqa: F401
from horovod_tpu_torch.spark.backend import SparkBackend  # noqa: F401

# the estimator surface, for the reference's import paths
# (horovod.spark.torch.TorchEstimator and horovod.spark.keras.
# KerasEstimator map here)
from horovod_tpu_torch.cluster import (  # noqa: F401
    KerasEstimator,
    LocalStore,
    Store,
    TorchEstimator,
)
