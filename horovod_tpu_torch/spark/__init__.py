"""Spark attachment (port of ``horovod_tpu/spark``; reference:
``horovod/spark/__init__.py``).

``horovod_tpu_torch.spark.run(fn)`` runs a training function in Spark
tasks, a rank each (``runner.py``; needs PySpark, checked when it is
called).  The estimators, the Store and the Backends live Spark-free in
:mod:`horovod_tpu_torch.cluster`; ``SparkBackend`` trains them in Spark
tasks.  ``spark.keras`` and ``KerasEstimator`` wait for the port's Keras
binding."""

from horovod_tpu_torch.spark.runner import run  # noqa: F401
from horovod_tpu_torch.spark.backend import SparkBackend  # noqa: F401

# the estimator surface, for the reference's import paths
# (horovod.spark.torch.TorchEstimator maps here)
from horovod_tpu_torch.cluster import (  # noqa: F401
    LocalStore,
    Store,
    TorchEstimator,
)
