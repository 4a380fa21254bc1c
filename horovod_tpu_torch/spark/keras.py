"""Import path of ``horovod.spark.keras`` (port of
``horovod_tpu/spark/keras.py``; reference:
``horovod/spark/keras/__init__.py``).  The estimator itself is
Spark-free (:mod:`horovod_tpu_torch.cluster`); ``SparkBackend`` trains it
in Spark tasks."""

from horovod_tpu_torch.cluster import KerasEstimator, LocalStore, Store  # noqa: F401
