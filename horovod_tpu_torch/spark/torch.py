"""Import path of ``horovod.spark.torch`` (port of
``horovod_tpu/spark/torch.py``; reference:
``horovod/spark/torch/__init__.py``)."""

from horovod_tpu_torch.cluster import LocalStore, Store, TorchEstimator  # noqa: F401
