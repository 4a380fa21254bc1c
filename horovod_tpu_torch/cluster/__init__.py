"""Cluster glue (port of ``horovod_tpu/cluster``; reference:
``horovod/spark/`` §2.5): estimators that materialize a dataset to a
Store, train one process a rank through a Backend, checkpoint to the
store and hand back a model that serves.

Exported as in the JAX package, except ``JaxEstimator``/``JaxModel``,
whose counterpart is ``TorchEstimator``/``TorchModel`` (the JAX
package's SPMD fit, one jitted ``shard_map`` over the mesh, has none: a
torch process feeds its own card).  Importing this package needs
neither ``pyarrow`` (only a ``ParquetStore`` does), ``pyspark`` nor
Keras (only ``KerasEstimator.fit`` does)."""

from horovod_tpu_torch.cluster.store import LocalStore, Store  # noqa: F401
from horovod_tpu_torch.cluster.parquet_store import (  # noqa: F401
    FilesystemStore,
    ParquetStore,
)
from horovod_tpu_torch.cluster.backend import (  # noqa: F401
    Backend,
    InProcessBackend,
    ProcessBackend,
)
from horovod_tpu_torch.cluster.torch_estimator import (  # noqa: F401
    TorchEstimator,
    TorchModel,
)
from horovod_tpu_torch.cluster.keras_estimator import (  # noqa: F401
    KerasEstimator,
    KerasModel,
)
