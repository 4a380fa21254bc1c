"""Keras estimator (port of ``horovod_tpu/cluster/keras_estimator.py``;
reference: ``horovod/spark/keras/estimator.py:532`` KerasEstimator):
``fit`` materializes the dataset to the Store, trains one worker a rank
through the port's Keras binding (the wrapped optimizer, the broadcast
and metric-average callbacks), rank 0 checkpoints the weights to the
store, and ``fit`` returns a model that serves.

The model travels to the workers as (serialized config, weights), as
the reference's Spark tasks ship it (``keras/util.py``).  The ranks'
device is the backend's: ``InProcessBackend()`` and ``ProcessBackend``
join the job on the card unless given ``device="cpu"``; Keras computes
on TensorFlow's own device, and the collectives run on the port's eager
plane on the job's device."""

import os

import numpy as np

from horovod_tpu_torch.cluster.backend import InProcessBackend
from horovod_tpu_torch.cluster.store import LocalStore


def _train_keras_rank(rank, model_config, weights, compile_kwargs,
                      store, epochs, batch_size, learning_rate,
                      num_ranks, has_val=False, streaming=False):
    """One rank's fit, in a job this process has joined.  ``num_ranks``
    is the partition the dataset was materialized for (the backend's
    process count).  ``streaming`` feeds ``model.fit`` a generator of
    row groups with a lockstep ``steps_per_epoch`` (``utils.data``)
    instead of the shard's arrays."""
    import keras
    import torch

    import horovod_tpu_torch.keras as hvd_keras
    from horovod_tpu_torch.cluster.store import load_rank_shard
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.ops_enum import Sum
    from horovod_tpu_torch.mpi_ops import allreduce

    model = keras.saving.deserialize_keras_object(model_config)
    if streaming:
        from horovod_tpu_torch.utils.data import (ParquetShardIterator,
                                                  lockstep_plan)

        batch_size, steps_per_epoch, _ = lockstep_plan(
            store, num_ranks, batch_size, epochs)
        stream = iter(ParquetShardIterator(store, rank, num_ranks,
                                           batch_size, epochs=None))
        # the first batch gives the build shape and goes back in first
        first = next(stream)

        def gen(batch=first):
            while True:
                yield np.asarray(batch["x"]), np.asarray(batch["y"])
                batch = next(stream)

        fit_data = {"x": gen(), "steps_per_epoch": steps_per_epoch}
        build_shape = (None,) + tuple(first["x"].shape[1:])
    else:
        shard = load_rank_shard(store, rank, num_ranks)
        x, y = np.asarray(shard["x"]), np.asarray(shard["y"])
        fit_data = {"x": x, "y": y, "batch_size": batch_size}
        build_shape = (None,) + tuple(x.shape[1:])
    if not model.built:
        model.build(build_shape)
    model.set_weights(weights)

    optimizer = hvd_keras.DistributedOptimizer(
        keras.optimizers.get({
            "class_name": compile_kwargs.get("optimizer", "sgd"),
            "config": {"learning_rate": learning_rate}}))
    model.compile(optimizer=optimizer,
                  loss=compile_kwargs.get("loss", "mse"),
                  metrics=compile_kwargs.get("metrics"),
                  run_eagerly=True)

    callbacks = [
        hvd_keras.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd_keras.callbacks.MetricAverageCallback(),
    ]
    fit_kwargs = {}
    if has_val:
        vs = load_rank_shard(store, rank, num_ranks, split="val")
        vx, vy = np.asarray(vs["x"]), np.asarray(vs["y"])
        fit_kwargs["validation_data"] = (vx, vy)
    history = model.fit(epochs=epochs, callbacks=callbacks, verbose=0,
                        **fit_data, **fit_kwargs)

    if hvd_keras.rank() == 0:
        path = store.checkpoint_path()
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "keras_weights.npz"),
                 *model.get_weights())
    if not has_val:
        return float(history.history["loss"][-1])
    # one more evaluate pass: history's val_loss is the ranks'
    # equal-weight mean (MetricAverageCallback), and np.array_split's
    # validation shards can differ by a row, so the global mean weights
    # each rank's loss by its rows
    local = model.evaluate(vx, vy, batch_size=batch_size, verbose=0)
    if isinstance(local, (list, tuple)):
        local = local[0]
    rows = float(len(vx))
    total = allreduce(
        torch.tensor([float(local) * rows, rows], dtype=torch.float64,
                     device=basics.device()),
        op=Sum, name="keras_estimator.metric.val_loss").cpu()
    return {"loss": float(history.history["loss"][-1]),
            "val_loss": float(total[0] / total[1])}


class KerasModel:
    """What ``KerasEstimator.fit`` returns (reference: the fitted Spark
    KerasModel with predict/evaluate)."""

    def __init__(self, model):
        self.model = model

    def predict(self, x):
        return self.model.predict(np.asarray(x), verbose=0)

    def evaluate(self, x, y):
        result = self.model.evaluate(np.asarray(x), np.asarray(y),
                                     verbose=0)
        # Keras returns [loss, *metrics] when metrics are compiled
        return float(result[0] if isinstance(result, (list, tuple))
                     else result)


class KerasEstimator:
    """Distributed trainer for a Keras model over a Store and a Backend
    (the reference's parameters: model, loss, optimizer, metrics,
    epochs, batch_size, learning_rate, store, backend, validation)."""

    def __init__(self, model, loss="mse", optimizer="sgd", metrics=None,
                 epochs=1, batch_size=32, learning_rate=0.01, store=None,
                 backend=None, validation=None, streaming=False):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics
        self.epochs = epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.store = store
        self.backend = backend
        self.validation = validation
        # stream row groups instead of loading shards (sharded-dataset
        # stores only)
        self.streaming = streaming

    def fit(self, x, y):
        """-> (``KerasModel``, the ranks' metrics)."""
        import tempfile

        import horovod_tpu_torch.keras as hvd_keras

        hvd_keras._require_keras()
        import keras

        from horovod_tpu_torch.cluster.store import (materialize_shards,
                                                     split_validation)

        store = self.store or LocalStore(tempfile.mkdtemp(
            prefix="hvd_torch_keras_estimator_"))
        backend = self.backend or InProcessBackend()
        n = backend.num_processes()
        if self.streaming:
            from horovod_tpu_torch.utils.data import require_sharded_store
            require_sharded_store(store)
        x_val = y_val = None
        if self.validation is not None:
            x, y, x_val, y_val = split_validation(x, y, self.validation)
        x, y = materialize_shards(store, x, y, n, x_val=x_val,
                                  y_val=y_val)

        if not self.model.built:
            self.model.build((None,) + tuple(x.shape[1:]))
        model_config = keras.saving.serialize_keras_object(self.model)
        weights = self.model.get_weights()
        compile_kwargs = {"loss": self.loss, "optimizer": self.optimizer,
                          "metrics": self.metrics}

        metrics = backend.run(
            _train_keras_rank,
            args=(model_config, weights, compile_kwargs, store,
                  self.epochs, self.batch_size, self.learning_rate, n,
                  x_val is not None, self.streaming))

        trained = keras.saving.deserialize_keras_object(model_config)
        if not trained.built:
            trained.build((None,) + tuple(x.shape[1:]))
        with np.load(os.path.join(store.checkpoint_path(),
                                  "keras_weights.npz")) as data:
            trained.set_weights([data[k] for k in data.files])
        trained.compile(loss=self.loss, metrics=self.metrics)
        return KerasModel(trained), metrics
