"""Keras binding (port of ``horovod_tpu/keras/__init__.py``; reference:
``horovod/keras/__init__.py`` + ``horovod/_keras/``): the value ops,
``DistributedOptimizer``, ``load_model`` and the four callbacks over the
Keras 3 callback API, on the TensorFlow binding's collectives
(:mod:`horovod_tpu_torch.tensorflow`), so on the port's eager plane.

Keras must run on its TensorFlow backend, as in the JAX package; another
backend raises and names itself.  Per-symbol import guard: imports
without Keras, and a symbol that needs it raises ``ImportError`` naming
Keras on first use.
"""

try:
    import keras as _keras
    _KERAS_ERROR = None
except ImportError as _exc:
    _keras = None
    _KERAS_ERROR = _exc

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common.ops_enum import (  # noqa: F401
    Adasum, Average, Sum)

init = _basics.init
shutdown = _basics.shutdown
rank = _basics.rank
size = _basics.size
local_rank = _basics.local_rank
local_size = _basics.local_size


def _require_keras():
    if _keras is None:
        raise ImportError(
            "horovod_tpu_torch.keras requires Keras on TensorFlow, which "
            "is not installed in this environment; horovod_tpu_torch "
            "itself trains torch modules") from _KERAS_ERROR
    backend = _keras.backend.backend()
    if backend != "tensorflow":
        raise RuntimeError(
            f"horovod_tpu_torch.keras needs Keras on its TensorFlow "
            f"backend; keras.backend.backend() is {backend!r} "
            f"(KERAS_BACKEND=tensorflow)")


def _hvd_tf():
    from horovod_tpu_torch import tensorflow as hvd_tf

    return hvd_tf


def allreduce(value, name=None, average=True):
    """Allreduce a tensor-compatible value (reference:
    ``keras/__init__.py:74``); -> the reduced tensor."""
    return _hvd_tf().allreduce(value, name=name, average=average)


def allgather(value, name=None):
    """Allgather a tensor-compatible value along dim 0 (reference:
    ``keras/__init__.py:88``)."""
    return _hvd_tf().allgather(value, name=name)


def broadcast(value, root_rank, name=None):
    """Broadcast a tensor-compatible value from ``root_rank``
    (reference: ``keras/__init__.py:102``)."""
    return _hvd_tf().broadcast(value, root_rank, name=name)


def broadcast_object(obj, root_rank=0, name=None):
    """Pickle-based object broadcast (the TF binding's)."""
    return _hvd_tf().broadcast_object(obj, root_rank=root_rank, name=name)


def DistributedOptimizer(optimizer, name=None, op=Average,
                         compression=None, backward_passes_per_step=1,
                         sparse_as_dense=False):
    """The TF binding's optimizer wrapper (reference:
    ``keras/__init__.py`` delegating to ``_keras/__init__.py:48``)."""
    _require_keras()
    return _hvd_tf().DistributedOptimizer(
        optimizer, name=name, op=op, compression=compression,
        backward_passes_per_step=backward_passes_per_step,
        sparse_as_dense=sparse_as_dense)


def broadcast_global_variables(model_or_variables, root_rank=0):
    """Take ``root_rank``'s weights (reference: ``keras/__init__.py``
    broadcast_global_variables)."""
    if isinstance(model_or_variables, int):
        raise TypeError(
            "TF2 has no global-variable collection: pass the model (or "
            "its variables) explicitly, e.g. "
            "broadcast_global_variables(model, root_rank=0) — the "
            "reference's broadcast_global_variables(root_rank) signature "
            "is TF1-only")
    _require_keras()
    variables = getattr(model_or_variables, "variables",
                        model_or_variables)
    _hvd_tf().broadcast_variables(variables, root_rank)


def load_model(filepath, custom_objects=None, compression=None,
               sparse_as_dense=False):
    """Load a Keras model and wrap its optimizer (reference:
    ``keras/__init__.py:117``).

    A model saved with a wrapped optimizer carries the dynamic
    ``Distributed<Base>`` class name; a wrapper of every standard Keras
    optimizer is registered here under that name and under the plain
    one, so that such saves load, and a plain save loads its slot
    variables and iteration count into the wrapped class directly.
    ``compression`` and ``sparse_as_dense`` are not saved: pass them
    again."""
    _require_keras()
    make = _hvd_tf()._make_distributed_class
    custom = dict(custom_objects or {})
    for attr in dir(_keras.optimizers):
        obj = getattr(_keras.optimizers, attr)
        if isinstance(obj, type) \
                and issubclass(obj, _keras.optimizers.Optimizer) \
                and obj is not _keras.optimizers.Optimizer:
            cls = make(obj, compression=compression,
                       sparse_as_dense=sparse_as_dense)
            custom.setdefault(cls.__name__, cls)
            custom.setdefault(obj.__name__, cls)
    model = _keras.models.load_model(filepath, custom_objects=custom)
    if getattr(model, "optimizer", None) is not None and not getattr(
            model.optimizer, "_hvd_wrapped", False):
        model.optimizer = DistributedOptimizer(
            model.optimizer, compression=compression,
            sparse_as_dense=sparse_as_dense)
    return model


# ------------------------------------------------------------- callbacks
if _keras is not None:
    class BroadcastGlobalVariablesCallback(_keras.callbacks.Callback):
        """Broadcast the weights and the optimizer's state from
        ``root_rank`` after the first batch (reference:
        ``_keras/callbacks.py:22``)."""

        def __init__(self, root_rank=0):
            _require_keras()
            super().__init__()
            self.root_rank = root_rank
            self._done = False

        def on_batch_end(self, batch, logs=None):
            if self._done:
                return
            hvd_tf = _hvd_tf()
            hvd_tf.broadcast_variables(self.model.variables,
                                       self.root_rank)
            if getattr(self.model, "optimizer", None) is not None:
                hvd_tf.broadcast_variables(
                    self.model.optimizer.variables, self.root_rank)
            self._done = True

    class MetricAverageCallback(_keras.callbacks.Callback):
        """Average the epoch's metrics over the ranks before the other
        callbacks read them (reference: ``_keras/callbacks.py:48``), with
        the port's ``callbacks.metric_average``."""

        def __init__(self):
            _require_keras()
            super().__init__()

        def on_epoch_end(self, epoch, logs=None):
            from horovod_tpu_torch.callbacks import metric_average

            if logs:
                for key in list(logs):
                    try:
                        logs[key] = metric_average(
                            float(logs[key]), f"{key}.{epoch}")
                    except (TypeError, ValueError):
                        continue

    class LearningRateWarmupCallback(_keras.callbacks.Callback):
        """The reference's warmup (``_keras/callbacks.py:172``): the
        compiled learning rate is the size-scaled target, and warmup
        ramps from ``initial_lr / size`` up to it (compile with ``lr =
        base_lr * hvd.size()``)."""

        def __init__(self, initial_lr=None, warmup_epochs=5,
                     momentum_correction=True, steps_per_epoch=None,
                     verbose=0):
            _require_keras()
            super().__init__()
            self.initial_lr = initial_lr
            self.warmup_epochs = warmup_epochs
            self.steps_per_epoch = steps_per_epoch
            self.verbose = verbose
            self._epoch = 0
            del momentum_correction  # Keras 3 has no momentum hook

        def _set_lr(self, value):
            self.model.optimizer.learning_rate.assign(value)

        def on_train_begin(self, logs=None):
            if self.initial_lr is None:
                self.initial_lr = float(
                    self.model.optimizer.learning_rate.numpy())

        def on_epoch_begin(self, epoch, logs=None):
            self._epoch = epoch

        def on_train_batch_begin(self, batch, logs=None):
            if self._epoch >= self.warmup_epochs:
                return
            if self.steps_per_epoch:
                progress = (self._epoch +
                            batch / self.steps_per_epoch) \
                    / self.warmup_epochs
            else:
                progress = (self._epoch + 1) / self.warmup_epochs
            n = _basics.size()
            scale = (1.0 + progress * (n - 1.0)) / n
            self._set_lr(self.initial_lr * scale)

        def on_epoch_end(self, epoch, logs=None):
            if epoch + 1 == self.warmup_epochs:
                self._set_lr(self.initial_lr)
                if self.verbose and _basics.rank() == 0:
                    print(f"Warmup complete: lr = {self.initial_lr}")

    class LearningRateScheduleCallback(_keras.callbacks.Callback):
        """A multiplier of the initial learning rate by epoch
        (reference: ``_keras/callbacks.py:89``)."""

        def __init__(self, multiplier, start_epoch=0, end_epoch=None,
                     staircase=True, momentum_correction=True,
                     steps_per_epoch=None, initial_lr=None):
            _require_keras()
            super().__init__()
            self.multiplier = multiplier if callable(multiplier) \
                else (lambda epoch: multiplier)
            self.start_epoch = start_epoch
            self.end_epoch = end_epoch
            self.staircase = staircase
            self.steps_per_epoch = steps_per_epoch
            self.initial_lr = initial_lr
            self._epoch = 0
            del momentum_correction

        def on_train_begin(self, logs=None):
            if self.initial_lr is None:
                self.initial_lr = float(
                    self.model.optimizer.learning_rate.numpy())

        def _in_range(self, epoch):
            return (epoch >= self.start_epoch and
                    (self.end_epoch is None or epoch < self.end_epoch))

        def on_epoch_begin(self, epoch, logs=None):
            self._epoch = epoch
            if self.staircase and self._in_range(epoch):
                self.model.optimizer.learning_rate.assign(
                    self.initial_lr * self.multiplier(epoch))

        def on_train_batch_begin(self, batch, logs=None):
            if self.staircase or not self._in_range(self._epoch):
                return
            if self.steps_per_epoch:
                epoch = self._epoch + batch / self.steps_per_epoch
            else:
                epoch = self._epoch
            self.model.optimizer.learning_rate.assign(
                self.initial_lr * self.multiplier(epoch))
else:
    def _missing(*_args, **_kwargs):
        _require_keras()

    BroadcastGlobalVariablesCallback = _missing
    MetricAverageCallback = _missing
    LearningRateWarmupCallback = _missing
    LearningRateScheduleCallback = _missing


class callbacks:  # the reference's hvd.callbacks.* namespace
    BroadcastGlobalVariablesCallback = BroadcastGlobalVariablesCallback
    MetricAverageCallback = MetricAverageCallback
    LearningRateWarmupCallback = LearningRateWarmupCallback
    LearningRateScheduleCallback = LearningRateScheduleCallback
