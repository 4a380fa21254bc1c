"""TensorFlow 2 binding (port of ``horovod_tpu/tensorflow/__init__.py``;
reference: ``horovod/tensorflow/__init__.py``): the eager collectives,
``DistributedGradientTape`` (``__init__.py:515-535``),
``DistributedOptimizer`` (``:271-433``), ``broadcast_variables`` and the
IndexedSlices path (``mpi_ops.py:111-144``), over the port's eager plane.

TF tensors cross as numpy through :mod:`horovod_tpu_torch.common.host_bridge`
onto ``hvd.device()`` (the card unless ``init(device="cpu")``) and come
back as ``tf.Tensor`` in their own dtype.  Inside ``tf.function`` a
collective runs as a ``tf.py_function`` node.  In eager mode a list of
gradients (the tape's, the optimizer's) is submitted whole and waited
for once, in order, so that the plane negotiates and fuses them in one
cycle rather than one synchronous round trip a tensor.

Per-symbol import guard: this module imports without TensorFlow, and a
symbol that needs it raises ``ImportError`` naming it on first use.
"""

try:
    import tensorflow as _tf
    _TF_ERROR = None
except ImportError as _exc:
    _tf = None
    _TF_ERROR = _exc

import numpy as _np

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import host_bridge as _bridge
from horovod_tpu_torch.common.ops_enum import (  # noqa: F401
    Adasum, Average, ReduceOp, Sum)
from horovod_tpu_torch.ops import eager as _eager

# the process surface, re-exported as the reference's hvd.* does
init = _basics.init
shutdown = _basics.shutdown
is_initialized = _basics.is_initialized
rank = _basics.rank
size = _basics.size
local_rank = _basics.local_rank
local_size = _basics.local_size
cross_rank = _basics.cross_rank
cross_size = _basics.cross_size
device = _basics.device
mpi_built = _basics.mpi_built
gloo_built = _basics.gloo_built
nccl_built = _basics.nccl_built
xla_built = _basics.xla_built
ccl_built = _basics.ccl_built
ddl_built = _basics.ddl_built
mpi_threads_supported = _basics.mpi_threads_supported
is_homogeneous = _basics.is_homogeneous


def _require_tf():
    if _tf is None:
        raise ImportError(
            "horovod_tpu_torch.tensorflow requires TensorFlow, which is not "
            "installed in this environment; horovod_tpu_torch itself "
            "offers the same collectives on torch tensors") from _TF_ERROR


def _to_tf(array, dtype=None):
    out = _tf.constant(_np.asarray(array))
    if dtype is not None and out.dtype != dtype:
        out = _tf.cast(out, dtype)
    return out


def _compression(compression):
    from horovod_tpu_torch.tensorflow.compression import Compression

    return compression or Compression.none


# --------------------------------------------------------------- collectives
def _graph_bridge(fn, tensor, out_dtype, out_shape=None):
    """Run an eager collective inside a traced ``tf.function`` as a
    ``tf.py_function`` node (the reference registers custom ops for graph
    mode, ``tensorflow/mpi_ops.cc``): it runs the eager call at step time
    under a name fixed at trace time."""
    out = _tf.py_function(fn, [tensor], Tout=out_dtype)
    if out_shape is not None:
        out.set_shape(out_shape)
    return out


def _exchange(tensors, names, comp, kwargs):
    """Submit every dense tensor's allreduce, then wait once, in order."""
    pending = []
    for t, name in zip(tensors, names):
        wire, ctx = comp.compress(t)
        pending.append((wire.dtype, ctx, _bridge.submit(
            _eager.allreduce_async, wire.numpy(), name=name, **kwargs)))
    return [comp.decompress(_to_tf(h.wait(), dtype), ctx)
            for dtype, ctx, h in pending]


def _allreduce_dense(tensors, names, compression, **kwargs):
    """Eager allreduce of dense tensors with a gradient: the allreduce
    of the upstream gradients under ``{name}.grad``, with the same op
    (reference: ``tf.RegisterGradient("HorovodAllreduce")``,
    ``mpi_ops.py:111``), so that a tape through it stays connected."""
    comp = _compression(compression)
    none = _compression(None)

    @_tf.custom_gradient
    def _diff(*ts):
        outs = _exchange(ts, names, comp, kwargs)

        def grad(*dys):
            return _exchange(dys, [f"{n}.grad" for n in names], none,
                             kwargs)

        return outs, grad

    return list(_diff(*tensors))


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              compression=None):
    """Allreduce a ``tf.Tensor`` (or ``tf.IndexedSlices``).

    IndexedSlices follow the reference's sparse path
    (``mpi_ops.py:111-144``): values and indices are allgathered instead
    of densified, and Average divides the gathered values by size; there
    is no gradient through that path (``sparse_as_dense=True`` densifies
    first).  Works in eager mode and inside ``tf.function``."""
    _require_tf()
    if not _tf.executing_eagerly() and not isinstance(
            tensor, _tf.IndexedSlices):
        return _graph_bridge(
            lambda t: allreduce(t, average=average, name=name, op=op,
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor,
                                compression=compression),
            tensor, tensor.dtype, tensor.shape)
    if isinstance(tensor, _tf.IndexedSlices):
        resolved = ReduceOp(op) if op is not None else (
            Sum if average is False else Average)
        if resolved == Adasum:
            raise NotImplementedError(
                "Adasum is not supported for tf.IndexedSlices")
        values = tensor.values
        if prescale_factor != 1.0:
            values = values * _tf.cast(prescale_factor, values.dtype)
        values = allgather(values,
                           name=f"{name}.values" if name else None)
        indices = allgather(tensor.indices,
                            name=f"{name}.indices" if name else None)
        if resolved == Average:
            values = values / size()
        if postscale_factor != 1.0:
            values = values * _tf.cast(postscale_factor, values.dtype)
        return _tf.IndexedSlices(values, indices,
                                 dense_shape=tensor.dense_shape)
    # the name is fixed before the gradient exists: the backward reuses
    # it (+ ".grad"), and a fresh auto name at gradient time would differ
    # across ranks whenever their gradients run in another order
    resolved = name or _eager._auto_name("allreduce")
    return _allreduce_dense(
        [_tf.convert_to_tensor(tensor)], [resolved], compression,
        average=average, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)[0]


def grouped_allreduce(tensors, average=None, name=None, op=None):
    _require_tf()
    base = name or "tf_grouped"
    tensors = [_tf.convert_to_tensor(t) for t in tensors]
    if not _tf.executing_eagerly():
        outs = _tf.py_function(
            lambda *ts: grouped_allreduce(list(ts), average=average,
                                          name=base, op=op),
            tensors, Tout=[t.dtype for t in tensors])
        for out, t in zip(outs, tensors):
            out.set_shape(t.shape)
        return list(outs)
    handles = _bridge.grouped_allreduce_async(
        [t.numpy() for t in tensors], average=average, name=base, op=op)
    return [_to_tf(h.wait(), t.dtype) for h, t in zip(handles, tensors)]


def allgather(tensor, name=None):
    _require_tf()
    tensor = _tf.convert_to_tensor(tensor)
    if not _tf.executing_eagerly():
        return _graph_bridge(
            lambda t: allgather(t, name=name), tensor, tensor.dtype,
            _tf.TensorShape([None]).concatenate(tensor.shape[1:]))
    return _to_tf(_bridge.submit(_eager.allgather_async, tensor.numpy(),
                                 name=name).wait(), tensor.dtype)


def broadcast(tensor, root_rank, name=None):
    _require_tf()
    tensor = _tf.convert_to_tensor(tensor)
    if not _tf.executing_eagerly():
        return _graph_bridge(
            lambda t: broadcast(t, root_rank, name=name), tensor,
            tensor.dtype, tensor.shape)
    return _to_tf(_bridge.submit(_eager.broadcast_async, tensor.numpy(),
                                 root_rank, name=name).wait(), tensor.dtype)


def alltoall(tensor, splits=None, name=None):
    _require_tf()
    tensor = _tf.convert_to_tensor(tensor)
    if not _tf.executing_eagerly():
        return _graph_bridge(
            lambda t: alltoall(t, splits=splits, name=name), tensor,
            tensor.dtype,
            _tf.TensorShape([None]).concatenate(tensor.shape[1:]))
    if splits is not None:
        splits = [int(s) for s in _np.asarray(splits)]
    return _to_tf(_bridge.submit(_eager.alltoall_async, tensor.numpy(),
                                 splits=splits, name=name).wait(),
                  tensor.dtype)


def join():
    return _eager.join()


# ---------------------------------------------------------------- variables
def broadcast_variables(variables, root_rank):
    """Assign every variable the root rank's value (reference:
    ``broadcast_variables`` / ``BroadcastGlobalVariablesHook``).  Names
    are positional so that ranks pair up whatever the scopes are called;
    every broadcast is submitted before the first is waited for."""
    _require_tf()
    variables = list(variables)
    handles = [
        _bridge.submit(_eager.broadcast_async,
                       _tf.convert_to_tensor(var).numpy(), root_rank,
                       name=f"bcast_var.{i}")
        for i, var in enumerate(variables)]
    for var, handle in zip(variables, handles):
        var.assign(_tf.cast(_to_tf(handle.wait()), var.dtype))


def broadcast_object(obj, root_rank=0, name=None):
    """Pickle-based object broadcast (reference:
    ``tensorflow/functions.py`` broadcast_object)."""
    from horovod_tpu_torch.common.objects import broadcast_object as _bo

    return _bo(obj, root_rank=root_rank, name=name or "tf_bcast_object")


# ------------------------------------------------------------ gradient tape
class _DistributedGradientTape:
    """Wraps a ``tf.GradientTape``; ``gradient()`` allreduces the result
    (reference: ``tensorflow/__init__.py:515`` _DistributedGradientTape)."""

    def __init__(self, tape, op=Average, compression=None,
                 prescale_factor=1.0, postscale_factor=1.0,
                 sparse_as_dense=False):
        self.__dict__["_tape"] = tape
        self.__dict__["_op"] = op
        self.__dict__["_compression"] = compression
        self.__dict__["_prescale"] = prescale_factor
        self.__dict__["_postscale"] = postscale_factor
        self.__dict__["_sparse_as_dense"] = sparse_as_dense

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def __getattr__(self, item):
        return getattr(self.__dict__["_tape"], item)

    def gradient(self, target, sources, output_gradients=None):
        gradients = self._tape.gradient(target, sources, output_gradients)
        # a stable prefix: a counter would freeze at trace time inside
        # tf.function, and ranks that retrace a different number of times
        # would submit other names
        return _allreduce_grads(
            gradients, op=self._op, compression=self._compression,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale,
            name_prefix="tape",
            sparse_as_dense=self._sparse_as_dense)


def DistributedGradientTape(gradtape, op=Average, compression=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            device_dense="", device_sparse="",
                            persistent=False, sparse_as_dense=False):
    """The reference's factory (``tensorflow/__init__.py:535``); the
    device arguments are accepted and unused (the plane runs on
    ``hvd.device()``)."""
    _require_tf()
    del device_dense, device_sparse, persistent
    return _DistributedGradientTape(
        gradtape, op=op, compression=compression,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        sparse_as_dense=sparse_as_dense)


def _allreduce_grads(gradients, op=Average, compression=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     name_prefix="grad", sparse_as_dense=False):
    """Allreduce a gradient or a list of them as ``{name_prefix}.{i}``.
    In eager mode the dense ones are submitted together and waited for
    once, in order; IndexedSlices take the sparse path; inside
    ``tf.function`` each is a ``py_function`` node."""
    flat_is_list = isinstance(gradients, (list, tuple))
    grads = list(gradients) if flat_is_list else [gradients]
    if sparse_as_dense:
        # reference: convert_to_tensor before the dense allreduce
        # (tensorflow/__init__.py:240)
        grads = [_tf.convert_to_tensor(g)
                 if isinstance(g, _tf.IndexedSlices) else g for g in grads]
    kwargs = dict(op=op, prescale_factor=prescale_factor,
                  postscale_factor=postscale_factor,
                  compression=compression)
    out = [None] * len(grads)
    dense = []
    for i, grad in enumerate(grads):
        if grad is None:
            continue
        if isinstance(grad, _tf.IndexedSlices) or \
                not _tf.executing_eagerly():
            out[i] = allreduce(grad, name=f"{name_prefix}.{i}", **kwargs)
        else:
            dense.append(i)
    if dense:
        compression = kwargs.pop("compression")
        reduced = _allreduce_dense(
            [_tf.convert_to_tensor(grads[i]) for i in dense],
            [f"{name_prefix}.{i}" for i in dense], compression, **kwargs)
        for i, value in zip(dense, reduced):
            out[i] = value
    if flat_is_list:
        return tuple(out) if isinstance(gradients, tuple) else out
    return out[0]


# -------------------------------------------------------------- optimizer
def _make_distributed_class(base_cls, name=None, op=Average,
                            compression=None, backward_passes_per_step=1,
                            prescale_factor=1.0, postscale_factor=1.0,
                            sparse_as_dense=False):
    """Build the dynamic ``Distributed<Base>`` optimizer class.  Exposed
    separately so that ``keras.load_model`` can rebuild saved instances
    (the class name lands in saved model configs)."""

    class _Distributed(base_cls):
        _hvd_wrapped = True

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            if backward_passes_per_step > 1 \
                    and not _tf.executing_eagerly():
                # the accumulation counter is Python state: inside a
                # traced tf.function it would freeze at trace time and
                # the compiled step would never apply updates
                raise RuntimeError(
                    "backward_passes_per_step > 1 requires eager "
                    "execution (model.compile(..., run_eagerly=True) "
                    "or an eager training loop)")
            grads_and_vars = list(grads_and_vars)
            grads = [g for g, _ in grads_and_vars]
            hvariables = [v for _, v in grads_and_vars]
            state = self.__dict__.setdefault(
                "_hvd_state", {"count": 0, "acc": None})
            if backward_passes_per_step > 1:
                dense = [
                    _tf.convert_to_tensor(g) if g is not None else None
                    for g in grads]
                if state["acc"] is None:
                    state["acc"] = dense
                else:
                    state["acc"] = [
                        a + g if (a is not None and g is not None)
                        else (a if g is None else g)
                        for a, g in zip(state["acc"], dense)]
                state["count"] += 1
                if state["count"] % backward_passes_per_step != 0:
                    return None
                grads, state["acc"] = state["acc"], None
                grads = [g / backward_passes_per_step
                         if g is not None else None for g in grads]
            # a stable name prefix, as the tape's
            reduced = _allreduce_grads(
                grads, op=op, compression=compression,
                prescale_factor=prescale_factor,
                postscale_factor=postscale_factor,
                name_prefix=f"opt.{name or 'grad'}",
                sparse_as_dense=sparse_as_dense)
            return super().apply_gradients(
                zip(reduced, hvariables), *args, **kwargs)

    _Distributed.__name__ = f"Distributed{base_cls.__name__}"
    return _Distributed


def DistributedOptimizer(optimizer, name=None, op=Average,
                         compression=None, backward_passes_per_step=1,
                         prescale_factor=1.0, postscale_factor=1.0,
                         device_dense="", device_sparse="",
                         sparse_as_dense=False):
    """Wrap a Keras optimizer so that ``apply_gradients`` allreduces
    first (reference: ``tensorflow/__init__.py:271,433``, the TF2/Keras
    flavour; the TF1 ``compute_gradients`` graph path has no
    counterpart).  ``backward_passes_per_step > 1`` accumulates locally
    and exchanges every N-th call (reference:
    ``gradient_aggregation_eager.py``)."""
    _require_tf()
    del device_dense, device_sparse
    cls = _make_distributed_class(
        optimizer.__class__, name=name, op=op, compression=compression,
        backward_passes_per_step=backward_passes_per_step,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        sparse_as_dense=sparse_as_dense)
    return cls.from_config(optimizer.get_config())


def broadcast_global_variables(root_rank):
    """The reference's TF1 call, not available: TF2 eager has no global
    collections, and in a TF1 graph the broadcast needs an in-graph op.
    ``broadcast_variables(model.variables, root_rank)`` covers TF2 and
    :class:`BroadcastGlobalVariablesHook` TF1 sessions."""
    _require_tf()
    raise NotImplementedError(
        "broadcast_global_variables needs TF1 global collections plus "
        "an in-graph op; use broadcast_variables(model.variables, "
        "root_rank) on TF2, or BroadcastGlobalVariablesHook inside a "
        "TF1 MonitoredTrainingSession")


class BroadcastGlobalVariablesHook(
        object if _tf is None else _tf.compat.v1.train.SessionRunHook):
    """TF1 session hook (reference: ``tensorflow/__init__.py:210``):
    after the session is created every global variable takes rank
    ``root_rank``'s value.  The values are read with ``session.run``,
    broadcast on the eager plane outside the graph and loaded back a
    variable at a time."""

    def __init__(self, root_rank, device=""):
        _require_tf()
        super().__init__()
        self.root_rank = root_rank
        del device  # the reference's placement; the plane has one device

    def after_create_session(self, session, coord):
        del coord
        variables = _tf.compat.v1.global_variables()
        values = session.run(variables)
        handles = [
            _bridge.submit(_eager.broadcast_async, value, self.root_rank,
                           name=f"bcast_hook.{i}")
            for i, value in enumerate(values)]
        for var, handle in zip(variables, handles):
            var.load(handle.wait().astype(var.dtype.as_numpy_dtype),
                     session)
