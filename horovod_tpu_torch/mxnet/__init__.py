"""MXNet binding (port of ``horovod_tpu/mxnet/__init__.py``; reference:
``horovod/mxnet/__init__.py`` + ``mpi_ops.py``): ``DistributedOptimizer``
(the allreduce inside ``update``), gluon's ``DistributedTrainer``
(``__init__.py:87``), ``broadcast_parameters`` (``:120``) and the
collectives, on the port's eager plane instead of ``MXEnginePushAsync``
(``mxnet/mpi_ops.cc:135``).

NDArrays cross as numpy through :mod:`horovod_tpu_torch.common.host_bridge`
onto ``hvd.device()`` and back.  A list of gradients (the optimizer's
tuple index, the trainer's parameters) and ``broadcast_parameters`` are
submitted whole and waited for once, in order.

Per-symbol import guard: imports without MXNet (end of life upstream),
and a symbol that needs it raises ``ImportError`` naming it on first
use.  ``tests/_mxnet_shim`` is a numpy stand-in for exactly the NDArray,
optimizer and gluon surface used here.
"""

try:
    import mxnet as _mx
    _MX_ERROR = None
except ImportError as _exc:
    _mx = None
    _MX_ERROR = _exc

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import host_bridge as _bridge
from horovod_tpu_torch.common.ops_enum import (  # noqa: F401
    Adasum, Average, Sum)
from horovod_tpu_torch.ops import eager as _eager

init = _basics.init
shutdown = _basics.shutdown
rank = _basics.rank
size = _basics.size
local_rank = _basics.local_rank
local_size = _basics.local_size
device = _basics.device
mpi_built = _basics.mpi_built
gloo_built = _basics.gloo_built
nccl_built = _basics.nccl_built
ccl_built = _basics.ccl_built
ddl_built = _basics.ddl_built
mpi_threads_supported = _basics.mpi_threads_supported
is_homogeneous = _basics.is_homogeneous


def _require_mx():
    if _mx is None:
        raise ImportError(
            "horovod_tpu_torch.mxnet requires MXNet, which is not "
            "installed in this environment; horovod_tpu_torch itself "
            "trains torch modules") from _MX_ERROR


def _to_mx(result, like):
    arr = _mx.nd.array(result, dtype=like.dtype)
    return arr.as_in_context(like.context)


# --------------------------------------------------------------- collectives
def allreduce(tensor, average=True, name=None, prescale_factor=1.0,
              postscale_factor=1.0):
    _require_mx()
    out = _bridge.submit(_eager.allreduce_async, tensor.asnumpy(),
                         average=average, name=name,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor).wait()
    return _to_mx(out, tensor)


def _in_place(collective, tensor, *args, **kwargs):
    """Submit ``collective`` on ``tensor``; -> a function that waits and
    writes the result into ``tensor``."""
    _require_mx()
    handle = _bridge.submit(collective, tensor.asnumpy(), *args, **kwargs)

    def finish():
        tensor[:] = handle.wait()
        return tensor

    return finish


def allreduce_(tensor, average=True, name=None, priority=0):
    """In-place allreduce (reference: ``mpi_ops.py`` allreduce_);
    ``priority`` is accepted and unused (the plane orders by
    negotiation, not engine priority)."""
    del priority
    return _in_place(_eager.allreduce_async, tensor, average=average,
                     name=name)()


def allgather(tensor, name=None):
    _require_mx()
    return _to_mx(_bridge.submit(_eager.allgather_async, tensor.asnumpy(),
                                 name=name).wait(), tensor)


def broadcast(tensor, root_rank, name=None):
    _require_mx()
    return _to_mx(_bridge.submit(_eager.broadcast_async, tensor.asnumpy(),
                                 root_rank, name=name).wait(), tensor)


def broadcast_(tensor, root_rank, name=None):
    return _in_place(_eager.broadcast_async, tensor, root_rank,
                     name=name)()


def alltoall(tensor, splits=None, name=None):
    _require_mx()
    return _to_mx(_bridge.submit(_eager.alltoall_async, tensor.asnumpy(),
                                 splits=splits, name=name).wait(), tensor)


def _sum_in_place(pairs):
    """Sum every ``(NDArray, name)`` across ranks in place: submitted
    together, waited for once, in order."""
    for finish in [_in_place(_eager.allreduce_async, t, average=False,
                             name=name) for t, name in pairs]:
        finish()


# ----------------------------------------------------------------- optimizer
def DistributedOptimizer(optimizer):
    """Wrap an ``mx.optimizer.Optimizer``: gradients are summed across
    ranks inside ``update``/``update_multi_precision`` and
    ``rescale_grad`` is divided by size, which averages them (reference:
    ``mxnet/__init__.py:40-85``)."""
    _require_mx()
    if getattr(optimizer, "_hvd_wrapped", False):
        # wrapping twice would sum the gradients twice and divide
        # rescale_grad twice
        raise ValueError(
            "optimizer is already a DistributedOptimizer; wrapping "
            "twice would double-allreduce gradients")

    class _Distributed(_mx.optimizer.Optimizer):
        _hvd_wrapped = True

        def __init__(self, opt):
            self._optimizer = opt
            self._optimizer.rescale_grad /= size()

        def __getattr__(self, item):
            return getattr(self.__dict__["_optimizer"], item)

        def create_state_multi_precision(self, index, weight):
            return self._optimizer.create_state_multi_precision(
                index, weight)

        def _do_allreduce(self, index, grad):
            if size() == 1:
                return
            if isinstance(index, (tuple, list)):
                _sum_in_place(zip(grad, (str(i) for i in index)))
            else:
                allreduce_(grad, average=False, name=str(index))

        def update(self, index, weight, grad, state):
            self._do_allreduce(index, grad)
            self._optimizer.update(index, weight, grad, state)

        def update_multi_precision(self, index, weight, grad, state):
            self._do_allreduce(index, grad)
            self._optimizer.update_multi_precision(index, weight, grad,
                                                   state)

        def set_learning_rate(self, lr):
            self._optimizer.set_learning_rate(lr)

        def set_lr_mult(self, args_lr_mult):
            self._optimizer.set_lr_mult(args_lr_mult)

        def set_wd_mult(self, args_wd_mult):
            self._optimizer.set_wd_mult(args_wd_mult)

    return _Distributed(optimizer)


if _mx is not None:
    class DistributedTrainer(_mx.gluon.Trainer):
        """Gluon trainer whose ``_allreduce_grads`` sums the gradients
        across ranks and whose update rescales by 1/size (reference:
        ``mxnet/__init__.py:87``)."""

        def __init__(self, params, optimizer, optimizer_params=None,
                     **kwargs):
            if getattr(optimizer, "_hvd_wrapped", False):
                # the sum and the 1/size rescale would both happen twice
                raise ValueError(
                    "DistributedTrainer wraps a plain optimizer; do not "
                    "pass a DistributedOptimizer")
            # kvstore=None, as the reference passes it: gluon's default
            # 'device' kvstore would route updates through a store that
            # _allreduce_grads never feeds
            kwargs.setdefault("kvstore", None)
            super().__init__(params, optimizer,
                             optimizer_params=optimizer_params, **kwargs)
            self._scale /= size()

        def _allreduce_grads(self):
            # a parameter on several contexts has a gradient on each; all
            # are in flight at once, so each context's needs its own name
            _sum_in_place(
                (grad, f"{i}.{j}") for i, param in enumerate(self._params)
                if param.grad_req != "null"
                for j, grad in enumerate(param.list_grad()))
else:
    def DistributedTrainer(*_args, **_kwargs):
        _require_mx()


def broadcast_parameters(params, root_rank=0):
    """Broadcast a gluon ``ParameterDict`` or a dict of NDArrays from
    ``root_rank`` (reference: ``mxnet/__init__.py:120``); every
    broadcast is submitted before the first is waited for."""
    _require_mx()
    if not hasattr(params, "items"):
        raise ValueError(f"invalid params of type {type(params)}")
    finishes = []
    for name, param in sorted(params.items()):
        if isinstance(param, _mx.nd.NDArray):
            tensor = param
        else:
            try:
                tensor = param.data()
            except _mx.gluon.parameter.DeferredInitializationError:
                # a shape-deferred parameter broadcasts the moment gluon
                # initializes it; skipping it would leave each rank its
                # own random values after the first forward
                _hook_deferred_broadcast(param, name, root_rank)
                continue
        finishes.append(_in_place(_eager.broadcast_async, tensor,
                                  root_rank, name=f"param.{name}"))
    for finish in finishes:
        finish()


def _hook_deferred_broadcast(param, name, root_rank):
    """Wrap ``param._init_impl`` so that a deferred parameter broadcasts
    right after gluon initializes it (reference: the post-init wrapper
    in ``mxnet/__init__.py:120``)."""
    original = param._init_impl

    def wrapped(*args, **kwargs):
        result = original(*args, **kwargs)
        param._init_impl = original   # once
        broadcast_(param.data(), root_rank, name=f"param.{name}")
        return result

    param._init_impl = wrapped
