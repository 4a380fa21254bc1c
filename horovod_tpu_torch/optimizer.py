"""Data-parallel training API on ``torch.distributed`` (port of
``horovod_tpu/jax_api.py:51-191``).

``DistributedOptimizer`` wraps a torch optimizer so that ``step()``
consumes gradients averaged over every rank.  As in Horovod's torch
binding (``horovod_tpu/torch/optimizer.py:22-70``) it registers one hook
per parameter; a hook fires when that parameter's gradient is complete,
and once every parameter of a fusion bucket is ready the bucket's
allreduce starts asynchronously, overlapping the rest of the backward
pass.  Buckets are planned once by :func:`common.fusion.plan_buckets`
over the parameters in reverse registration order (the order in which
backward tends to finish them) up to ``HVD_FUSION_THRESHOLD`` bytes, and
they are launched strictly in plan order, so every rank issues the same
collectives in the same order.

gloo has no average, so every reduction is a SUM followed by a division
by the world size.

``Compression.int8`` quantizes each float gradient of at least 256
elements on its own, as ``jax_api.allreduce_gradients`` does (its
``quantized_allreduce`` per leaf), and reduces smaller and non-float
gradients exactly.  A bucket of quantized gradients lays each one out as
the reference would, padded to ``[n, chunk_i]`` with ``chunk_i`` a whole
number of 256-blocks, and concatenates them along dim 1: the blocks and
the rank each chunk goes to are the per-gradient ones, so one
``all_to_all`` and one ``all_gather`` per bucket give every gradient's
per-gradient result bit for bit.  The average is taken after the fp32
sum.  ``compression=None`` is the job's default (``HVD_TPU_COMPRESSION``).

``group=`` (a ``ProcessGroup``, e.g. ``grid.group("dp")``) reduces over
that group's members on its ``torch.distributed`` group
(``groups.torch_group``) instead of the world.  It is no new feature of
the optimizer but the port's counterpart of the ``psum`` over ``dp``
that GSPMD inserts in the JAX package's tensor- and expert-parallel step
(``examples/transformer_lm.py``): there the gradient of a tp or ep shard
is summed over the ranks that hold the same shard, never over the tp or
ep axis.  Averaged over the world instead, a tp rank would mix its shard
with the other tp ranks' different shards.

Every collective here first waits for the eager plane to issue what this
rank submitted to it (:meth:`ops.controller.Controller.drain`): the two
use different communicators, and NCCL can deadlock when ranks launch the
operations of two communicators in different orders.

Faults: each bucket's start is a hit of the fault point ``allreduce``
(``common/faults.py``), as the reference's buckets, which its plane
negotiates, are.  Once the job has aborted (``common/basics.py``), every
collective here, a bucket's start and its ``wait()`` included, raises
the typed ``HvdAbortedError`` with the coordinator's origin and reason
in place of the backend's own error.  The buckets stay asynchronous on
the card, as before, so a step that the abort lands in can return and
queue an update behind a collective that a dead peer left hanging; the
abort releases that collective, partly reduced, and the update applies
it.  A typed error out of a bucket's start or wait also forgets the
step it cut short (its launched buckets and its hook counts), so that
under ``elastic.run`` the retried step starts clean, and each bucket
resolves ``group=``'s ``torch.distributed`` group when it starts, the
one an elastic reconfiguration made anew.  Such parameters never leave the device as a good state:
``elastic.State.commit()`` checks for the abort after its host copy,
which waits for the update, and refuses the snapshot (and with it the
durable checkpoint); the next call here raises.  A host wait in
``synchronize()``, the reference's place for it, cost about 2 ms of a
45 ms step at four H100s (PERF.md), so it is not made.

Timeline (``HVD_TIMELINE``, ``utils/timeline.py``): the buckets bypass
the eager plane, so each writes its own ``ALLREDUCE`` span, on a row
named after the bucket (``DistributedOptimizer.bucket.<b>``,
``allreduce_gradients.bucket.<b>``), from its ``start()`` to the moment
its collective completes on the card: the timeline's completion thread
polls the work (an int8 bucket's span ends at an event after its gather
in ``wait()``).  With the timeline off a bucket checks one attribute and
records nothing.

Adasum (``op=Adasum``, ``ops/adasum.py``) takes two forms, the
reference's:

- ``allreduce_gradients(grads, op=Adasum)`` is ``jax_api``'s
  ``adasum_reduce_pytree``: each gradient on its own is compressed,
  all-gathered over the group and reduced along the pairing tree, then
  decompressed.  ``Compression.int8`` is its compressor's local round
  trip there (quantize and dequantize), as the reference's pytree reduce
  does (``common/compression.py:160-175``).
- ``DistributedOptimizer(opt, op=Adasum)`` is the torch binding's
  ``_DistributedAdasumOptimizer`` (``horovod_tpu/torch/optimizer.py:
  142-176``): no gradient hooks; ``step()`` applies the wrapped
  optimizer locally, Adasum-reduces each parameter's change through the
  eager plane (``adasum.<name>``) and writes the start plus the reduced
  change.  Every parameter that requires a gradient takes part (a zero
  change where it has none), so that every rank submits every name.  All
  of its collectives run on the plane: it has no second communicator.
"""

import contextlib
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch import groups, mpi_ops
from horovod_tpu_torch.common import basics, faults
from horovod_tpu_torch.common.handles import HvdError
from horovod_tpu_torch.common.compression import (
    Compression, accumulate_int8, all_gather_into, compressor_for,
    int8_chunk, is_quantized, quantize_int8_blocks, quantized_all_gather)
from horovod_tpu_torch.common.fusion import plan_buckets
from horovod_tpu_torch.common.objects import broadcast_object
from horovod_tpu_torch.common.ops_enum import Adasum, Average, ReduceOp
from horovod_tpu_torch.ops.adasum import adasum_reduce_stacked
from horovod_tpu_torch.utils import env as env_util


def _fusion_threshold():
    return env_util.get_int(env_util.HVD_FUSION_THRESHOLD,
                            env_util.DEFAULT_FUSION_THRESHOLD)


def _after_eager_plane():
    basics._get_state().controller.drain()


def _compressor(compression):
    """``None`` -> the job's default compressor."""
    if compression is None:
        return compressor_for(basics._get_state().compression)
    return compression


def _quantizes(tensor, compression):
    return getattr(compression, "block_quantized", False) \
        and is_quantized(tensor)


class _Bucket:
    """Tensors reduced as one flat buffer over ``group`` (a
    ``torch.distributed`` group; None: the default group); ``name``: its
    timeline row."""

    def __init__(self, tensors, op, compression, group=None, name=None):
        self.tensors = tensors
        self.op = op
        self.compression = compression
        self.group = group
        self.name = name
        self.timeline = basics.timeline()
        self.work = None
        self.flat = None
        self.ctxs = None
        self.dropped = False

    def start(self):
        if faults.check("allreduce"):
            self.dropped = True   # this rank silently never contributes
            return
        tl = self.timeline
        begin = tl.now() if tl is not None else None
        compressed = []
        self.ctxs = []
        for t in self.tensors:
            c, ctx = self.compression.compress(t)
            compressed.append(c.reshape(-1))
            self.ctxs.append(ctx)
        self.flat = torch.cat(compressed)
        _after_eager_plane()
        with basics.abortable():
            self.work = dist.all_reduce(self.flat, op=dist.ReduceOp.SUM,
                                        group=self.group, async_op=True)
        if begin is not None:
            tl.span_after(self.name, "ALLREDUCE", begin, self.work,
                          {"bytes": self.flat.numel()
                           * self.flat.element_size()})

    def wait(self):
        """-> the reduced tensors, in the order and shapes given."""
        if self.dropped:
            basics.wait_for_abort()
        with basics.abortable():
            basics.wait_work(self.work)
        basics.raise_if_aborted()
        if self.op == Average:
            self.flat.div_(dist.get_world_size(self.group))
        out, offset = [], 0
        for t, ctx in zip(self.tensors, self.ctxs):
            piece = self.flat[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()
            out.append(self.compression.decompress(piece, ctx))
        self.work = self.flat = self.ctxs = None
        return out


class _QuantizedBucket:
    """Float tensors of at least one block each, reduced through int8 as
    ``quantized_allreduce`` reduces each of them (see the module
    docstring): the ``all_to_all`` of the quantized contributions starts
    in :meth:`start`; :meth:`wait` accumulates, requantizes and gathers."""

    def __init__(self, tensors, op, group=None, name=None):
        self.tensors = tensors
        self.op = op
        self.group = group
        self.name = name
        self.timeline = basics.timeline()
        self.begin = None
        self.n = dist.get_world_size(group)
        self.chunks = [int8_chunk(t.numel(), self.n) for t in tensors]
        self.works = self.recv = None
        self.dropped = False

    def start(self):
        if faults.check("allreduce"):
            self.dropped = True
            return
        if self.timeline is not None:
            self.begin = self.timeline.now()
        rows = [F.pad(t.reshape(-1).float(), (0, self.n * c - t.numel()))
                .view(self.n, c) for t, c in zip(self.tensors, self.chunks)]
        q, s = quantize_int8_blocks(torch.cat(rows, dim=1))
        self.recv = (torch.empty_like(q), torch.empty_like(s))
        _after_eager_plane()
        with basics.abortable():
            self.works = [dist.all_to_all_single(out, src, group=self.group,
                                                 async_op=True)
                          for out, src in zip(self.recv, (q, s))]

    def wait(self):
        if self.dropped:
            basics.wait_for_abort()
        with basics.abortable():
            for work in self.works:
                basics.wait_work(work)
        red = accumulate_int8(*self.recv)
        _after_eager_plane()
        with basics.abortable():
            full = quantized_all_gather(red, self.group).view(self.n, -1)
        if self.begin is not None:
            done = None
            if full.device.type == "cuda":
                done = torch.cuda.Event(blocking=True)
                done.record()
            self.timeline.span_after(self.name, "ALLREDUCE", self.begin,
                                     done, {"bytes": full.numel() * 4})
        out, offset = [], 0
        for t, c in zip(self.tensors, self.chunks):
            red = full[:, offset:offset + c].reshape(-1)[:t.numel()]
            offset += c
            if self.op == Average:
                red = red / self.n
            out.append(red.to(t.dtype).view(t.shape))
        self.works = self.recv = None
        return out


def _new_bucket(tensors, op, compression, group=None, name=None):
    if _quantizes(tensors[0], compression):
        return _QuantizedBucket(tensors, op, group, name)
    if getattr(compression, "block_quantized", False):
        compression = Compression.none   # below one block, or not float
    return _Bucket(tensors, op, compression, group, name)


def _plan(tensors, compression, threshold):
    """Bucket indices into ``tensors``: consecutive runs that share a
    device and wire format."""
    def wire_dtype(i):
        t = tensors[i]
        if _quantizes(t, compression):
            return (t.device, "int8")
        return (t.device, compression.compress(t[:0])[0].dtype)

    return list(plan_buckets(
        range(len(tensors)), key_fn=wire_dtype,
        nbytes_fn=lambda i: tensors[i].numel() * tensors[i].element_size(),
        threshold=threshold))


def allreduce_gradients(grads, op=Average, compression=Compression.none,
                        group=None):
    """Reduce gradients across all ranks (``group``: across that
    ``ProcessGroup``'s members).  ``grads`` is a dict of tensors or a list
    of tensors; the result has the same structure, with new tensors."""
    op = ReduceOp(op)
    compression = _compressor(compression)
    tg = groups.torch_group(group)
    keys = list(grads) if isinstance(grads, dict) else None
    tensors = [grads[k] for k in keys] if keys is not None else list(grads)
    if op == Adasum:
        reduced = [_adasum_gradient(t, compression, tg) for t in tensors]
        return dict(zip(keys, reduced)) if keys is not None else reduced
    buckets = [_new_bucket([tensors[i] for i in idx], op, compression, tg,
                           f"allreduce_gradients.bucket.{b}")
               for b, idx in enumerate(
                   _plan(tensors, compression, _fusion_threshold()))]
    for b in buckets:
        b.start()
    reduced = [t for b in buckets for t in b.wait()]
    return dict(zip(keys, reduced)) if keys is not None else reduced


def _adasum_gradient(tensor, compression, group):
    """One gradient through ``adasum_reduce_pytree``'s leaf reduce."""
    compressed, ctx = compression.compress(tensor)
    flat = compressed.reshape(-1).contiguous()
    stacked = torch.empty((dist.get_world_size(group), flat.numel()),
                          dtype=flat.dtype, device=flat.device)
    _after_eager_plane()
    with basics.abortable():
        all_gather_into(stacked.view(-1), flat, group=group)
    reduced = adasum_reduce_stacked(stacked).view(compressed.shape)
    return compression.decompress(reduced, ctx)


def _parameter_names(optimizer, named_parameters):
    """Parameter -> the name its collectives carry, the same on every
    rank."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if named_parameters is None:
        # one global index across groups, so names never collide
        return {p: f"allreduce.noname.{i}" for i, p in enumerate(params)}
    named_parameters = list(named_parameters)
    names = [k for k, _ in named_parameters]
    dups = {n for n in names if names.count(n) > 1}
    if dups:
        # duplicate names would pair the wrong tensors across ranks
        # (reference: horovod torch/__init__.py:84-90)
        raise ValueError(
            f"named_parameters contains duplicate names: {sorted(dups)}")
    named = {v: k for k, v in named_parameters}
    unnamed = [p for p in params if p not in named]
    if unnamed:
        raise ValueError(
            f"named_parameters does not name {len(unnamed)} of the "
            f"optimizer's parameters")
    return named


class _DistributedOptimizerMixin:
    def _hvd_init(self, named_parameters, compression,
                  backward_passes_per_step, op, average_aggregated_gradients,
                  group):
        self._compression = compression
        self._op = op
        groups.torch_group(group)   # a bad group= raises here
        self._hvd_group = group
        self._backward_passes_per_step = backward_passes_per_step
        self._average_aggregated_gradients = average_aggregated_gradients
        self._should_synchronize = True

        self._parameter_names = _parameter_names(self, named_parameters)
        self._requires_update = [p for g in self.param_groups
                                 for p in g["params"] if p.requires_grad]
        order = self._requires_update[::-1]
        self._buckets = [[order[i] for i in idx] for idx in _plan(
            order, compression, _fusion_threshold())]
        self._bucket_of = {p: b for b, ps in enumerate(self._buckets)
                           for p in ps}
        self._allreduce_delay = {p: backward_passes_per_step
                                 for p in self._requires_update}
        self._ready = [0] * len(self._buckets)
        self._launched = []   # _Bucket per launched bucket, in plan order
        for p in self._requires_update:
            p.register_post_accumulate_grad_hook(self._make_hook())

    def _make_hook(self):
        # a weak reference: the parameter keeps its hook in C++, where
        # the collector cannot see a cycle through it, so a hook holding
        # the optimizer would keep the optimizer, its state and its
        # parameters alive for the life of the process
        ref = weakref.ref(self)

        def hook(p):
            self = ref()
            if self is None or p not in self._allreduce_delay:
                return
            if self._allreduce_delay[p] <= 0:
                # reference: horovod torch/__init__.py asserts here —
                # continuing would overwrite the accumulated gradient
                raise AssertionError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before step() or "
                    "synchronize(); increase backward_passes_per_step "
                    "or call synchronize() between backward passes")
            self._allreduce_delay[p] -= 1
            if self._allreduce_delay[p] == 0:
                b = self._bucket_of[p]
                self._ready[b] += 1
                try:
                    self._launch_ready()
                except HvdError:
                    self._forget_step()
                    raise
        return hook

    def _forget_step(self):
        """Drop the step a typed error cut short: its launched buckets
        and its hook counts."""
        self._launched = []
        self._ready = [0] * len(self._buckets)
        for p in self._requires_update:
            self._allreduce_delay[p] = self._backward_passes_per_step

    def _launch_ready(self, force=False):
        """Start, in plan order, every bucket whose parameters are all
        ready (every remaining bucket when ``force``)."""
        while len(self._launched) < len(self._buckets):
            b = len(self._launched)
            params = self._buckets[b]
            if not force and self._ready[b] < len(params):
                return
            grads = []
            for p in params:
                if p.grad is None:
                    # a parameter whose gradient never arrived on this
                    # rank still takes part with zeros, so that every
                    # rank applies the same update
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            bucket = _new_bucket(grads, self._op, self._compression,
                                 groups.torch_group(self._hvd_group),
                                 f"DistributedOptimizer.bucket.{b}")
            bucket.start()
            self._launched.append(bucket)

    def synchronize(self):
        """Wait for every gradient allreduce and write the reduced
        gradients into ``p.grad``: divided by ``backward_passes_per_step``
        unless ``average_aggregated_gradients`` is False.  Buckets whose
        hooks did not all fire on this rank are submitted now (reference:
        the missing_p loop of horovod torch/__init__.py synchronize)."""
        passes = (self._backward_passes_per_step
                  if self._average_aggregated_gradients else 1)
        try:
            self._launch_ready(force=True)
            with torch.no_grad():
                for params, bucket in zip(self._buckets, self._launched):
                    for p, reduced in zip(params, bucket.wait()):
                        if passes > 1:
                            reduced = reduced / passes
                        p.grad.copy_(reduced)
        finally:
            self._forget_step()

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Use after an explicit ``synchronize()`` (e.g. to clip the
        averaged gradients) so that ``step()`` does not wait again."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            self.synchronize()
        # skip past the mixin in the MRO to the wrapped optimizer's step
        return super(_DistributedOptimizerMixin, self).step(closure)


class _DistributedAdasumOptimizerMixin:
    """``step()`` applies the wrapped optimizer locally, then replaces
    each parameter's change by the Adasum of the ranks' changes (see the
    module docstring)."""

    def _hvd_init(self, named_parameters, group):
        self._group = group
        self._parameter_names = _parameter_names(self, named_parameters)
        self._requires_update = [p for g in self.param_groups
                                 for p in g["params"] if p.requires_grad]

    def synchronize(self):
        """Nothing to wait for: gradients are not reduced."""

    @contextlib.contextmanager
    def skip_synchronize(self):
        yield

    def step(self, closure=None):
        params = self._requires_update
        with torch.no_grad():
            starting = [p.detach().clone() for p in params]
        loss = super(_DistributedAdasumOptimizerMixin, self).step(closure)
        with torch.no_grad():
            handles = [mpi_ops.allreduce_async(
                p.detach() - start, op=Adasum, group=self._group,
                name=f"adasum.{self._parameter_names[p]}")
                for p, start in zip(params, starting)]
            for p, start, handle in zip(params, starting, handles):
                p.copy_(start + mpi_ops.synchronize(handle).view(p.shape))
        return loss


def DistributedOptimizer(optimizer, named_parameters=None, op=Average,
                         compression=Compression.none,
                         backward_passes_per_step=1,
                         average_aggregated_gradients=True, group=None):
    """Wrap a torch optimizer so that ``step()`` applies gradients
    averaged (``op=Average``) or summed (``op=Sum``) over all ranks, or
    over the members of ``group`` (a ``ProcessGroup``: the data-parallel
    group of a grid, see the module docstring).

    ``backward_passes_per_step`` accumulates gradients locally for N
    backward passes and reduces once per N.  With
    ``average_aggregated_gradients`` (the default) the accumulated
    gradient is divided by N, as ``optax.MultiSteps`` does in the JAX
    package; without it the N passes are summed (the JAX package's
    ``optax.scale(N)`` before ``MultiSteps``, ``jax_api.py:127-133``): the
    ranks' reduction is taken over the sum of the passes.

    ``op=Adasum`` reduces each step's parameter changes instead, through
    the eager plane (see the module docstring); ``compression`` and
    ``backward_passes_per_step`` do not apply to it, as in the reference.
    Call ``hvd.init()`` first."""
    op = ReduceOp(op)
    compression = _compressor(compression)   # raises unless initialised
    adasum = op == Adasum
    mixin = (_DistributedAdasumOptimizerMixin if adasum
             else _DistributedOptimizerMixin)
    cls = type(optimizer.__class__.__name__, (mixin, optimizer.__class__),
               {})
    optimizer.__class__ = cls
    if adasum:
        optimizer._hvd_init(named_parameters, group)
    else:
        optimizer._hvd_init(named_parameters, compression,
                            backward_passes_per_step, op,
                            average_aggregated_gradients, group)
    return optimizer


def _broadcast_tensor_(t, root_rank):
    """In-place broadcast; a tensor off the collective device (an
    optimizer's CPU step counter under NCCL) travels through a copy."""
    dev = basics.device()
    _after_eager_plane()
    if t.device == dev:
        dist.broadcast(t, root_rank)
        return
    buf = t.to(dev)
    dist.broadcast(buf, root_rank)
    t.copy_(buf)


def broadcast_parameters(params, root_rank=0):
    """Broadcast parameters from ``root_rank`` to all ranks, in place.
    Accepts a ``state_dict()`` or an iterable of ``(name, tensor)``."""
    if isinstance(params, dict):
        params = sorted(params.items())
    with torch.no_grad():
        for _, p in params:
            if torch.is_tensor(p):
                _broadcast_tensor_(p, root_rank)


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Replace every rank's optimizer state and hyperparameters with the
    root's.

    The root first sends its state's layout (which parameters hold state,
    and each entry's shape and dtype, or its value when it is no tensor),
    so that every other rank allocates the tensors to receive into,
    whatever state it held before: none yet, or that of other parameters,
    as when only the root resumed from a checkpoint.  An empty root state
    leaves every rank at step 0, as an optax state from ``init`` does.

    The layout travels by the signed :func:`common.objects.broadcast_object`,
    so a receiver unpickles it only after its digest checks out with the
    job key."""
    state_dict = optimizer.state_dict()
    is_root = basics.rank() == root_rank
    layout = None
    if is_root:
        layout = (
            {pid: {key: _spec(value) for key, value in state.items()}
             for pid, state in state_dict["state"].items()},
            [{k: v for k, v in g.items() if k != "params"}
             for g in state_dict["param_groups"]])
    specs, root_groups = broadcast_object(
        layout, root_rank=root_rank, name="broadcast_optimizer_state.layout")

    state = state_dict["state"] if is_root else {
        pid: {key: _materialise(spec) for key, spec in entry.items()}
        for pid, entry in specs.items()}
    with torch.no_grad():
        for pid in sorted(specs):
            for key in sorted(specs[pid]):
                if specs[pid][key][0] == "tensor":
                    _broadcast_tensor_(state[pid][key], root_rank)
    if is_root:
        return
    for group, root_group in zip(state_dict["param_groups"], root_groups):
        group.update(root_group)
    optimizer.load_state_dict({"state": state,
                               "param_groups": state_dict["param_groups"]})


def _spec(value):
    if torch.is_tensor(value):
        return ("tensor", tuple(value.shape), value.dtype,
                value.device.type == "cpu")
    return ("value", value)


def _materialise(spec):
    if spec[0] == "value":
        return spec[1]
    _, shape, dtype, on_cpu = spec
    # load_state_dict moves each entry to its parameter's device
    return torch.empty(shape, dtype=dtype,
                       device="cpu" if on_cpu else basics.device())
