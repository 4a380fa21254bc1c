"""ZeRO-1 sharded weight update on both data planes (port of
``horovod_tpu/sharding/zero.py``).

Instead of every rank reducing the full gradient and holding the full
optimizer state (arXiv:2004.13336):

1. the flat gradient is **reduce-scattered**: each rank receives its 1/N
   block, already reduced;
2. the inner optimizer steps on that block only, so its state is 1/N a
   rank (AdamW on P parameters holds 2P/N here);
3. the updated block is **allgathered** and copied back into the model.

The reduce-scatter moves half of an allreduce's bytes, but the allgather
adds the other half back: the exchange is no cheaper than the ring
allreduce, only the optimizer's state and arithmetic shrink.

Two bindings, each a wrapper around a torch optimizer over the model's
parameters, as ``DistributedOptimizer`` is.  Each rebuilds the inner
optimizer (same class, same hyperparameters) on one fp32 flat shard
tensor, so its state holds that shard only; ``step()`` copies the
gathered parameters back into the model.  Torch's in-place update
``p -= lr * ...`` is optax's ``params + updates`` element for element.

- :func:`ShardedDistributedOptimizer`: the counterpart of the in-graph
  binding.  One ``reduce_scatter_tensor`` and one
  ``all_gather_into_tensor`` on the default process group, the flat
  vector zero-padded to ``n * chunk`` (``chunk`` rounded up to whole
  256-blocks under int8, whose reduce-scatter is
  ``common/compression.py``'s quantized one).
- :func:`ZeroDistributedOptimizer`: the eager binding.  Its
  reduce-scatter and allgather are the eager plane's named collectives
  (``zero.reduce_scatter``, and the variable-dim0 ``zero.allgather``:
  no padding, the first ``n % world`` ranks hold one element more).
  Below ``min_size`` parameters (``HVD_TPU_ZERO_MIN_SIZE``), or at one
  rank, the update stays replicated behind one ``zero.allreduce``.
  ``group=`` (the data-parallel group of a grid) scopes the layout and
  both collectives to the group's members (reference:
  ``horovod_tpu/sharding/zero.py:172-264``).

Gradients are flattened over every parameter of the optimizer, as the
reference flattens the whole tree; a parameter without a gradient takes
part with zeros.  Not ported: ``sharded_state_wrap`` and
``sharded_state_unwrap``, which add and remove the per-rank axis of the
state at a ``shard_map`` boundary that a torch process never crosses.
"""

import inspect

import torch
import torch.distributed as dist

from horovod_tpu_torch import groups
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.compression import (
    Compression, all_gather_into, quantized_reduce_scatter,
    reduce_scatter_into)
from horovod_tpu_torch.common.ops_enum import (Adasum, Average, ReduceOp,
                                               reduce_scatter_split_sizes)
from horovod_tpu_torch.optimizer import _after_eager_plane


# --------------------------------------------------------------- shard layout
def shard_chunk_size(n_params, axis_size):
    """Per-rank flat-shard length of :func:`ShardedDistributedOptimizer`
    (ceil-divided, so the last shard is zero-padded)."""
    return -(-n_params // axis_size)


def zero_shard_layout(n_params, world_size, rank):
    """``(counts, offset, count)`` of the eager layout: the
    ``np.array_split`` partition of ``reduce_scatter`` (no padding, the
    first ``n_params % world_size`` ranks take one element more)."""
    counts = reduce_scatter_split_sizes(n_params, world_size)
    offset = sum(counts[:rank])
    return counts, offset, counts[rank]


def flat_shard(flat, world_size, rank):
    """``rank``'s block of a flat vector under the eager layout."""
    _, off, cnt = zero_shard_layout(len(flat), world_size, rank)
    return flat[off:off + cnt]


def _resolve_min_size(min_size):
    """Explicit argument, else ``HVD_TPU_ZERO_MIN_SIZE`` as ``hvd.init``
    read it.  Every rank sees the same flat size and setting, so all take
    the same branch."""
    if min_size is not None:
        return int(min_size)
    return basics._get_state().zero_min_size


# ------------------------------------------------------------------ wrapper
class _ZeroOptimizer:
    """The inner optimizer rebuilt on one fp32 flat shard; subclasses
    supply the topology (:meth:`_topo`), the layout and the exchange
    (:meth:`_update`).  When the topology changes (an elastic
    reconfiguration), the shard and the inner optimizer are made again
    for the new block before the next step or state load
    (:meth:`_follow_topology`); ``elastic.State.restore`` then loads the
    state resharded for it."""

    def __init__(self, optimizer, op, what):
        op = ReduceOp(op)
        if op == Adasum:
            raise ValueError(
                f"{what} does not support Adasum; use "
                f"DistributedOptimizer(op=Adasum)")
        groups = optimizer.param_groups
        hyper = {k: v for k, v in groups[0].items() if k != "params"}
        for g in groups[1:]:
            if {k: v for k, v in g.items() if k != "params"} != hyper:
                raise ValueError(
                    f"{what} takes one set of hyperparameters: the "
                    f"reference flattens every parameter under one "
                    f"transformation, and these parameter groups differ")
        self.op = op
        self.params = [p for g in groups for p in g["params"]]
        self.n_params = sum(p.numel() for p in self.params)
        self.device = self.params[0].device
        self.rank, self.world = self._topo()
        self._make_inner(type(optimizer), hyper)

    def _make_inner(self, cls, hyper):
        self._start, cnt = self._layout()
        self.shard = torch.zeros(cnt, dtype=torch.float32,
                                 device=self.device)
        takes = inspect.signature(cls.__init__).parameters
        self.inner = cls([self.shard], **{k: v for k, v in hyper.items()
                                          if k in takes})
        self.inner.param_groups[0].update(hyper)

    def _follow_topology(self):
        topo = self._topo()
        if topo != (self.rank, self.world):
            self.rank, self.world = topo
            hyper = {k: v for k, v in self.inner.param_groups[0].items()
                     if k != "params"}
            self._make_inner(type(self.inner), hyper)

    # -- what a torch optimizer offers
    @property
    def state(self):
        return self.inner.state

    def state_dict(self):
        self._follow_topology()
        return self.inner.state_dict()

    def load_state_dict(self, state_dict):
        self._follow_topology()
        self.inner.load_state_dict(state_dict)

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.detach_().zero_()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._follow_topology()
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 .reshape(-1).float() for p in self.params]
        pad = self._padded_size() - self.n_params
        if pad:
            grads.append(grads[0].new_zeros(pad))
        flat_g = torch.cat(grads)
        del grads
        self._copy_params_into_shard()
        full = self._update(flat_g)
        offset = 0
        for p in self.params:
            p.copy_(full[offset:offset + p.numel()].view(p.shape))
            offset += p.numel()
        return loss

    def _copy_params_into_shard(self):
        """This rank's block of the flattened parameters, zeros past their
        end."""
        self.shard.zero_()
        lo, hi, offset = self._start, self._start + self.shard.numel(), 0
        for p in self.params:
            a, b = max(lo, offset), min(hi, offset + p.numel())
            if a < b:
                self.shard[a - lo:b - lo] = p.reshape(-1)[a - offset:
                                                          b - offset]
            offset += p.numel()

    def _step_inner(self, grad):
        self.shard.grad = grad
        self.inner.step()
        self.shard.grad = None


class _Sharded(_ZeroOptimizer):
    def __init__(self, optimizer, op, compression):
        self.compression = compression
        self.quantized = getattr(compression, "block_quantized", False)
        super().__init__(optimizer, op, "ShardedDistributedOptimizer")

    def _topo(self):
        return dist.get_rank(), dist.get_world_size()

    def _layout(self):
        chunk = shard_chunk_size(self.n_params, self.world)
        if self.quantized:
            # the quantized reduce-scatter's chunks land on whole scale
            # blocks (reference ``_layout``, zero.py:96-108)
            block = self.compression.block
            chunk = -(-chunk // block) * block
        self.chunk = chunk
        return self.rank * chunk, chunk

    def _padded_size(self):
        return self.world * self.chunk

    def _update(self, flat_g):
        n, chunk = self.world, self.chunk
        if self.quantized:
            _after_eager_plane()
            g_shard = quantized_reduce_scatter(flat_g.view(n, chunk))
        else:
            compressed, ctx = self.compression.compress(flat_g)
            g_shard = compressed.new_empty(chunk)
            _after_eager_plane()
            reduce_scatter_into(g_shard, compressed, op=dist.ReduceOp.SUM)
            g_shard = self.compression.decompress(g_shard, ctx).float()
        del flat_g
        if self.op == Average:
            g_shard = g_shard / n
        self._step_inner(g_shard)
        full = self.shard.new_empty(n * chunk)
        _after_eager_plane()
        all_gather_into(full, self.shard)
        return full


def _topology(group):
    """(rank, size) over ``group``'s members, or the world's.  Anything
    but a ``ProcessGroup`` raises ``groups.resolve``'s error."""
    if groups.resolve(group)[0]:
        return group.rank(), group.size
    return basics.rank(), basics.size()


class _Eager(_ZeroOptimizer):
    def __init__(self, optimizer, op, compression, min_size, group):
        self.compression = compression   # None: the job's default
        self.group = group
        self.min_size = _resolve_min_size(min_size)
        super().__init__(optimizer, op, "ZeroDistributedOptimizer")

    def _topo(self):
        return _topology(self.group)

    @property
    def sharded(self):
        return self.world > 1 and self.n_params >= self.min_size

    def _layout(self):
        if not self.sharded:
            return 0, self.n_params
        _, off, cnt = zero_shard_layout(self.n_params, self.world,
                                        self.rank)
        return off, cnt

    def _padded_size(self):
        return self.n_params

    def _update(self, flat_g):
        from horovod_tpu_torch import mpi_ops

        if not self.sharded:
            if self.world > 1:
                flat_g = mpi_ops.allreduce(
                    flat_g, op=self.op, name="zero.allreduce",
                    compression=self.compression, group=self.group)
            self._step_inner(flat_g)
            return self.shard
        g_block = mpi_ops.reduce_scatter(
            flat_g, op=self.op, name="zero.reduce_scatter",
            compression=self.compression, group=self.group)
        self._step_inner(g_block)
        return mpi_ops.allgather(self.shard, name="zero.allgather",
                                 group=self.group)


def ShardedDistributedOptimizer(optimizer, op=Average,
                                compression=Compression.none):
    """ZeRO-1 on the default process group: one reduce-scatter of the
    flat gradient (zero-padded to ``world * chunk``), the inner optimizer
    on this rank's chunk, one allgather.  Average divides after the sum;
    Adasum is refused (its combination needs full vectors).  Call
    ``hvd.init()`` first."""
    basics._get_state()
    return _Sharded(optimizer, op, compression)


def ZeroDistributedOptimizer(optimizer, op=Average, compression=None,
                             min_size=None, group=None):
    """ZeRO-1 through the eager plane's named ``reduce_scatter`` and
    ``allgather``.  ``compression`` (``None``: ``HVD_TPU_COMPRESSION``) is
    the gradient reduce-scatter's wire format; parameters are gathered at
    full precision.  Below ``min_size`` flat parameters (default
    ``HVD_TPU_ZERO_MIN_SIZE``), or at one rank, the update stays
    replicated.  ``group`` (a ``ProcessGroup``, the data-parallel group of
    a grid) scopes the shard layout, the reduce-scatter and the allgather
    to its members."""
    return _Eager(optimizer, op, compression, min_size, group)


# ------------------------------------------------- checkpoint / resharding
def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def gather_zero_state(state, n_params, name_prefix="zero.state_gather",
                      group=None):
    """The full optimizer state from every rank's block: each 1-D tensor
    of ``state`` (an inner optimizer's ``state_dict()``) whose length is
    this rank's block is allgathered through the eager plane, named by its
    path so that every rank pairs them; step counters and full-size
    tensors stay as they are.  The result is the same on every rank (of
    ``group``, when one is given)."""
    from horovod_tpu_torch import mpi_ops

    rank, world = _topology(group)
    n_params = int(n_params)
    if world <= 1:
        return state
    _, _, cnt = zero_shard_layout(n_params, world, rank)

    def gather(path, leaf):
        if (torch.is_tensor(leaf) and leaf.dim() == 1
                and leaf.shape[0] == cnt and cnt != n_params):
            name = ".".join([name_prefix] + [str(k) for k in path])
            return mpi_ops.allgather(leaf, name=name, group=group)
        return leaf

    return _tree_map(gather, state)


def reshard_zero_state(full_state, n_params, group=None):
    """Inverse of :func:`gather_zero_state` at the current world size
    (which may differ from the one it was gathered at): each full-size
    1-D tensor is cut to this rank's block (its block over ``group``'s
    members, when one is given)."""
    rank, world = _topology(group)
    n_params = int(n_params)
    if world <= 1:
        return full_state
    _, off, cnt = zero_shard_layout(n_params, world, rank)

    def reshard(path, leaf):
        if (torch.is_tensor(leaf) and leaf.dim() == 1
                and leaf.shape[0] == n_params):
            return leaf[off:off + cnt].clone()
        return leaf

    return _tree_map(reshard, full_state)
