"""The sequence axis of the parallel modules: what ``_compat.py`` and
``jax.lax`` give the JAX package's ring, zigzag and Ulysses attention.

The axis is a process group: ``group=None`` is the ``sp`` group of the
one-axis grid over the world that ``hvd.init()`` makes; a mesh or a grid
gives its ``sp`` axis group; a ``ProcessGroup`` (``hvd.new_group``,
``grid.group(axis)``) or a ``torch.distributed`` group is taken as it
is.  ``axis_size`` and ``axis_index`` are its size and this rank's place
in it.  Two differentiable collectives:

- :func:`ring_permute` is ``lax.ppermute`` with ``perm = [(i, (i + 1) %
  P)]``: every tensor goes to the next rank and comes from the previous
  one, in one ``batch_isend_irecv`` that every rank of the group joins.
  Its backward is the reverse permutation, as JAX transposes
  ``ppermute``.
- :func:`all_to_all_4d` is ``lax.all_to_all(..., tiled=True)``: ``x`` cut
  into P parts along ``split_axis``, part ``j`` sent to rank ``j``, the
  parts received concatenated along ``concat_axis`` in rank order.  Its
  backward is the inverse all-to-all.

Order of operations: the sequence group is a communicator of its own.
Its transfers run inside the backward pass beside
``DistributedOptimizer``'s hooks, which start their allreduces on the
default group, and a causal ring builds a different graph on every rank
(rank 0 attends one block, rank P - 1 all of them): on one communicator
the autograd engine could interleave the two in a different order on
each rank and NCCL would deadlock.  Two communicators take that hazard
down, not away: each one's operations come in the same order on every
rank, yet the two may interleave differently from rank to rank, and
NCCL promises progress only for one order across all of a rank's
communicators.  What shows them finishing is a run, ``chip_smoke.py``
phase 9's causal ring training under ``DistributedOptimizer`` on four
cards (and phase 10's for the tp, ep and pp groups, whose hops and
allreduces meet ``DistributedOptimizer(group=dp)`` the same way);
holding the buckets until the backward ends would remove the hazard.  Within the sequence group every rank launches the same
transfers in the same order: the permutations of
one attention call form a chain, each one's backward waiting for the
next one's, and :func:`anchor` ties the chain's last output to the
result so that every rank runs each backward permutation, also where
its own queries attended none of the blocks it carried.  Each transfer
first waits for the eager plane to issue what this rank submitted to it
(``Controller.drain``, ROADMAP C.7).

After a coordinated abort, whose communicator abort ends a transfer that
a dead peer left hanging, every transfer here raises the typed
``HvdAbortedError`` (``basics.abortable``) in place of the backend's
own error.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch import groups
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.optimizer import _after_eager_plane


def axis_group(group, axis):
    """The ``torch.distributed`` group for a ``group=`` argument: a
    ``ProcessGroup``'s, the ``axis`` group of a mesh or grid, or a
    ``torch.distributed`` group as it is."""
    if isinstance(group, groups.Grid) or hasattr(group, "axis_names"):
        group = group.group(axis)
    if isinstance(group, groups.ProcessGroup):
        return groups.torch_group(group)
    return group


def sequence_group(group=None):
    if group is None:
        group = basics._get_state().sequence_group
    return axis_group(group, "sp")


def axis_size(group=None):
    return dist.get_world_size(sequence_group(group))


def axis_index(group=None):
    return dist.get_rank(sequence_group(group))


def _permute(tensors, group, shift):
    """Each tensor to rank ``r + shift`` of the group, from ``r - shift``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = []
    for t, out in zip(sends, outs):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    _after_eager_plane()
    with basics.abortable():
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_permute(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_permute(grads, ctx.group, -1))


def ring_permute(*tensors, group=None):
    """``tensors`` from rank ``i`` to rank ``(i + 1) % P`` of the sequence
    axis (all in one batch); -> the tensors received from rank ``i - 1``,
    a tuple.  Differentiable."""
    return _RingPermute.apply(sequence_group(group), *tensors)


class _Anchor(torch.autograd.Function):
    """``x`` itself; its backward also reaches ``others`` (with zero
    gradients), so the nodes that made them run on every rank."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.n = len(others)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *([None] * ctx.n))


def anchor(x, *others):
    return _Anchor.apply(x, *others)


def _all_to_all(x, group, split_axis, concat_axis):
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of shape "
                         f"{tuple(x.shape)} does not split into {n} parts")
    # a stack of one strided part keeps its strides
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    _after_eager_plane()
    with basics.abortable():
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, \
            None


def all_to_all_4d(x, split_axis, concat_axis, group=None):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over the sequence axis.  Differentiable."""
    return _AllToAll.apply(x, sequence_group(group), split_axis, concat_axis)
