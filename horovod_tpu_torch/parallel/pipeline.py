"""Pipeline parallelism: the GPipe microbatch schedule (port of
``horovod_tpu/parallel/pipeline.py``).

Each rank of the pipeline group is one stage.  ``M`` microbatches go
through ``S`` stages in ``M + S - 1`` ticks: at tick ``t`` stage ``i``
runs microbatch ``t - i`` when there is one (the others are bubble
ticks, which skip ``stage_fn``), then every stage hands its activation
to the next in one ring hop (``parallel/_comm.py``'s ``_RingPermute``,
the JAX package's ``ppermute``).  The last stage retires microbatch ``t -
(S - 1)`` at tick ``t``, and a masked sum over the group gives every
stage the outputs, as the reference's ``psum``.

Gradient scale: the outputs are the same on every stage, and so is what
the caller computes from them, so the masked sum's backward passes each
rank's gradient on unsummed (an allreduce there, the transpose of
``psum``, would make the last stage's gradients ``S`` times too large).
The microbatches are replicated too, and only stage 0 reads them: their
gradient is summed over the group, so that every stage gets stage 0's.
Every rank runs every hop's backward, in the same order, and the
microbatches' sum last: the first hop's input takes a gradient on every
rank and is tied to the microbatches, each stage's input depends on the
previous hop's output (stage 0 ties it to its feed with ``anchor``), and
the last hop's output is tied to the result.
"""

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from horovod_tpu_torch.parallel._comm import _RingPermute, anchor, axis_group
from horovod_tpu_torch.parallel.tensor_parallel import copy_to, reduce_from


def pipeline_apply(stage_fn, stage_params, microbatches, *, group=None):
    """Push ``M`` microbatches through the pipeline; every rank of
    ``group`` (a ``ProcessGroup``, a mesh or grid's ``pp`` axis, or a
    ``torch.distributed`` group; None: the world) calls it.

    stage_fn: ``(params_for_this_stage, x) -> y`` with ``y.shape ==
        x.shape``.
    stage_params: this rank's stage (a tensor or a pytree of them, or
        modules); a leading dimension of size 1 is squeezed, as the
        reference squeezes its shard's stage dimension.
    microbatches: ``[M, mb, ...]``, the same on every rank.

    Returns the ``[M, mb, ...]`` outputs on every rank.
    """
    tg = dist.group.WORLD if group is None else axis_group(group, "pp")
    s, idx = dist.get_world_size(tg), dist.get_rank(tg)
    m = microbatches.shape[0]
    params = tree_map(
        lambda a: a[0] if torch.is_tensor(a) and a.dim() and a.shape[0] == 1
        else a, stage_params)
    microbatches = copy_to(microbatches, tg)
    # the first hop's input: a leaf that takes a gradient, so that every
    # hop is in every rank's graph (also where a stage's first ticks are
    # bubbles), tied to the microbatches, so that every rank sums their
    # gradient over the group, and after the hops' backward
    state = anchor(torch.zeros_like(microbatches[0]).requires_grad_(),
                   microbatches)
    outs = []
    for t in range(m + s - 1):
        if idx == 0 and t < m:
            state = anchor(microbatches[t], state)
        y = stage_fn(params, state) if 0 <= t - idx < m else state
        if idx == s - 1 and t >= s - 1:
            outs.append(y)
        # one stage hands its output to itself
        state = _RingPermute.apply(tg, y)[0] if s > 1 else y
    out = torch.stack(outs) if idx == s - 1 \
        else torch.zeros_like(microbatches)
    return anchor(reduce_from(out, tg), state)


def pipelined(stage_fn, mesh, *, axis_name="pp"):
    """Wrap ``stage_fn`` into a pipeline over ``mesh``'s ``axis_name``.

    Returns ``fn(stacked_params, microbatches)``: ``stacked_params``
    tensors have a leading stage dimension of the axis' size, and this
    rank runs its coordinate's stage (its gradient lands in that row);
    ``microbatches`` is ``[M, mb, ...]``, the same on every rank.
    ``mesh`` may be a mesh or an ``hvd.grid(...)`` Grid.
    """
    from horovod_tpu_torch.parallel.mesh import as_mesh

    mesh = as_mesh(mesh)
    group = mesh.group(axis_name)

    def run(stacked_params, microbatches):
        idx = group.rank()
        return pipeline_apply(
            stage_fn, tree_map(lambda a: a[idx:idx + 1], stacked_params),
            microbatches, group=group)

    return run
