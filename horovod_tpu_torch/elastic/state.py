"""Training state that can be committed, rolled back and replayed from
one rank (port of ``horovod_tpu/elastic/state.py``; reference:
``horovod/common/elastic.py``).

The JAX package's ``State`` holds immutable pytrees and replaces them.
A torch model and optimizer are mutable objects, so this ``State`` holds
them and moves their state in place:

- ``params``: a ``{name: tensor}`` mapping whose tensors are the live
  ones (a module's ``state_dict()``), or an ``nn.Module`` (its
  ``state_dict()`` is taken once);
- ``optimizer_state``: the optimizer (a ``torch.optim`` optimizer,
  ``DistributedOptimizer`` or a ZeRO wrapper) whose ``state_dict()`` is
  the state;
- ``step`` and ``epoch``: integer counters.

``commit()`` copies all of it onto the host and refuses the copy, with
the typed ``HvdAbortedError``, once the job has aborted; ``restore()``
copies the last commit back into the live tensors and
``load_state_dict``s the optimizer; ``sync(root_rank)`` replays
``root_rank``'s state to every rank (``broadcast_parameters``, the
layout-first ``broadcast_optimizer_state`` and ``broadcast_object`` for
the counters, under fixed names) and commits.

With ``zero_n_params`` set the optimizer's live state is this rank's
block of the flat state (``ZeroDistributedOptimizer``), so ``commit``
gathers the full state (``gather_zero_state``, a collective every rank
calls at the same step) and ``restore``/``sync`` cut the full snapshot
to the current world size's block (``reshard_zero_state``).  Below
``HVD_TPU_ZERO_MIN_SIZE`` that optimizer keeps full-size state, which
``reshard_zero_state`` cuts all the same: the reference's fault,
followed here (ROADMAP C.8).
"""

import copy

import torch

from horovod_tpu_torch.common import basics


def _host_copy(tree):
    """Deep copy of a nested state with every tensor copied to the
    host."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return copy.deepcopy(tree)


class State:
    """Training state for ``elastic.run``: ``commit`` at step boundaries
    worth rolling back to, ``restore`` to roll back, ``sync`` to replay
    one rank's state to every rank."""

    def __init__(self, params=None, optimizer_state=None, step=0, epoch=0,
                 zero_n_params=None):
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        self.params = params
        self.optimizer_state = optimizer_state
        self.step = int(step)
        self.epoch = int(epoch)   # the user's epoch counter
        self.zero_n_params = (None if zero_n_params is None
                              else int(zero_n_params))
        self._committed = None
        self._opt_full = False   # the committed optimizer state is full
        self._ckpt = None        # checkpoint.CheckpointManager
        # the constructor's snapshot is local (no collectives); the first
        # commit() in the loop, or run()'s first sync(), makes the
        # recoverable one
        self.commit(_local=True)

    def commit(self, _local=False):
        """Snapshot the state onto the host.  With ``zero_n_params`` set
        this is a collective (the optimizer's blocks are gathered), so
        every rank commits at the same step.  Raises ``HvdAbortedError``,
        keeping the last snapshot, once the job has aborted."""
        params = _host_copy(self.params)
        opt, full = None, False
        if self.optimizer_state is not None:
            live = self.optimizer_state.state_dict()
            if self.zero_n_params is not None and not _local:
                from horovod_tpu_torch.sharding.zero import gather_zero_state

                live = gather_zero_state(live, self.zero_n_params,
                                         name_prefix="elastic.zero.gather")
                full = True
            opt = _host_copy(live)
        # on the card a step's update waits on the stream for its
        # gradient allreduces; one that a dead peer left hanging returns
        # only when the abort aborts the communicator, after the abort is
        # recorded, and the update it releases may be partly reduced.
        # The host copy above waited for that update: refuse it
        basics.raise_if_aborted()
        self._committed = (params, opt, self.step, self.epoch)
        self._opt_full = full
        # durable checkpointing writes the same snapshot from its own
        # thread; the constructor's local snapshot is not recoverable
        if self._ckpt is not None and not _local:
            self._ckpt.maybe_save(self)

    def attach_checkpoint(self, manager):
        """Wire a ``checkpoint.CheckpointManager`` into ``commit`` (what
        ``elastic.run`` does when ``HVD_TPU_CKPT_DIR`` is set).  -> the
        previous manager, if any."""
        prev, self._ckpt = self._ckpt, manager
        return prev

    def _load_optimizer(self, committed, full):
        state = copy.deepcopy(committed)
        if full:
            from horovod_tpu_torch.sharding.zero import reshard_zero_state

            state = reshard_zero_state(state, self.zero_n_params)
        self.optimizer_state.load_state_dict(state)

    def restore(self):
        """Roll the live state back to the last commit."""
        params, opt, step, epoch = self._committed
        if params is not None:
            with torch.no_grad():
                for name, value in params.items():
                    self.params[name].copy_(value)
        if opt is not None:
            self._load_optimizer(opt, self._opt_full)
        self.step = step
        self.epoch = epoch

    def sync(self, root_rank=0):
        """Replay ``root_rank``'s state to every rank, then commit."""
        from horovod_tpu_torch.common.objects import broadcast_object
        from horovod_tpu_torch.optimizer import (broadcast_optimizer_state,
                                                 broadcast_parameters)

        if self.params is not None:
            broadcast_parameters(self.params, root_rank=root_rank)
        if self.optimizer_state is not None:
            if self.zero_n_params is not None:
                # block shapes differ between ranks, so the root's full
                # committed state travels as one object; every rank takes
                # part, and the root's form rides along
                is_full, full = broadcast_object(
                    (self._opt_full, self._committed[1]),
                    root_rank=root_rank, name="elastic.sync.zero_opt")
                if is_full:
                    self._load_optimizer(full, True)
                # else the root has not committed past its fresh state,
                # which every rank derives alike: keep the local one
            else:
                broadcast_optimizer_state(self.optimizer_state,
                                          root_rank=root_rank)
        self.step, self.epoch = broadcast_object(
            (self.step, self.epoch), root_rank=root_rank,
            name="elastic.sync.counters")
        self.commit()

    def __repr__(self):
        return (f"State(step={self.step}, epoch={self.epoch}, "
                f"params={'set' if self.params is not None else 'None'}, "
                f"optimizer_state="
                f"{'set' if self.optimizer_state is not None else 'None'})")
