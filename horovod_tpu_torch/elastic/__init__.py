"""Elastic training state and its run loop (port of
``horovod_tpu/elastic/__init__.py``, the part that stands without the
fault-tolerant TCP runtime).

Surface::

    state = hvd.elastic.State(params=model.state_dict(),
                              optimizer_state=optimizer)
    hvd.elastic.run(train_fn, state)

:func:`run` attaches a durable checkpoint manager when
``HVD_TPU_CKPT_DIR`` is set, lets rank 0 resume from the newest complete
checkpoint, replays rank 0's state to every rank (``State.sync``), runs
``train_fn(state)``, and flushes and closes the manager at the end.

Not here: the reconfiguration loop (``reconfigure``, the
``HvdReconfigureError`` retry, ``wait_for_membership``, the graceful
drain), which rides the TCP runtime's coordinated abort
(ROADMAP A.13).  The port's membership is the world of ``hvd.init()``,
and a worker id is its rank.
"""

from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.elastic.state import State

__all__ = ["State", "run", "worker_id"]


def worker_id() -> int:
    """This process's stable identity: its rank."""
    return basics.rank()


def run(fn, state, *args, **kwargs):
    """``fn(state, *args, **kwargs)`` after rank 0's state, resumed from
    the newest complete checkpoint when one is configured, is replayed
    to every rank.  -> what ``fn`` returns."""
    manager = None
    if state._ckpt is None:
        manager = checkpoint.manager_from_env()
        if manager is not None:
            state.attach_checkpoint(manager)
            # only the sync root reads the checkpoint; the others receive
            # it through the first sync()
            if basics.rank() == 0:
                manager.restore_latest(state)
    try:
        state.sync()
        return fn(state, *args, **kwargs)
    finally:
        if manager is not None:
            state.attach_checkpoint(None)
            manager.close()
