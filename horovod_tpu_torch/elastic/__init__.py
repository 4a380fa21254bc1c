"""Elastic training: survive rank loss, re-form the world, converge (port
of ``horovod_tpu/elastic/__init__.py``).

With ``HVD_TPU_ELASTIC=1`` the coordinator (``ops/tcp_controller.py``)
rewrites a survivable failure into a membership-reconfiguration
directive, a marked abort reason that the abort's delivery hands to
every survivor.  :func:`run` catches the resulting
:class:`HvdReconfigureError`, re-forms the world at the next epoch
(``common/basics.py::_elastic_reinit``), rolls the state back to its
last commit, replays it from the new rank 0 and retries the step.

Surface::

    state = hvd.elastic.State(params=model.state_dict(),
                              optimizer_state=optimizer)
    hvd.elastic.run(train_fn, state)      # incumbents, after hvd.init()

    hvd.elastic.wait_for_membership()     # a late joiner, INSTEAD of init
    hvd.elastic.run(train_fn, state)

:func:`run` also attaches a durable checkpoint manager when
``HVD_TPU_CKPT_DIR`` is set, lets rank 0 resume from the newest complete
checkpoint before the first sync, and flushes and closes the manager at
the end, a granted drain's :data:`DRAINED` included.
"""

import logging
import time

from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.handles import (HvdAbortedError,
                                              HvdDrainedError,
                                              HvdReconfigureError)
from horovod_tpu_torch.elastic.membership import (ELASTIC_SCOPE, JOIN_SCOPE,
                                                  MEMBERSHIP_KEY,
                                                  ElasticContext,
                                                  decode_membership)
from horovod_tpu_torch.elastic.state import State
from horovod_tpu_torch.utils import env as env_util

__all__ = ["State", "run", "reconfigure", "wait_for_membership",
           "worker_id", "DRAINED", "HvdReconfigureError",
           "HvdDrainedError", "ElasticContext"]

_log = logging.getLogger("horovod_tpu_torch")


class _Drained:
    """The falsy value ``run`` returns when this rank left through a
    granted drain (not a train function's ``None``)."""

    def __repr__(self):
        return "hvd.elastic.DRAINED"

    def __bool__(self):
        return False


DRAINED = _Drained()


def worker_id() -> int:
    """This process's stable elastic identity: its launch rank,
    unchanged by reconfiguration (``hvd.rank()`` is re-keyed at every
    membership epoch)."""
    return basics.worker_id()


def reconfigure(exc: HvdReconfigureError):
    """Apply a received directive: a survivor re-forms at its epoch; a
    worker the membership left out raises the abort instead, unless it
    left on purpose (a granted drain), which tears down quietly and
    raises :class:`HvdDrainedError`.  -> the re-formation's seconds by
    part (``basics._elastic_reinit``), or None for a stale directive."""
    from horovod_tpu_torch.common import drain as drain_mod

    wid = basics.worker_id()
    if wid not in exc.members:
        if exc.drain and (wid in exc.dead or drain_mod.requested()):
            basics._drained_teardown()
            raise HvdDrainedError(wid) from exc
        raise HvdAbortedError(
            exc.origin_rank,
            f"worker {wid} evicted from elastic membership at epoch "
            f"{exc.epoch} ({exc.cause})") from exc
    return basics._elastic_reinit(exc.epoch, exc.members)


# the last reconfiguration in this process: its parts' seconds
# (reconfigure's, and restore_sync_s) and the wall-clock time at which
# its directive was caught (caught_at)
last_reconfig = {}


def run(fn, state, *args, **kwargs):
    """Drive ``fn(state, *args, **kwargs)`` elastically: sync the state
    to every member first; on each reconfiguration re-form the world,
    roll back to the last commit (the host snapshot), sync again and
    retry ``fn``.  Any other error, a fatal ``HvdAbortedError``
    included, propagates unchanged.  -> what ``fn`` returns, or
    :data:`DRAINED`."""
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
        pending_sync, t_restore = True, None
        while True:
            try:
                if pending_sync:
                    state.sync()
                    pending_sync = False
                    if t_restore is not None:
                        last_reconfig["restore_sync_s"] = \
                            time.perf_counter() - t_restore
                return fn(state, *args, **kwargs)
            except HvdReconfigureError as exc:
                caught_at = time.time()
                _log.warning(
                    "elastic: reconfiguration signal at step %s (epoch "
                    "%d, members %s); re-forming", state.step, exc.epoch,
                    exc.members)
                times = reconfigure(exc)
                last_reconfig.clear()
                last_reconfig.update(times or {}, caught_at=caught_at)
                t_restore = time.perf_counter()
                state.restore()
                pending_sync = True
    except HvdDrainedError as exc:
        _log.warning("elastic: %s; leaving run cleanly", exc)
        return DRAINED
    finally:
        if manager is not None:
            state.attach_checkpoint(None)
            manager.close()


def _rendezvous_contract():
    addr = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR)
    port = env_util.get_str(env_util.HVD_RENDEZVOUS_PORT)
    if addr is None or port is None:
        raise RuntimeError(
            "elastic join requires the rendezvous env contract "
            "(HVD_RENDEZVOUS_ADDR/PORT: launch with python -m "
            "horovod_tpu_torch.run)")
    return addr, int(port)


def wait_for_membership(timeout=None, poll_interval=0.25, device=None):
    """A late joiner's entry point, called instead of ``hvd.init()``:
    register this worker's id at the rendezvous, poll the published
    membership until an epoch admits it, then join the world at that
    epoch (``device`` as ``init``'s; catching up the state is ``run``'s
    first sync).  Admission happens only at a reconfiguration: a healthy
    job admits no one.  -> the admitted epoch."""
    from horovod_tpu_torch.run import http_client

    addr, port = _rendezvous_contract()
    wid = env_util.get_int(env_util.HVD_RANK, 0)
    if timeout is None:
        timeout = env_util.get_float(
            env_util.HVD_TPU_RECONFIG_TIMEOUT,
            env_util.DEFAULT_RECONFIG_TIMEOUT_SECONDS)
    http_client.put(addr, port, JOIN_SCOPE, str(wid), b"1")
    _log.info("elastic: worker %d registered, waiting for admission", wid)
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"worker {wid} was not admitted to any membership "
                f"within {timeout:g}s")
        try:
            blob = http_client.get(addr, port, ELASTIC_SCOPE,
                                   MEMBERSHIP_KEY, timeout=remaining)
        except KeyError:
            raise TimeoutError(
                f"worker {wid} saw no reconfiguration window within "
                f"{timeout:g}s") from None
        epoch, members = decode_membership(blob)
        if wid in members:
            basics._elastic_join_init(epoch, members, device=device)
            return epoch
        # the published membership predates this registration: wait for
        # the next window (the blob changes only at a reconfiguration)
        time.sleep(poll_interval)
