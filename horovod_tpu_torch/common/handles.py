"""Async-op handles (copy of ``horovod_tpu/common/handles.py``: the
errors, the elastic reconfiguration directive, ``Handle`` and
``HandleManager``).

The reference exposes integer handles managed by a poll/wait map
(``horovod/torch/handle_manager.{h,cc}``).  The eager plane returns
:class:`Handle` objects; ``mpi_ops`` wraps them in integers.

A handle of a collective on the card also carries ``event``, the CUDA
event its result is complete at on the plane's stream (the reference's
``ReadyEvent`` in reverse): ``ops.eager.wait`` makes the caller's
stream wait on it.
"""

import json
import threading


class HvdError(RuntimeError):
    """Raised when a collective fails (reference: Response::ERROR path)."""


class HvdAbortedError(HvdError):
    """Raised on every rank when the job performs a coordinated abort: a
    rank crashed or went silent past the liveness window, the stall
    check promoted a stalled tensor into a shutdown, or a rank called
    ``hvd.abort()``.  Every survivor raises this one typed error, naming
    the origin rank, within ``HVD_TPU_ABORT_TIMEOUT``
    (``ops/tcp_controller.py``)."""

    def __init__(self, origin_rank, reason):
        super().__init__(
            f"collective runtime aborted (origin rank {origin_rank}): "
            f"{reason}")
        self.origin_rank = origin_rank
        self.reason = reason


class HvdReconfigureError(HvdAbortedError):
    """An abort carrying an elastic membership directive: the coordinator
    decided the job survives the failure.  A subclass of
    :class:`HvdAbortedError`, so every ``except HvdAbortedError`` keeps
    working; ``elastic.run`` catches it, re-forms the world at
    ``epoch`` and retries the step."""

    def __init__(self, origin_rank, reason, *, epoch, members, dead,
                 cause="", drain=False):
        super().__init__(origin_rank, reason)
        self.epoch = epoch          # the membership epoch to move to
        self.members = list(members)  # worker ids, in new-rank order
        self.dead = list(dead)      # worker ids removed at this epoch
        self.cause = cause          # the reason before the rewrite
        self.drain = drain          # a planned departure, not a failure


class HvdDrainedError(HvdError):
    """Raised on the draining rank only, once it has left the membership
    after its preemption notice (SIGTERM).  Not an
    :class:`HvdAbortedError`: a drain is a success path, and
    ``elastic.run`` returns ``DRAINED`` on it."""

    def __init__(self, worker_id):
        super().__init__(
            f"worker {worker_id} drained after preemption notice")
        self.worker_id = worker_id


# A reconfiguration directive rides the abort's delivery (exchange
# replies, heartbeat replies) as a marked reason, so no message gains a
# field for it.
RECONFIG_MARKER = "__hvd_elastic_reconfig__:"


def encode_reconfig_reason(epoch, members, dead, cause, drain=False):
    """A membership directive as an abort ``reason``.  ``drain=True``
    marks a planned departure: the departing worker leaves with
    :class:`HvdDrainedError` instead of an abort."""
    payload = {"epoch": epoch, "members": list(members),
               "dead": list(dead), "cause": str(cause)}
    if drain:
        payload["drain"] = True
    return RECONFIG_MARKER + json.dumps(payload)


def is_drain_reason(reason) -> bool:
    """Whether ``reason`` is a drain-marked membership directive."""
    if not (isinstance(reason, str)
            and reason.startswith(RECONFIG_MARKER)):
        return False
    try:
        return bool(json.loads(
            reason[len(RECONFIG_MARKER):]).get("drain"))
    except (ValueError, AttributeError):
        return False


def make_abort_error(origin_rank, reason):
    """The typed error of a learned ``(origin, reason)`` abort: an
    :class:`HvdReconfigureError` when the reason carries a membership
    directive, else an :class:`HvdAbortedError`."""
    if isinstance(reason, str) and reason.startswith(RECONFIG_MARKER):
        try:
            d = json.loads(reason[len(RECONFIG_MARKER):])
            return HvdReconfigureError(
                origin_rank, reason, epoch=d["epoch"],
                members=d["members"], dead=d.get("dead", ()),
                cause=d.get("cause", ""),
                drain=bool(d.get("drain", False)))
        except (ValueError, KeyError, TypeError):
            pass  # a malformed directive is a plain abort
    return HvdAbortedError(origin_rank, reason)


class Handle:
    """Completion handle for one rank's view of one collective."""

    __slots__ = ("_event", "_result", "_error", "name", "event")

    def __init__(self, name=""):
        self._event = threading.Event()
        self._result = None
        self._error = None
        self.name = name
        self.event = None

    def set_result(self, result, event=None):
        # first completion wins: a shutdown and the op's own failure path
        # may both reach the same handle
        if self._event.is_set():
            return
        self._result = result
        self.event = event
        self._event.set()

    def set_error(self, message):
        if self._event.is_set():
            return
        self._error = (message if isinstance(message, HvdError)
                       else HvdError(message))
        self._event.set()

    def poll(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"collective '{self.name}' did not complete within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class HandleManager:
    """Integer-handle indirection used by the torch surface (reference:
    ``horovod/torch/handle_manager.cc:47``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._handles = {}

    def allocate(self, handle) -> int:
        with self._lock:
            idx = self._next
            self._next += 1
            self._handles[idx] = handle
        return idx

    def get(self, idx: int):
        with self._lock:
            if idx not in self._handles:
                raise ValueError(f"unknown handle {idx}")
            return self._handles[idx]

    def poll(self, idx: int) -> bool:
        return self.get(idx).poll()

    def wait(self, idx: int, timeout=None):
        handle = self.get(idx)
        try:
            result = handle.wait(timeout)
        except TimeoutError:
            raise  # handle stays registered: the collective may still
            # complete, and a retry must be able to collect the result
        except Exception:
            with self._lock:  # terminal (HvdError): drop the entry
                self._handles.pop(idx, None)
            raise
        with self._lock:
            self._handles.pop(idx, None)
        return result
