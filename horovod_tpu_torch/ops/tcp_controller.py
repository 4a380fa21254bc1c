"""The coordinated control plane: a rank-0 coordinator over HMAC-framed
TCP, heartbeats, liveness and the coordinated abort.

Port of ``horovod_tpu/ops/tcp_controller.py``'s control side
(``CoordinatorService``, :255-540; the worker's heartbeat loop, local
abort and abort delivery, :1504-1748) for the eager plane of
``ops/controller.py``.  The port's bytes travel over NCCL (gloo on the
CPU), so what crosses this plane is the negotiation and the job's
health, not tensors:

- **The exchange.**  Every cycle each rank sends its signed cycle message
  (``Controller._exchange``) to the coordinator over ONE persistent
  :class:`~horovod_tpu_torch.run.service.network.MuxClient`
  (:class:`CycleMsg`, numbered by cycle); the coordinator replies to
  each once it holds every rank's message for that cycle, with all of
  them in rank order.  Every rank then decides the same responses from
  the same data, as before.
- **Liveness** (reference :339-392, :500-540).  A heartbeat thread on each
  rank beats every ``effective_heartbeat_interval`` over a client of its
  own with no connect retry; the coordinator's time-gated scan turns a
  rank silent for longer than ``HVD_TPU_LIVENESS_TIMEOUT`` into an abort
  ("rank N sent no heartbeat for more than Xs (presumed dead)").  A rank
  that shuts down leaves the table (:class:`ShutdownMsg`).
- **Abort delivery** (reference :394-445, :1577-1748).  An abort is
  sticky at the coordinator.  A rank learns it from its next heartbeat
  reply or from its pending exchange, which the coordinator answers at
  once; rank 0, whose process hosts the coordinator, waits (bounded)
  until every live peer has been told before it unwinds, the port's
  counterpart of the reference's re-push.  A rank that cannot reach the
  coordinator for ``HVD_TPU_ABORT_TIMEOUT`` (its exchange connection
  breaking, in ``hvd.init()``'s barrier too, counts at once) aborts
  itself naming rank 0.  The coordinator's fail-over waits for elastic
  membership (ROADMAP A.13c).
- **A rank's own failed collective**, when the backend reports a broken
  communication (:func:`is_comm_error`: a peer gone, a communicator
  aborted), waits for the coordinator's verdict
  (:meth:`ControlPlane.verdict`), up to the liveness window, before it
  is reported: a survivor whose collective broke because a peer died
  names that peer, never itself.  The caller's own errors (a shape, a
  dtype, a group, memory) are raised at once.

Where the coordinator is found: rank 0 binds on the address the other
ranks are told (``common/basics.py``) and publishes ``host:port`` in
``torch.distributed``'s store, which the launcher's KV rendezvous, a
``store_path`` and one host all reach the same way.  Each rank publishes
there the local address of its exchange connection too, before its
first frame: a frame that fails verification carries no readable rank,
and this is how the coordinator names the rank whose job key differs
(:meth:`CoordinatorService._on_refused`); that rank, whose frames the
coordinator refused, reads the coordinator's refusal as a frame that
fails verification on its side.
"""

import collections
import logging
import re
import threading
import time

import torch.distributed as dist

from horovod_tpu_torch.common.handles import make_abort_error
from horovod_tpu_torch.run.service import network

_log = logging.getLogger("horovod_tpu_torch")

# the texts of the backends' communication failures that reach Python
# as a plain RuntimeError (gloo's transport: "Connection closed by
# peer", "Timed out waiting ..."); NCCL's are DistBackendError
_COMM_TEXT = re.compile(
    r"(?i)nccl|gloo/transport|connection|timed out|broken pipe|abort")


def is_comm_error(exc):
    """Whether ``exc``, raised by a collective, is the backend's own
    communication failure, which a dead peer causes, rather than the
    caller's error."""
    if isinstance(exc, (dist.DistError, OSError)):
        return True
    return isinstance(exc, RuntimeError) and bool(
        _COMM_TEXT.search(str(exc)))


# req-exempt: ALLREDUCE, ADASUM, ALLGATHER, BROADCAST, ALLTOALL, JOIN
# req-exempt: REDUCE_SCATTER — the coordinator relays each rank's signed
# cycle message whole (CycleMsg) and decides nothing; every type is
# dispatched by ops/controller.py, which every rank runs on the relayed
# messages


# ------------------------------------------------------------------ messages
# epoch-exempt: the port has no membership epochs before elastic
# membership (ROADMAP A.13c): one world per hvd.init, and each init's
# coordinator has an address of its own in that init's store
class CycleMsg:
    """One rank's signed cycle message for cycle ``seq``."""

    def __init__(self, rank, seq, data):
        self.rank = rank
        self.seq = seq
        self.data = data        # bytes: digest + pickled message


class CycleReply:
    def __init__(self, msgs=None, aborted=None, error=None):
        self.msgs = msgs        # every rank's data, in rank order
        self.aborted = aborted  # (origin_rank, reason) | None
        self.error = error      # the coordinator's refusal, or None


# epoch-exempt: teardown is epoch-agnostic by design — a shutdown must
# deregister the rank whichever epoch the frame was minted in, and
# acting on a straggler shutdown is idempotent (the rank is gone either
# way)
class ShutdownMsg:
    """A cleanly departing rank leaves the liveness table."""

    def __init__(self, rank):
        self.rank = rank


class RefusedReply:
    """Written, under the coordinator's key, on a connection whose frame
    failed verification, just before the coordinator drops it."""


def key_refused(rank):
    """The coordinator's verdict on rank ``rank``'s frames."""
    return (f"the frames of rank {rank} failed HMAC verification at the "
            f"coordinator (rank 0): its job key differs from rank 0's "
            f"(HVD_SECRET_KEY)")


def coordinator_refused(rank):
    """What rank ``rank`` says when the coordinator's reply fails
    verification on its side."""
    return (f"the frames of the coordinator (rank 0) failed HMAC "
            f"verification on rank {rank}: its job key differs from rank "
            f"{rank}'s (HVD_SECRET_KEY)")


class CoordinatorService(network.MuxService):
    """Rank 0's coordinator: the cycle exchange, liveness and the sticky
    abort.  ``rank_of_client``: (ip, port) -> the rank whose exchange
    connection has that local address, or None (names the sender of a
    refused frame); ``on_abort(origin, reason)`` runs, on a thread of its
    own, when the abort is first set (rank 0's plane)."""

    NAME = "horovod_tpu_torch coordinator"

    def __init__(self, size, key, host="0.0.0.0", liveness_timeout_sec=0.0,
                 rank_of_client=None, on_abort=None):
        self._size = size
        self._liveness = liveness_timeout_sec
        self._rank_of_client = rank_of_client
        self._on_abort = on_abort
        self._cv = threading.Condition()
        # seq -> {rank: (data, responder)}; guarded by self._cv
        self._cycles = {}
        # rank -> monotonic ts of last message; guarded by self._cv
        self._last_seen = {}
        # monotonic ts of the last liveness scan; guarded by self._cv
        self._last_liveness_scan = 0.0
        # (origin_rank, reason), sticky: written once under self._cv (the
        # lock-free reads below are annotated: a stale None is at worst
        # one poll late, never wrong)
        self._abort = None
        self._dead = set()          # guarded by self._cv
        self._told = set()          # ranks handed the abort; self._cv
        self._refused = None        # sticky verdict; guarded by self._cv
        super().__init__(self.NAME, key, host)

    def _valid_rank(self, rank):
        return isinstance(rank, int) and 0 <= rank < self._size

    # ----------------------------------------------------------- requests
    def _seen(self, req):
        # HMAC-verified, but its fields are still wire input
        rank = getattr(req, "rank", None)
        if self._valid_rank(rank):
            with self._cv:
                self._last_seen[rank] = time.monotonic()
        return rank

    def _handle(self, req, client_address):
        rank = self._seen(req)
        if isinstance(req, network.HeartbeatMsg):
            self._check_liveness()
            with self._cv:
                abort = self._abort
                if abort is not None and self._valid_rank(rank):
                    self._told.add(rank)
                    self._cv.notify_all()
            return network.HeartbeatReply(abort=abort)
        if isinstance(req, network.AbortMsg):
            self._initiate_abort(req.origin_rank, str(req.reason))
            return network.AckResponse()
        if isinstance(req, ShutdownMsg):
            # a cleanly departing rank stops heartbeating by design: it
            # must leave the table, or a survivor doing slow work after
            # training would trip a spurious "presumed dead" abort
            with self._cv:
                self._last_seen.pop(rank, None)
                self._cv.notify_all()
            return network.AckResponse()
        return super()._handle(req, client_address)

    def _handle_deferred(self, req, client_address, respond):
        """A cycle message: held until every rank's for its cycle is in,
        then the reader that brings the last one answers them all (the
        exchange spawns no thread and wakes no waiter)."""
        if not isinstance(req, CycleMsg):
            return False
        self._seen(req)
        if not (self._valid_rank(req.rank) and isinstance(req.seq, int)
                and isinstance(req.data, bytes)):
            respond(CycleReply(error="malformed cycle message"))
            return True
        answers, aborted = [], None
        with self._cv:
            if self._abort is not None:
                aborted = self._abort
            elif self._refused is not None:
                answers = [(respond, CycleReply(error=self._refused))]
            else:
                entry = self._cycles.setdefault(req.seq, {})
                entry[req.rank] = (req.data, respond)
                if len(entry) == self._size:
                    del self._cycles[req.seq]
                    msgs = [entry[r][0] for r in range(self._size)]
                    answers = [(entry[r][1], CycleReply(msgs=msgs))
                               for r in range(self._size)]
        if aborted is not None:
            respond(CycleReply(aborted=aborted))
            with self._cv:
                self._told.add(req.rank)
                self._cv.notify_all()
        for fn, reply in answers:
            fn(reply)
        return True

    def _fail_cycles_locked(self, reply):  # holds: self._cv
        """Every pending cycle message's responder with ``reply``."""
        pending = [(rank, fn) for entry in self._cycles.values()
                   for rank, (_, fn) in entry.items()]
        self._cycles.clear()
        return [(fn, reply) for _, fn in pending], [r for r, _ in pending]

    def _on_refused(self, sock, client_address):
        """A frame failed verification: answer with a frame under this
        coordinator's key (the sender fails to verify it, and so learns
        whose key differs) and, if the connection is a rank's exchange
        connection, fail every cycle naming that rank."""
        try:
            network.write_message(sock, self._key, (None, RefusedReply()),
                                  "r")
        except OSError:
            pass
        rank = (self._rank_of_client(client_address)
                if self._rank_of_client is not None else None)
        if rank is None:
            _log.warning("coordinator: dropped a connection from %s whose "
                         "frame failed HMAC verification",
                         client_address)
            return
        with self._cv:
            if self._refused is not None:
                return
            self._refused = key_refused(rank)
            answers, _ = self._fail_cycles_locked(
                CycleReply(error=self._refused))
        for fn, reply in answers:
            fn(reply)

    # -------------------------------------------------- abort + liveness
    def _initiate_abort(self, origin_rank, reason, dead=False):
        """Coordinated abort: every rank pending in an exchange is
        answered now; the others learn it from their next exchange or
        heartbeat reply.  Sticky."""
        with self._cv:
            if self._abort is not None:
                return
            self._abort = (origin_rank, reason)
            if dead:
                self._dead.add(origin_rank)
            answers, told = self._fail_cycles_locked(
                CycleReply(aborted=self._abort))
        for fn, reply in answers:
            fn(reply)
        with self._cv:
            self._told.update(told)
            self._cv.notify_all()
        _log.error("coordinated abort (origin rank %s): %s", origin_rank,
                   reason)
        if self._on_abort is not None:
            # lifecycle: daemon, one-shot; rank 0's local abort waits for
            # the peers to be told, never on a request thread
            threading.Thread(target=self._on_abort,
                             args=(origin_rank, reason), daemon=True,
                             name="hvd-torch-abort").start()

    def abort_state(self):
        with self._cv:
            return self._abort

    def wait_told(self, me, timeout):
        """Wait up to ``timeout`` s until every rank that is registered,
        not departed and not dead (``me`` aside) has been handed the
        abort."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not (set(self._last_seen) - self._told
                             - self._dead - {me}), timeout)

    def _check_liveness(self):
        """Convert a silently dead rank (no message within the liveness
        window) into a coordinated abort instead of an indefinite
        wait."""
        # sticky-flag fast path; _initiate_abort re-checks under the lock
        if self._liveness <= 0 or self._abort is not None:  # hvd-lint: ignore[lock-discipline]
            return
        now = time.monotonic()
        with self._cv:
            # the O(N) table scan runs at most ~10x per window
            if now - self._last_liveness_scan < self._liveness / 10.0:
                return
            self._last_liveness_scan = now
            dead = sorted(r for r, ts in self._last_seen.items()
                          if now - ts > self._liveness)
        if dead:
            self._initiate_abort(
                dead[0],
                f"rank {dead[0]} sent no heartbeat for more than "
                f"{self._liveness:g}s (presumed dead)", dead=True)


class ControlPlane:
    """One rank's side of the control plane: the exchange, the heartbeat
    thread and the sticky local abort.  ``listeners`` run, in order, on
    the local abort (``common/basics.py``: abort the communicators, then
    the eager plane's queue and handles)."""

    def __init__(self, rank, size, key, config):
        self.rank = rank
        self.size = size
        self._key = key
        self._config = config
        self._address = None             # (host, port) of the coordinator
        self._coordinator = None         # rank 0's CoordinatorService
        self._listeners = []
        self._abort_lock = threading.Lock()
        self._abort_state = None         # guarded by self._abort_lock
        self._aborted = threading.Event()   # set once listeners ran
        self._refused = None             # sticky key refusal, or None
        self._mux = None
        self._seq = 0                    # the cycle thread's own
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._hb_s = collections.deque(maxlen=1000)

    def add_listener(self, fn):
        self._listeners.append(fn)

    def abort_state(self):
        with self._abort_lock:
            return self._abort_state

    def heartbeat_times(self):
        """Seconds of the last (up to 1000) heartbeat round trips."""
        return list(self._hb_s)

    # ------------------------------------------------------------ startup
    def serve(self, host, rank_of_client=None):
        """Rank 0: host the coordinator on ``host``; -> its port."""
        self._coordinator = CoordinatorService(
            self.size, self._key, host=host,
            liveness_timeout_sec=self._config.liveness_timeout_seconds,
            rank_of_client=rank_of_client, on_abort=self._local_abort)
        return self._coordinator.port

    def start(self, address, publish_address=None):
        """Connect to the coordinator at ``address`` (host, port),
        publish this rank's exchange address (``publish_address``),
        register with one synchronous heartbeat, start the heartbeat
        thread.  A registration whose reply fails verification is not
        fatal here: the rank's first exchange raises it."""
        from horovod_tpu_torch.common.config import (
            effective_heartbeat_interval)
        from horovod_tpu_torch.run.host_hash import host_hash

        self._address = address
        # not reconnected: the coordinator holds this rank's pending
        # cycle on the connection, and a broken one means it is lost
        self._mux = network.MuxClient([self._address], self._key,
                                      timeout=30, peer=0, reconnect=False)
        ip, port = self._mux.local_address()
        if publish_address is not None:
            publish_address(f"{ip}:{port}")
        # one beat before init returns: the coordinator knows this rank
        # exists BEFORE any collective can run, so a crash at any later
        # point falls inside the liveness window
        try:
            self._mux.send(network.HeartbeatMsg(self.rank, host=host_hash()),
                           timeout=30.0)
        except ConnectionError as exc:
            if isinstance(exc.__cause__, PermissionError):
                self._refused = coordinator_refused(self.rank)
                return
            raise RuntimeError(
                f"rank {self.rank} could not register with the "
                f"coordinator at startup: {exc}") from exc
        except Exception as exc:
            raise RuntimeError(
                f"rank {self.rank} could not register with the "
                f"coordinator at startup: {exc}") from exc
        interval = effective_heartbeat_interval(self._config)
        if interval > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, args=(interval, host_hash()),
                daemon=True, name="hvd-torch-heartbeat")
            self._hb_thread.start()

    def barrier(self, timeout):
        """Return once every rank has called it (the end of
        ``hvd.init``): the exchange of cycle -1, so that no rank starts
        work, and fails, while a peer is still making its groups.  A key
        refusal is left to the first exchange to raise; a lost
        coordinator aborts, naming rank 0 (rank 0's process can die as
        soon as its own barrier returns, and take this rank's reply with
        it)."""
        if self.size == 1 or self._refused is not None:
            return
        try:
            reply = self._mux.send(CycleMsg(self.rank, -1, b""),
                                   timeout=timeout)
        except TimeoutError:
            raise RuntimeError(
                f"rank {self.rank}: not every rank reached the end of "
                f"hvd.init() within {timeout:g} s") from None
        except ConnectionError as exc:
            if isinstance(exc.__cause__, PermissionError):
                self._refused = coordinator_refused(self.rank)
                return
            self._local_abort(0, f"coordinator unreachable during "
                                 f"hvd.init(): {exc}")
            raise make_abort_error(*self.abort_state()) from exc
        if reply.aborted is not None:
            self._local_abort(*reply.aborted)
            raise make_abort_error(*reply.aborted)

    # ------------------------------------------------------------ exchange
    def exchange(self, data):
        """Every rank's data for this cycle, in rank order; raises the
        abort error once the job has aborted, ``PermissionError`` on a
        job key refusal."""
        if self._refused is not None:
            raise PermissionError(self._refused)
        state = self.abort_state()
        if state is not None:
            raise make_abort_error(*state)
        seq, self._seq = self._seq, self._seq + 1
        try:
            reply = self._mux.send(CycleMsg(self.rank, seq, data))
        except (ConnectionError, TimeoutError, OSError) as exc:
            if isinstance(exc.__cause__, PermissionError):
                self._refused = coordinator_refused(self.rank)
                raise PermissionError(self._refused) from exc
            # the control plane is gone: the same typed, symmetric error
            # as the heartbeat's self-abort, not a one-off transport one
            self._local_abort(0, f"coordinator unreachable during "
                                 f"negotiation: {exc}")
            raise make_abort_error(*self.abort_state()) from exc
        if reply.aborted is not None:
            self._local_abort(*reply.aborted)
            raise make_abort_error(*reply.aborted)
        if reply.error is not None:
            raise PermissionError(reply.error)
        return reply.msgs

    # ------------------------------------------------------------ liveness
    def _heartbeat_loop(self, interval, host):
        # a dedicated no-retry client: the exchange client's connect
        # retry would stretch the dead-coordinator budget below to a
        # multiple of itself, and a failed beat must be cheap to observe
        hb = network.MuxClient([self._address], self._key,
                               timeout=max(interval, 2.0), retry_for=0,
                               peer=0)
        fail_since = None
        try:
            while True:
                try:
                    t0 = time.perf_counter()
                    reply = hb.send(network.HeartbeatMsg(self.rank,
                                                         host=host),
                                    timeout=max(interval * 2, 5.0))
                    self._hb_s.append(time.perf_counter() - t0)
                except Exception as exc:  # noqa: BLE001 — an outage
                    now = time.monotonic()
                    fail_since = now if fail_since is None else fail_since
                    # the abort deadline, not the liveness window, bounds
                    # how long this rank may spin against a dead
                    # coordinator
                    budget = (self._config.abort_timeout_seconds
                              or self._config.liveness_timeout_seconds)
                    if budget > 0 and now - fail_since > budget:
                        self._local_abort(
                            0, f"coordinator unreachable for "
                               f"{int(now - fail_since)}s: {exc}")
                        return
                else:
                    fail_since = None
                    if reply.abort is not None:
                        self._local_abort(*reply.abort)
                        return
                if self._hb_stop.wait(timeout=interval):
                    return
        finally:
            hb.close()

    # --------------------------------------------------------------- abort
    def _local_abort(self, origin_rank, reason):
        """Apply the abort on this rank, once: on rank 0 first wait
        (bounded) until every live peer has been told, since a waiter
        this wakes may end the process and the coordinator with it; then
        run the listeners."""
        with self._abort_lock:
            if self._abort_state is not None:
                return
            self._abort_state = (origin_rank, reason)
        _log.error("aborting collectives (origin rank %s): %s", origin_rank,
                   reason)
        if self._coordinator is not None:
            self._coordinator._initiate_abort(origin_rank, reason)
            self._coordinator.wait_told(self.rank, self._tell_budget())
        for fn in self._listeners:
            try:
                fn(origin_rank, reason)
            except Exception:  # noqa: BLE001 — the next one must run
                _log.exception("horovod_tpu_torch: abort listener failed")
        self._aborted.set()

    def _tell_budget(self):
        from horovod_tpu_torch.common.config import (
            effective_heartbeat_interval)

        budget = effective_heartbeat_interval(self._config) + 1.0
        if self._config.abort_timeout_seconds > 0:
            budget = min(budget, self._config.abort_timeout_seconds / 2)
        return budget

    def abort(self, origin_rank, reason):
        """Report an abort to the coordinator (best effort), then apply
        it here (``hvd.abort()``, the stall shutdown)."""
        if self._mux is not None and self._refused is None:
            try:
                self._mux.send(network.AbortMsg(origin_rank, reason),
                               timeout=5.0)
            except Exception:  # noqa: BLE001 — the local abort proceeds
                pass
        self._local_abort(origin_rank, reason)

    def verdict(self, exc):
        """After this rank's own collective failed with ``exc``: the
        job's abort, if it has one; else, for a communication failure
        (:func:`is_comm_error`), wait for it up to the liveness window,
        the scan's gate and two beats (the abort deadline without
        liveness).  -> (origin, reason) or None."""
        from horovod_tpu_torch.common.config import (
            effective_heartbeat_interval)

        state = self.abort_state()
        if state is not None or not is_comm_error(exc):
            return state
        if self.size > 1:
            live = self._config.liveness_timeout_seconds
            self._aborted.wait(
                live * 1.1 + 2 * effective_heartbeat_interval(self._config)
                + 1.0 if live > 0 else self._config.abort_timeout_seconds)
        return self.abort_state()

    def await_abort(self, timeout=None):
        """Block until the job's abort has been applied here."""
        self._aborted.wait(timeout)
        return self.abort_state()

    # ------------------------------------------------------------ shutdown
    def shutdown(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        if self._mux is not None:
            if self.abort_state() is None and self._refused is None:
                try:  # leave the liveness table (best effort)
                    self._mux.send(ShutdownMsg(self.rank), timeout=5.0)
                except Exception:  # noqa: BLE001 — coordinator may be gone
                    pass
            self._mux.close()
            self._mux = None
        if self._coordinator is not None:
            self._coordinator.shutdown()
            self._coordinator = None
