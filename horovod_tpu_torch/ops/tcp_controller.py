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
  itself naming rank 0, or, with ``HVD_TPU_COORD_FAILOVER``, first races
  the fail-over election (``elastic/election.py``) and takes its
  directive.
- **A rank's own failed collective**, when the backend reports a broken
  communication (:func:`is_comm_error`: a peer gone, a communicator
  aborted), waits for the coordinator's verdict
  (:meth:`ControlPlane.verdict`), up to the liveness window, before it
  is reported: a survivor whose collective broke because a peer died
  names that peer, never itself.  The caller's own errors (a shape, a
  dtype, a group, memory) are raised at once.

- **Elastic membership** (``HVD_TPU_ELASTIC``).  Rank 0's coordinator
  carries an :class:`~horovod_tpu_torch.elastic.membership.ElasticContext`:
  ``_initiate_abort`` asks it first, and a survivable loss goes out as a
  marked reconfiguration directive through the same delivery.  Every
  cycle message carries its sender's membership epoch, and a coordinator
  refuses one from another epoch.  A rank that got its preemption notice
  sends :class:`DrainMsg` (``common/drain.py``): it leaves the liveness
  table's blame, and a drain-marked directive goes out at the next
  boundary of the eager plane's cycles, pulled by every rank (no abort
  is pushed on rank 0).  :meth:`ControlPlane.close_for_reconfig` takes a
  plane down without the job-end messages.
- **Adaptive liveness** (reference :486-610).  Each heartbeat carries the
  rank's busy flag (``common/busy.py``: a checkpoint write, a drain, a
  session heal), its round trips' EWMA (``common/rtt.py``) and the peers
  it is healing a session toward; a busy or healing rank's window
  doubles, and an RTT slack (capped at ``straggler_factor`` windows) is
  added.  A rank whose RTT stays above ``straggler_factor`` x the median
  for ``straggler_windows`` scans gets a straggler verdict, and under
  ``HVD_TPU_STRAGGLER_EXCLUDE`` (with elastic) a drain-style exclusion;
  a healing rank gets no straggler verdict (reference :554-557).
- **The session layer** (``HVD_TPU_RECONNECT_BUDGET`` above 0, reference
  ``run/service/network.py``).  A rank's exchange connection is then a
  session that names the plane's membership epoch: a break of that
  link heals inside the budget, the frames the coordinator did not get
  are sent again, and the coordinator answers the cycle it holds on
  whichever connection the session has now, once.  A heal past the
  budget, or one the epoch fence refuses, raises the break, which
  aborts as before.  At budget 0 the connection is the plain one,
  which a break ends.

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

from horovod_tpu_torch.common import busy
from horovod_tpu_torch.common import rtt as rtt_mod
from horovod_tpu_torch.common.handles import (RECONFIG_MARKER,
                                              is_drain_reason,
                                              make_abort_error)
from horovod_tpu_torch.run.service import network
from horovod_tpu_torch.utils import env as env_util

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
class CycleMsg:
    """One rank's signed cycle message for cycle ``seq`` of membership
    epoch ``epoch``."""

    def __init__(self, rank, seq, data, epoch=0):
        self.rank = rank
        self.seq = seq
        self.data = data        # bytes: digest + pickled message
        self.epoch = epoch      # the sender's membership epoch


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


# epoch-exempt: a drain names the current coordinator's own rank; each
# epoch's coordinator has an address of its own, so a drain announced at
# epoch N cannot reach epoch N+1's
class DrainMsg:
    """A rank announces its planned departure (its preemption notice)."""

    def __init__(self, rank):
        self.rank = rank


class DrainAck:
    def __init__(self, ok, reason=""):
        self.ok = ok            # True: a reconfiguration without the
        self.reason = reason    # rank is on its way


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
                 rank_of_client=None, on_abort=None, epoch=0, elastic=None,
                 straggler_factor=None, straggler_windows=None,
                 straggler_exclude=False):
        self._size = size
        self._liveness = liveness_timeout_sec
        self._rank_of_client = rank_of_client
        self._on_abort = on_abort
        # the membership epoch served: a cycle message of another epoch
        # is refused
        self._epoch = epoch
        # ElasticContext (HVD_TPU_ELASTIC) or None: _initiate_abort asks
        # it to rewrite a survivable failure into a directive
        self._elastic = elastic
        self._straggler_factor = (
            env_util.get_float(env_util.HVD_TPU_STRAGGLER_FACTOR,
                               env_util.DEFAULT_STRAGGLER_FACTOR)
            if straggler_factor is None else straggler_factor)
        self._straggler_windows = (
            env_util.get_int(env_util.HVD_TPU_STRAGGLER_WINDOWS,
                             env_util.DEFAULT_STRAGGLER_WINDOWS)
            if straggler_windows is None else straggler_windows)
        self._straggler_exclude = straggler_exclude
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
        # ranks whose last heartbeat was busy (a checkpoint write, a
        # drain, a session heal): their window doubles; guarded by
        # self._cv
        self._busy_ranks = set()
        # ranks whose last heartbeat reported a session heal in flight:
        # busy for liveness and exempt from straggler verdicts, so that
        # a recovering link never turns into an exclusion or an abort;
        # guarded by self._cv
        self._reconnecting_ranks = set()
        # ranks that announced a drain: never blamed by liveness, their
        # silence is the planned departure; guarded by self._cv
        self._draining = set()
        self._peer_rtt = {}         # rank -> seconds; guarded by self._cv
        # rank -> consecutive scans over the straggler threshold, and
        # rank -> its sticky verdict; guarded by self._cv
        self._straggler_hits = {}
        self._straggler_verdicts = {}
        super().__init__(self.NAME, key, host)

    def _valid_rank(self, rank):
        return isinstance(rank, int) and 0 <= rank < self._size

    def session_epoch(self):
        """A session's hello must name this coordinator's membership
        epoch: a rank of a torn-down world cannot resume into it."""
        return self._epoch

    # ----------------------------------------------------------- requests
    def _seen(self, req):
        # HMAC-verified, but its fields are still wire input
        rank = getattr(req, "rank", None)
        if self._valid_rank(rank):
            with self._cv:
                self._last_seen[rank] = time.monotonic()
                if isinstance(req, network.HeartbeatMsg):
                    healing = bool(getattr(req, "reconnecting", None))
                    if getattr(req, "busy", False) or healing:
                        self._busy_ranks.add(rank)
                    else:
                        self._busy_ranks.discard(rank)
                    if healing:
                        self._reconnecting_ranks.add(rank)
                    else:
                        self._reconnecting_ranks.discard(rank)
                    rtt = getattr(req, "rtt", None)
                    if isinstance(rtt, (int, float)):
                        self._peer_rtt[rank] = float(rtt)
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
        if isinstance(req, DrainMsg):
            if not self._valid_rank(rank):
                return DrainAck(False, "malformed drain announcement")
            return self._handle_drain(rank)
        if isinstance(req, ShutdownMsg):
            # a cleanly departing rank stops heartbeating by design: it
            # must leave the table, or a survivor doing slow work after
            # training would trip a spurious "presumed dead" abort
            with self._cv:
                self._last_seen.pop(rank, None)
                self._busy_ranks.discard(rank)
                self._reconnecting_ranks.discard(rank)
                self._draining.discard(rank)
                self._peer_rtt.pop(rank, None)
                self._straggler_hits.pop(rank, None)
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
        if getattr(req, "epoch", 0) != self._epoch:
            # a straggler from a torn-down membership must not take part
            # in this epoch's cycles
            respond(CycleReply(error=(
                f"stale membership epoch {getattr(req, 'epoch', 0)} of "
                f"rank {req.rank}'s cycle message (coordinator is at "
                f"epoch {self._epoch})")))
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
        heartbeat reply.  Sticky.  With an ElasticContext attached, a
        survivable failure is first rewritten into a reconfiguration
        directive, which the same delivery hands out; a drain-marked one
        is only pulled (rank 0 is not pushed the abort)."""
        # plan() talks to the rendezvous, so it runs outside the lock;
        # the plan is sticky and the abort re-checked under the lock.  A
        # reason that already is a directive (a drain) passes unchanged
        if (self._elastic is not None and self._abort is None  # hvd-lint: ignore[lock-discipline]
                and not (isinstance(reason, str)
                         and reason.startswith(RECONFIG_MARKER))):
            planned = self._elastic.plan(origin_rank, reason)
            if planned is not None:
                reason = planned
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
        if self._on_abort is not None and not is_drain_reason(reason):
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

    def _handle_drain(self, rank):
        """A graceful drain (``common/drain.py``): exempt the rank from
        liveness blame, plan a reconfiguration without it, wait for a
        boundary of the eager plane's cycles (no cycle half exchanged,
        at most 5 s), then hand out the drain-marked directive.  Runs on
        this request's own reader thread."""
        with self._cv:
            if self._abort is not None:
                # a failure (or another drain) beat this announcement
                return DrainAck(False, "abort already in flight")
            self._draining.add(rank)
        directive = (self._elastic.plan_drain(rank)
                     if self._elastic is not None else None)
        if directive is None:
            with self._cv:
                self._draining.discard(rank)
            return DrainAck(
                False, "drain not survivable: elastic disabled, "
                       "coordinator rank, or too few survivors")
        self._await_boundary()
        self._initiate_abort(rank, directive)
        return DrainAck(True)

    def _await_boundary(self, budget=5.0):
        """Poll, outside the lock, until no cycle is half exchanged or
        ``budget`` seconds passed: a late directive is still right, it
        fails one cycle into the reconfiguration."""
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            with self._cv:
                if self._abort is not None or not self._cycles:
                    return
            time.sleep(0.005)

    def _deadline_for_locked(self, r):  # holds: self._cv
        """Rank ``r``'s liveness window: the busy factor multiplies the
        base window, the RTT slack adds to it."""
        base = self._liveness * (2.0 if r in self._busy_ranks else 1.0)
        return base + self._rtt_slack_locked(r)

    def _rtt_slack_locked(self, r):  # holds: self._cv
        """The slack of the rank's reported RTT EWMA, capped at factor x
        the base window, so that no report makes a rank unkillable."""
        return min(self._peer_rtt.get(r, 0.0) * self._straggler_factor,
                   self._liveness * self._straggler_factor)

    def _check_liveness(self):
        """Convert a silently dead rank (no message within its adaptive
        window) into a coordinated abort instead of an indefinite wait;
        a draining rank is never blamed.  Without a death, the scan
        looks for stragglers."""
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
                          if now - ts > self._deadline_for_locked(r)
                          and r not in self._draining)
            window = self._deadline_for_locked(dead[0]) if dead else 0.0
            straggler = None if dead else self._straggler_scan_locked()
        if dead:
            self._initiate_abort(
                dead[0],
                f"rank {dead[0]} sent no heartbeat for more than "
                f"{window:g}s (presumed dead)", dead=True)
        elif straggler is not None:
            # the boundary wait and plan_drain block: never on a
            # heartbeat's thread.  lifecycle: daemon, one-shot
            threading.Thread(target=self._propose_straggler_exclusion,
                             args=(straggler,), daemon=True,
                             name="hvd-torch-straggler").start()

    def _straggler_scan_locked(self):  # holds: self._cv
        """The k x median verdict: a rank whose RTT EWMA exceeds
        ``straggler_factor`` x the median of every report for
        ``straggler_windows`` scans in a row is recorded and logged.  ->
        a rank to exclude (opt-in, elastic only), or None."""
        if len(self._peer_rtt) < 3:
            return None  # no meaningful median from fewer peers
        med = rtt_mod.median(self._peer_rtt.values())
        exclude = None
        for r, value in self._peer_rtt.items():
            if r in self._reconnecting_ranks:
                # a healing link inflates its RTT by construction: a
                # heal in progress never ripens into a verdict
                self._straggler_hits.pop(r, None)
                continue
            if not (med > 0 and value > self._straggler_factor * med):
                self._straggler_hits.pop(r, None)
                continue
            self._straggler_hits[r] = self._straggler_hits.get(r, 0) + 1
            if (self._straggler_hits[r] >= self._straggler_windows
                    and r not in self._straggler_verdicts):
                self._straggler_verdicts[r] = {
                    "rank": r, "rtt": value, "median": med,
                    "factor": self._straggler_factor}
                _log.warning(
                    "straggler verdict: rank %d RTT %.3fs > %g x "
                    "median %.3fs for %d consecutive windows", r,
                    value, self._straggler_factor, med,
                    self._straggler_hits[r])
                if exclude is None:
                    exclude = r
        if (exclude is not None and self._straggler_exclude
                and self._elastic is not None):
            return exclude
        return None

    def straggler_verdicts(self):
        """The recorded straggler verdicts (rank -> verdict dict)."""
        with self._cv:
            return {r: dict(v)
                    for r, v in self._straggler_verdicts.items()}

    def _propose_straggler_exclusion(self, rank):
        """A confirmed straggler's drain-style exclusion
        (``HVD_TPU_STRAGGLER_EXCLUDE``, elastic only): the granted drain's
        protocol, nothing aborts."""
        with self._cv:
            if self._abort is not None or rank in self._draining:
                return
            self._draining.add(rank)
        directive = self._elastic.plan_drain(
            rank, cause=f"rank {rank} excluded as confirmed straggler")
        if directive is None:
            with self._cv:
                self._draining.discard(rank)
            return
        self._await_boundary()
        self._initiate_abort(rank, directive)


class ControlPlane:
    """One rank's side of the control plane: the exchange, the heartbeat
    thread and the sticky local abort.  ``listeners`` run, in order, on
    the local abort (``common/basics.py``: abort the communicators, then
    the eager plane's queue and handles)."""

    def __init__(self, rank, size, key, config, epoch=0, members=None):
        self.rank = rank
        self.size = size
        # the membership epoch and its worker ids in rank order
        self.epoch = epoch
        self.members = (list(members) if members is not None
                        else list(range(size)))
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
    def serve(self, host, rank_of_client=None, rendezvous=None):
        """Rank 0: host the coordinator on ``host``, with the membership
        planner under ``HVD_TPU_ELASTIC`` (joiners and the published
        membership through ``rendezvous``, the launcher's KV as
        ``(addr, port)``, when there is one); -> its port."""
        config = self._config
        elastic = None
        if config.elastic and self.size > 1:
            from horovod_tpu_torch.elastic.membership import ElasticContext

            elastic = ElasticContext(
                members=self.members, epoch=self.epoch,
                min_ranks=config.min_ranks, max_ranks=config.max_ranks,
                rendezvous=rendezvous,
                coord_failover=config.coord_failover)
        self._coordinator = CoordinatorService(
            self.size, self._key, host=host,
            liveness_timeout_sec=config.liveness_timeout_seconds,
            rank_of_client=rank_of_client, on_abort=self._local_abort,
            epoch=self.epoch, elastic=elastic,
            straggler_factor=config.straggler_factor,
            straggler_windows=config.straggler_windows,
            straggler_exclude=config.straggler_exclude)
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
        published = []

        def publish(sock):
            # before the connection's first frame (a session's hello
            # too), so that the coordinator can name this rank if that
            # frame fails verification
            if publish_address is not None and not published:
                ip, port = sock.getsockname()[:2]
                publish_address(f"{ip}:{port}")
                published.append(True)

        # never reconnected plainly: the coordinator holds this rank's
        # pending cycle on the connection.  With a reconnect budget the
        # connection is a session, which heals a break inside it and
        # resumes that cycle; at budget 0 a break means it is lost
        config = self._config
        self._mux = network.MuxClient(
            [self._address], self._key, timeout=30, peer=0,
            reconnect=False, epoch=self.epoch,
            reconnect_budget=config.reconnect_budget_seconds,
            replay_bytes=config.replay_buffer_bytes, on_connect=publish)
        try:
            self._mux.local_address()
        except PermissionError:
            # the session's welcome failed verification: the keys differ
            self._refused = coordinator_refused(self.rank)
            return
        # one beat before init returns: the coordinator knows this rank
        # exists BEFORE any collective can run, so a crash at any later
        # point falls inside the liveness window
        try:
            t0 = time.perf_counter()
            self._mux.send(network.HeartbeatMsg(self.rank, host=host_hash()),
                           timeout=30.0)
            # the adaptive deadline starts from a measured round trip
            rtt_mod.tracker().sample(rtt_mod.COORD_KEY,
                                     time.perf_counter() - t0)
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
            reply = self._mux.send(CycleMsg(self.rank, -1, b"", self.epoch),
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
            reply = self._mux.send(CycleMsg(self.rank, seq, data,
                                            self.epoch))
        except (ConnectionError, TimeoutError, OSError) as exc:
            if isinstance(exc.__cause__, PermissionError):
                self._refused = coordinator_refused(self.rank)
                raise PermissionError(self._refused) from exc
            # the control plane is gone: the same typed, symmetric error
            # as the heartbeat's self-abort (or, with fail-over armed,
            # the election's directive), not a one-off transport one
            self._coordinator_lost(f"coordinator unreachable during "
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
        # a dedicated no-retry client, and no session: the exchange
        # client's connect retry (or a heal's budget) would stretch the
        # dead-coordinator budget below to a multiple of itself, and a
        # failed beat must be cheap to observe
        hb = network.MuxClient([self._address], self._key,
                               timeout=max(interval, 2.0), retry_for=0,
                               peer=0, reconnect_budget=0)
        tracker = rtt_mod.tracker()
        fail_since = None
        try:
            while True:
                try:
                    t0 = time.perf_counter()
                    # each beat carries this rank's busy flag, its worst
                    # smoothed round trip and the peers it is healing a
                    # session toward: the coordinator widens this rank's
                    # window by them (slow or healing is not dead)
                    reply = hb.send(network.HeartbeatMsg(
                        self.rank, busy=busy.active(),
                        rtt=tracker.worst() or None, host=host,
                        reconnecting=network.healing_peers() or None),
                        timeout=max(interval * 2, 5.0))
                    self._hb_s.append(time.perf_counter() - t0)
                    tracker.sample(rtt_mod.COORD_KEY, self._hb_s[-1])
                except Exception as exc:  # noqa: BLE001 — an outage
                    now = time.monotonic()
                    fail_since = now if fail_since is None else fail_since
                    # the abort deadline, not the liveness window, bounds
                    # how long this rank may spin against a dead
                    # coordinator; a measured slow link widens it by the
                    # slack the coordinator grants, so that both sides
                    # give up alike
                    budget = (self._config.abort_timeout_seconds
                              or self._config.liveness_timeout_seconds)
                    if budget > 0:
                        budget += min(tracker.worst()
                                      * self._config.straggler_factor,
                                      budget)
                    if budget > 0 and now - fail_since > budget:
                        self._coordinator_lost(
                            f"coordinator unreachable for "
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
    def _coordinator_lost(self, reason):
        """Every path that finds the coordinator unreachable ends here:
        with fail-over armed the survivors race the rendezvous CAS
        election and its winning directive replaces the fatal abort;
        else (or when the election cannot be won) the abort names rank
        0."""
        directive = self._try_failover(reason)
        self._local_abort(0, directive if directive is not None
                          else reason)

    def _try_failover(self, reason):
        """The fail-over election (``elastic/election.py``): -> the
        winning directive, or None when fail-over is off, rank 0 is this
        process (then it is the casualty), a verdict has already landed,
        there is no rendezvous, the survivors would be below
        ``min_ranks``, or the election cannot be won within
        ``HVD_TPU_ELECTION_TIMEOUT``."""
        config = self._config
        if not (config.coord_failover and config.elastic):
            return None
        if self.rank == 0 or self.size <= 1:
            return None
        if self.abort_state() is not None:
            return None
        addr = env_util.get_str(env_util.HVD_RENDEZVOUS_ADDR)
        port = env_util.get_str(env_util.HVD_RENDEZVOUS_PORT)
        if addr is None or port is None:
            return None
        if len(self.members) - 1 < config.min_ranks:
            _log.error("fail-over: %d survivors < --min-ranks %d; "
                       "coordinator loss is fatal",
                       len(self.members) - 1, config.min_ranks)
            return None
        from horovod_tpu_torch.elastic import election

        return election.elect(
            addr, int(port), self.epoch, self.members, reason,
            proposer_wid=self.members[self.rank],
            timeout=config.election_timeout_seconds)

    def request_drain(self):
        """Announce this rank's planned departure to the coordinator and
        wait for its verdict.  True: a reconfiguration without this rank
        is on its way, keep running until the directive comes.  False:
        the drain is not survivable (one rank, elastic off, rank 0
        without fail-over, too few survivors)."""
        if self.size <= 1 or self._mux is None or self._refused:
            return False
        try:
            # the coordinator's boundary wait is at most 5 s; the rest
            # is room for a loaded control plane
            reply = self._mux.send(DrainMsg(self.rank), timeout=30.0)
        except Exception as exc:  # noqa: BLE001 — a dead coordinator
            _log.warning("drain announce failed: %s", exc)
            return False
        return bool(getattr(reply, "ok", False))

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
    def close_for_reconfig(self):
        """Take this epoch's plane down so that the next epoch's can be
        made: no ``ShutdownMsg`` (the coordinator it would leave belongs
        to the world being torn down); rank 0 has already waited, in its
        local abort, until every live peer was handed the directive."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        if self._mux is not None:
            self._mux.close()
            self._mux = None
        if self._coordinator is not None:
            self._coordinator.shutdown()
            self._coordinator = None

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
