"""The eager plane's background cycle: negotiation, validation, response
cache, fusion, join and the stall warning.

Port of ``horovod_tpu/ops/python_controller.py:41-746`` (the semantics)
for ranks that are OS processes, as ``ops/tcp_controller.py`` negotiates
across processes in the JAX package.  Every ``HVD_CYCLE_TIME`` ms each
rank's cycle thread

1. contributes the signatures of its newly submitted requests (type,
   name, dtype, shape, op, root, scales, splits, compression; for a name
   the response cache holds with the same signature, the entry's id in
   their place), its join flag and its shutdown flag: pickled, signed
   with the job key (HMAC-SHA256, ``run/service/secret.py``) and sent to
   rank 0's coordinator over the HMAC-framed TCP control plane
   (``ops/tcp_controller.py``), which answers with every rank's message
   for the cycle, in rank order; each rank checks every message's
   digest before it unpickles any, and a digest that does not verify
   fails the cycle with an error naming the sender;
2. adds them to a table of names that every rank holds identically (the
   same gathered data, absorbed in the same order), and takes, in the
   table's order, the names that every rank that has not joined has
   submitted;
3. validates each with the rules and messages of the reference's
   ``validate_requests`` (a name whose every rank repeats the signature
   it was last validated with skips validation: the response cache); an
   error fails that name's handles and nothing else;
4. fuses the allreduces by ``allreduce_bucket_key`` through
   ``plan_buckets`` up to ``HVD_FUSION_THRESHOLD`` bytes, and runs the
   collectives in that order on the data plane
   (:class:`~horovod_tpu_torch.ops.nccl_executor.Executor`).  An Adasum
   request (``RequestType.ADASUM``) is validated as an allreduce and run
   on its own, never fused (reference: ``python_controller.py:530-540,
   694-695``).

Process groups (``horovod_tpu_torch.groups``): a request's group id is
part of its signature, and the table, the response cache and the
duplicate check are keyed by (group id, name), so the same name in two
groups is two negotiations; the group id is in ``allreduce_bucket_key``,
so two groups' tensors never fuse.  A group's name is ready when every
member has submitted it (joins are the world's: a group takes no zeros
for a joined rank).  The members travel in the signature, so every rank
decides readiness from the gathered data alone, also a rank that has not
made the group yet (ranks make groups at different times), and the
response cache stays the same on every rank.  Every rank absorbs every group's entries, since the
exchange is over the world, but only members run them: on an executor of
the group's own, over the group's eager-plane communicator and a stream
of its own, so that disjoint groups' collectives are in flight at once.
Each cycle records the number of distinct groups with entries open
(``groups.note_inflight``).

Since every rank computes the same responses from the same data, the
coordinator only relays: it decides nothing about the collectives.  A
rank that has joined contributes zeros to the allreduces of the others;
``join`` completes, with the last rank to join, when every rank has
joined and no name is pending.  Shutdown is a flag in the cycle too:
every rank leaves the loop in the cycle in which all of them have asked
for it.

At one rank the cycle needs no communication: the thread sleeps on a
condition variable while nothing is queued, and runs a cycle as soon as
something is.  Above one rank an idle plane backs off: once
``_IDLE_CYCLES`` cycles in a row have had no rank send anything and no
name pending (every rank knows it from the same data), each next cycle
waits twice as long as the last, up to ``_IDLE_WAIT_S``.  A rank with new
work starts its cycle at once and waits in the exchange for the others,
so the first op after a long idle spell waits up to that long; ops a few
cycles apart, such as ``SyncBatchNorm``'s, never meet the backoff.

Faults (``ops/tcp_controller.py``).  A coordinated abort, whatever its
origin (a dead rank, the stall shutdown, ``hvd.abort()``, a lost
coordinator), reaches :meth:`Controller.abort`: the queue, every
outstanding handle, the requests a fault spec dropped and a pending
``join`` fail with the typed :class:`HvdAbortedError`, a blocked
``drain`` raises it, and so does every later submission.  The stall
check promotes an entry older than ``HVD_STALL_SHUTDOWN_TIME_SECONDS``
(when set) into such an abort, naming the first lagging member (the
reference's rule, ``python_controller.py:730-746``).  A collective whose
communication breaks waits for the coordinator's verdict before its
handles fail, so that a survivor names the rank that died, not itself.  Fault
sites: each request's type at submit (``ops/eager.py``), and ``ring``
just before :meth:`Executor.run <horovod_tpu_torch.ops.nccl_executor.
Executor.run>` issues a negotiated collective.

Timeline (``HVD_TIMELINE``, ``utils/timeline.py``), at the JAX
package's span sites (``python_controller.py:335, 343, 381, 702-706``):
``NEGOTIATE_<OP>`` on a name's row from the cycle its name first enters
the table to the cycle it is ready, with one tick a rank (named by the
rank) as that rank's submission shows up in the gathered cycle; ``<OP>``
from the moment this rank issues the collective to the moment it
completes, on the card when the plane's stream reaches the run's event
(the timeline's completion thread waits for it, never this thread),
ending with ``{"bytes": ...}`` of the output; ``CYCLE`` marks under
``HVD_TIMELINE_MARK_CYCLES``.

Autotune (``HVD_AUTOTUNE``, ``ops/autotune.py``): rank 0 owns the
tuner.  It records the bytes of each cycle's executed responses and
ticks the score window in that cycle; a new ``(seq, params)`` rides in
rank 0's next cycle message.  Every rank applies it at one fixed point:
in the cycle that carries it, once every message is absorbed and before
readiness, validation and fusion are decided.  The gathered cycle is the
same on every rank, so every rank cuts the same buckets and runs the
same schedule (a rank running hierarchically beside a flat one would
pair mismatched collectives and hang).  The values: the fusion
threshold, the cycle time, the world executor's hierarchical allreduce
and allgather, the response cache (ids stop travelling and every name
validates) and the default compression of later submissions.

Ordering against ``DistributedOptimizer``: the optimizer's collectives
run on the default process group from the caller's thread, the plane's
on a communicator of its own from the cycle thread.  NCCL can deadlock
when ranks launch the operations of two communicators in different
orders.  :meth:`Controller.drain`, which the optimizer calls before each
of its collectives, waits until the plane has issued every request this
rank submitted, and on the card makes the caller's stream wait for the
plane's: so a rank launches the two groups' collectives in its program's
order, the same on every rank that runs the same program.
"""

import collections
import dataclasses
import logging
import math
import pickle
import threading
import time
import typing

import torch

from horovod_tpu_torch import groups
from horovod_tpu_torch.common import faults
from horovod_tpu_torch.common.fusion import plan_buckets
from horovod_tpu_torch.common.handles import (Handle, HvdAbortedError,
                                              make_abort_error)
from horovod_tpu_torch.common.ops_enum import ReduceOp, RequestType
from horovod_tpu_torch.common.response_cache import SignatureCache
from horovod_tpu_torch.ops.autotune import AutotuneManager, default_params
from horovod_tpu_torch.ops.nccl_executor import Executor
from horovod_tpu_torch.run.service import secret

_log = logging.getLogger("horovod_tpu_torch")
SHUT_DOWN = "horovod_tpu_torch has been shut down"
# an idle plane above one rank backs off after this many idle cycles in
# a row (about 50 ms at four ranks), to one cycle per _IDLE_WAIT_S
_IDLE_CYCLES = 16
_IDLE_WAIT_S = 0.05


class Signature(typing.NamedTuple):
    """What a rank says about one named request in the negotiation; what
    validation checks and what the response cache compares."""

    req_type: RequestType
    dtype: str
    shape: tuple
    op: ReduceOp = ReduceOp.SUM
    root_rank: int = -1
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    splits: tuple = None
    compression: str = "none"
    group: str = ""     # the process group's id; "" is the world
    group_ranks: tuple = None   # its members, in group order


@dataclasses.dataclass
class Request:
    """One rank's submission: the signature, the tensor (aliased until the
    handle completes), its handle and, on the card, the stream it was
    submitted from and the event its value is ready at."""

    sig: Signature
    name: str
    tensor: torch.Tensor
    handle: Handle
    stream: object = None
    ready: object = None


def dtype_name(dtype):
    """numpy's name for a torch dtype (``torch.bfloat16`` -> ``bfloat16``),
    the names the reference's messages use."""
    return str(dtype).replace("torch.", "")


def validate(name, sigs, *, size, joined):
    """Cross-rank agreement rules of the reference
    (``python_controller.py:507-587``, ``controller.cc:378``); ``sigs``
    maps rank -> :class:`Signature`.  -> an error message, or None."""
    sv = list(sigs.values())
    types = {s.req_type for s in sv}
    if len(types) > 1:
        return (f"mismatched collective types for tensor '{name}': "
                f"{sorted(t.name for t in types)}")
    req_type = next(iter(types))
    if joined and req_type in (RequestType.ALLGATHER, RequestType.BROADCAST,
                               RequestType.ALLTOALL,
                               RequestType.REDUCE_SCATTER):
        return f"{req_type.name} is not supported while ranks have joined"
    dtypes = {s.dtype for s in sv}
    if len(dtypes) > 1:
        return f"mismatched dtypes for tensor '{name}': {sorted(dtypes)}"
    if req_type in (RequestType.ALLREDUCE, RequestType.ADASUM,
                    RequestType.REDUCE_SCATTER):
        if len({s.op for s in sv}) > 1:
            return f"mismatched reduce ops for tensor '{name}'"
        if len({s.prescale_factor for s in sv}) > 1 \
                or len({s.postscale_factor for s in sv}) > 1:
            return f"mismatched scale factors for tensor '{name}'"
    shapes = {s.shape for s in sv}
    if req_type in (RequestType.ALLREDUCE, RequestType.ADASUM):
        if len(shapes) > 1:
            return (f"mismatched shapes for allreduce '{name}': "
                    f"{sorted(shapes)}")
    elif req_type == RequestType.ALLGATHER:
        ndims = {len(s) for s in shapes}
        if len(ndims) > 1:
            return f"mismatched tensor ranks for allgather '{name}'"
        if 0 in ndims:
            return (f"allgather '{name}': 0-d tensors are not supported; "
                    f"reshape to (1,) first")
        if len({s[1:] for s in shapes}) > 1:
            return f"mismatched trailing dimensions for allgather '{name}'"
    elif req_type == RequestType.BROADCAST:
        if len({s.root_rank for s in sv}) > 1:
            return f"mismatched root ranks for broadcast '{name}'"
        if len(shapes) > 1:
            return f"mismatched shapes for broadcast '{name}'"
    elif req_type == RequestType.REDUCE_SCATTER:
        if () in shapes:
            return (f"reduce_scatter '{name}': 0-d tensors are not "
                    f"supported; reshape to (1,) first")
        if len(shapes) > 1:
            return (f"mismatched shapes for reduce_scatter '{name}': "
                    f"{sorted(shapes)}")
    elif req_type == RequestType.ALLTOALL:
        for s in sv:
            if len(s.splits) != size:
                return (f"alltoall '{name}': splits must have one entry per "
                        f"rank ({size}), got {len(s.splits)}")
            if sum(s.splits) != (s.shape[0] if s.shape else 0):
                return (f"alltoall '{name}': splits sum {sum(s.splits)} != "
                        f"first dimension {s.shape[0] if s.shape else 0}")
    return None


def allreduce_bucket_key(sig):
    """Allreduces fuse only with their like (reference:
    ``python_controller.py:608``): dtype, op, scales, compression and
    process group."""
    return (sig.dtype, int(sig.op), sig.prescale_factor,
            sig.postscale_factor, sig.compression, sig.group)


class _Entry:
    __slots__ = ("sigs", "first_ts", "stall_warned")

    def __init__(self):
        self.sigs = {}
        self.first_ts = time.monotonic()
        self.stall_warned = False


class Controller:
    """One rank's side of the negotiation; see the module docstring."""

    def __init__(self, rank, size, plane, executor, key, config,
                 timeline=None):
        """``plane``: the control plane
        (``ops/tcp_controller.py::ControlPlane``) the cycle messages are
        exchanged over and the job's abort comes from; ``key``: the job
        key they are signed with; ``config``: the knobs
        (``common/config.py::Config``); ``timeline``: a
        ``utils/timeline.py::Timeline``, or None."""
        self.rank = rank
        self.size = size
        self._plane = plane
        self._executor = executor
        self._key = key
        self._config = config
        self._timeline = timeline
        executor.hierarchical_allreduce = config.hierarchical_allreduce
        executor.hierarchical_allgather = config.hierarchical_allgather
        # the default compression of later submissions (ops/eager.py),
        # which the tuner may switch off and on
        self.compression = config.compression
        self._cycle_s = config.cycle_time_ms / 1e3
        self._threshold = config.fusion_threshold_bytes
        self._stall_s = (None if config.stall_check_disable
                         else config.stall_warning_seconds)
        self._stall_shutdown_s = config.stall_shutdown_seconds
        self._cache = SignatureCache(config.cache_capacity)
        lock = threading.Lock()
        self._cond = threading.Condition(lock)      # work for the cycle
        self._drained = threading.Condition(lock)   # _in_flight fell to 0
        # guarded by the lock
        self._queue = []
        self._in_flight = 0     # this rank's requests not yet issued
        self._issued = set()    # streams issued on since the last drain
        self._join_handle = None
        self._held = []         # handles of requests a fault spec dropped
        self._stopping = False
        self._running = False
        self._error = None
        # the cycle thread's own
        self._local = {}        # (gid, name) -> this rank's Request
        self._table = collections.OrderedDict()   # (gid, name) -> _Entry
        self._group_executors = {}                # gid -> Executor
        self._joined = []       # ranks in the order they joined
        self._negotiation_s = collections.deque(maxlen=1000)
        self._hmac_s = collections.deque(maxlen=1000)
        self.cycles = 0         # cycles run, idle ones too
        self._thread = None
        # autotune: rank 0's tuner, its publication for the next cycle
        # message, and on every rank the values applied and when
        self._autotune = AutotuneManager.create(config) if rank == 0 \
            else None
        self._publish = None
        self._tuned = None
        self._tuned_log = []    # (cycle, seq) of each application

    @property
    def cache_hits(self):
        return self._cache.hits

    def is_running(self):
        return self._thread is not None and self._thread.is_alive()

    def negotiation_times(self):
        """Seconds of the last (up to 1000) cycles' negotiation: the
        exchange through the coordinator and the decision, without the
        collectives."""
        return list(self._negotiation_s)

    def hmac_times(self):
        """Seconds each of the last (up to 1000) exchanges spent signing
        this rank's message and checking every rank's."""
        return list(self._hmac_s)

    def tuned_params(self):
        """The knob values in force: the last tuned set applied, else the
        configured ones (``ops/autotune.py::default_params``); the JAX
        package's keys without ``ring_segment_bytes``, ``ring_stripes``
        and ``schedule``."""
        tuned = self._tuned
        return dict(tuned) if tuned is not None \
            else default_params(self._config)

    def tuned_applications(self):
        """``(cycle, seq)`` of every tuned set applied on this rank: the
        same list on every rank."""
        return list(self._tuned_log)

    # ---------------------------------------------------------- user side
    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-cycle")
        self._thread.start()

    def _failure_locked(self):  # holds: self._cond
        """Why a new request cannot be taken (a message, or the job's
        abort as ``(origin, reason)``), or None."""
        state = self._plane.abort_state()
        if state is not None:
            return state
        if not self._running or self._stopping:
            return SHUT_DOWN
        return self._error

    def enqueue(self, requests):
        """Queue requests together: one cycle takes all of them."""
        with self._cond:
            failure = self._failure_locked()
            if failure is None:
                self._queue.extend(requests)
                self._in_flight += len(requests)
                self._cond.notify()
        if failure is not None:
            for req in requests:
                req.handle.set_error(_error(failure))

    def hold(self, req):
        """A request that a fault spec dropped: it never reaches the
        negotiation, and its handle fails with the job's abort."""
        with self._cond:
            self._held.append(req.handle)
            state = self._plane.abort_state()
        if state is not None:
            req.handle.set_error(make_abort_error(*state))

    def drain(self):
        """Block until every request this rank queued has been issued on
        the data plane, or has failed; on the card the caller's current
        stream then waits for the plane's stream.  See the module
        docstring: the optimizer calls it before its own collectives."""
        with self._cond:
            self._drained.wait_for(lambda: self._in_flight == 0)
            issued, self._issued = self._issued, set()
        state = self._plane.abort_state()
        if state is not None:
            raise make_abort_error(*state)
        for stream in issued:
            torch.cuda.current_stream(self._executor.device).wait_stream(
                stream)

    def join(self, handle):
        with self._cond:
            failure = self._failure_locked()
            if failure is None:
                self._join_handle = handle
                self._cond.notify()
        if failure is not None:
            handle.set_error(_error(failure))

    def shutdown(self, timeout=None):
        """Ask for the negotiated shutdown and wait for the cycle thread:
        it leaves when every rank has asked, or at once after an
        abort."""
        with self._cond:
            if not self._running:
                return
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout)
        with self._cond:
            self._running = False
        if self._autotune is not None:
            self._autotune.close()

    def abort(self, origin_rank, reason):
        """The job has aborted (``ControlPlane`` listener): fail the
        queue, the outstanding handles, the dropped requests and a
        pending ``join`` with the typed error, wake a blocked ``drain``
        and the cycle thread."""
        with self._cond:
            self._stopping = True
            self._cond.notify()
        self._fail_outstanding((origin_rank, reason))

    # -------------------------------------------------------- cycle thread
    def _take(self, wait_s):
        with self._cond:
            if wait_s is None:
                self._cond.wait_for(lambda: self._queue or self._stopping
                                    or self._join_handle is not None)
            elif not self._queue:
                self._cond.wait(wait_s)
            pending, self._queue = self._queue, []
            return (pending, self._join_handle is not None, self._stopping)

    def _settle(self, n, streams=()):
        """``n`` of this rank's requests were issued (or failed), on
        ``streams``."""
        with self._cond:
            # an abort may have zeroed the count under the cycle's feet
            self._in_flight = max(0, self._in_flight - n)
            self._issued.update(s for s in streams if s is not None)
            if self._in_flight == 0:
                self._drained.notify_all()

    def _loop(self):
        try:
            if self._executor.device.type == "cuda":
                # the thread's allocations and NCCL calls on this rank's card
                torch.cuda.set_device(self._executor.device)
            idle = 0   # cycles in a row in which nothing happened anywhere
            while True:
                backoff = max(0, idle - _IDLE_CYCLES)
                wait_s = None if self.size == 1 else max(
                    self._cycle_s, min(self._cycle_s * 2 ** backoff,
                                       _IDLE_WAIT_S))
                pending, joining, stopping = self._take(wait_s)
                t0 = time.perf_counter()
                new = []
                for req in pending:
                    key = (req.sig.group, req.name)
                    if key in self._local:
                        req.handle.set_error(
                            f"duplicate request for tensor '{req.name}' from "
                            f"rank {self.rank} before previous one completed")
                        self._settle(1)
                        continue
                    self._local[key] = req
                    cache_id = self._cache.id_of(key, req.sig)
                    new.append((req.name, req.sig) if cache_id is None
                               else cache_id)
                # rank 0's tuner publication rides in its message
                mine = (new, joining, stopping, self._publish)
                self._publish = None
                state = self._plane.abort_state()
                if state is not None:
                    raise make_abort_error(*state)
                msgs = [mine] if self.size == 1 else self._exchange(mine)
                if all(m[2] for m in msgs):
                    break
                if self._timeline is not None:
                    self._timeline.mark_cycle()
                if not self._cycle(msgs, t0):
                    break
                self.cycles += 1
                busy = self._table or any(any(m) for m in msgs)
                idle = 0 if busy else min(idle + 1, _IDLE_CYCLES + 16)
            state = self._plane.abort_state()
            self._fail_outstanding(SHUT_DOWN if state is None else state)
        except HvdAbortedError as exc:
            self._fail_outstanding((exc.origin_rank, exc.reason))
        except Exception as exc:  # noqa: BLE001 — the cycle cannot go on
            _log.exception("horovod_tpu_torch: eager cycle failed")
            message = f"horovod_tpu_torch eager cycle failed: {exc!r}"
            with self._cond:
                self._error = message
            self._fail_outstanding(message)

    def _exchange(self, mine):
        """Every rank's cycle message, in rank order, through the
        coordinator; each verified before the first is unpickled."""
        data = pickle.dumps(mine, protocol=pickle.HIGHEST_PROTOCOL)
        t0 = time.perf_counter()
        data = secret.sign(self._key, data) + data
        signing = time.perf_counter() - t0
        blobs = self._plane.exchange(data)
        t0 = time.perf_counter()
        payloads = []
        for r, blob in enumerate(blobs):
            digest = blob[:secret.DIGEST_LEN]
            payload = blob[secret.DIGEST_LEN:]
            if not secret.check(self._key, payload, digest):
                raise PermissionError(
                    f"the cycle message of rank {r} failed HMAC "
                    f"verification: its job key differs from rank "
                    f"{self.rank}'s (HVD_SECRET_KEY)")
            payloads.append(payload)
        self._hmac_s.append(signing + time.perf_counter() - t0)
        # every payload verified before the first is unpickled
        return [pickle.loads(payload) for payload in payloads]

    def _fail_outstanding(self, failure):
        """Fail what is queued, outstanding, held and joining with
        ``failure``: a message, or an abort's ``(origin, reason)``, each
        handle then with an error of its own.  Also runs on an abort
        listener's thread while the cycle thread may be blocked: the
        snapshot of ``_local`` below is taken in one step."""
        with self._cond:
            queued, self._queue = self._queue, []
            join, self._join_handle = self._join_handle, None
            held, self._held = self._held, []
        outstanding = tuple(self._local.values())
        for req in queued + list(outstanding):
            req.handle.set_error(_error(failure))
        for handle in held:
            handle.set_error(_error(failure))
        if threading.current_thread() is self._thread:
            self._local.clear()
            self._table.clear()
        with self._cond:
            self._in_flight = 0
            self._drained.notify_all()
        if join is not None:
            join.set_error(_error(failure))

    def _cycle(self, msgs, t0):
        tl = self._timeline
        for r, (new, joining, _, _) in enumerate(msgs):
            if joining and r not in self._joined:
                self._joined.append(r)
            for item in new:
                # a cache id is read back before anything below changes
                # the cache: every rank's copy is still the sender's
                if isinstance(item, int):
                    key, sig = self._cache.entry(item)
                else:
                    name, sig = item
                    key = (sig.group, name)
                entry = self._table.get(key)
                if entry is None:
                    entry = self._table[key] = _Entry()
                    if tl is not None:
                        tl.begin(key[1], f"NEGOTIATE_{sig.req_type.name}")
                entry.sigs[r] = sig
                if tl is not None:
                    tl.instant(key[1], str(r))
        if msgs[0][3] is not None:
            # the one point where every rank applies rank 0's tuned
            # values: the same cycle, before it is planned
            self._apply_tuned(*msgs[0][3])
        if self._table:
            groups.note_inflight(gid for gid, _ in self._table)
        if self._stall_s is not None and self._check_stalls():
            return False
        joined = set(self._joined)
        world = set(range(self.size)) - joined
        ready = [key for key, e in self._table.items()
                 if self._needed(e, world).issubset(e.sigs)]
        responses = []
        for key in ready:
            entry = self._table.pop(key)
            if tl is not None:
                tl.end(key[1])
            if joined or not self._cache.check(key, entry.sigs.values()):
                error = self._validate(key, entry.sigs, joined)
                if error is not None:
                    req = self._local.pop(key, None)
                    if req is not None:
                        req.handle.set_error(error)
                        self._settle(1)
                    continue
                if not joined:
                    self._cache.store(key, entry.sigs.values())
            responses.append((key, entry.sigs))
        self._negotiation_s.append(time.perf_counter() - t0)
        self._dispatch(responses, joined)
        if len(joined) == self.size and not self._table:
            last = self._joined[-1]
            self._joined = []
            with self._cond:
                handle, self._join_handle = self._join_handle, None
            if handle is not None:
                handle.set_result(last)
        return True

    def _apply_tuned(self, seq, params):
        """Put a tuned set in force (see the module docstring): every
        rank calls it in the same cycle."""
        self._tuned = dict(params)
        self._tuned_log.append((self.cycles, seq))
        self._threshold = params["fusion_threshold_bytes"]
        self._cycle_s = params["cycle_time_ms"] / 1e3
        self._executor.hierarchical_allreduce = \
            params["hierarchical_allreduce"]
        self._executor.hierarchical_allgather = \
            params["hierarchical_allgather"]
        self._cache.enabled = params["cache_enabled"]
        self.compression = params["compression"]

    @staticmethod
    def _needed(entry, world):
        """The ranks whose submissions make a name ready: a group's
        members, or the world's ranks that have not joined."""
        granks = next(iter(entry.sigs.values())).group_ranks
        return world if granks is None else set(granks)

    def _validate(self, key, sigs, joined):
        gid, name = key
        if not gid:
            return validate(name, sigs, size=self.size, joined=bool(joined))
        sig = next(iter(sigs.values()))
        granks = sig.group_ranks
        error = validate(name, sigs, size=len(granks), joined=False)
        root = sig.root_rank
        if error is None and sig.req_type == RequestType.BROADCAST \
                and root not in granks:
            error = (f"broadcast '{name}': root rank {root} is not a member "
                     f"of the process group (ranks {list(granks)})")
        return error

    def _check_stalls(self):
        """Warn of an entry older than the stall warning; abort the job
        for one older than the stall shutdown.  -> True if it aborted."""
        now = time.monotonic()
        world = set(range(self.size)) - set(self._joined)
        shutdown = self._stall_shutdown_s
        for (_, name), entry in self._table.items():
            age = now - entry.first_ts
            if age > self._stall_s and not entry.stall_warned:
                ready = sorted(entry.sigs)
                missing = sorted(self._needed(entry, world) - set(ready))
                _log.warning(
                    "One or more tensors were submitted to be reduced, "
                    "gathered or broadcasted by subset of ranks and are "
                    "waiting for remainder of ranks for more than %ds. "
                    "Stalled tensor: %s ready ranks: %s, waiting on: %s",
                    int(self._stall_s), name, ready, missing)
                entry.stall_warned = True
            if shutdown > 0 and age > shutdown:
                # promoted from a log line into a coordinated abort: one
                # typed error on every rank, naming the first lagging
                # rank; a group's entry names its lagging member, and
                # the abort still fails the whole job
                missing = sorted(self._needed(entry, world)
                                 - set(entry.sigs))
                origin = missing[0] if missing else -1
                self._plane.abort(
                    origin, f"stalled tensor '{name}' exceeded shutdown "
                            f"threshold of {shutdown}s (waiting on ranks "
                            f"{missing})")
                return True
        return False

    # ----------------------------------------------------------- execution
    def _dispatch(self, responses, joined):
        def key(item):
            name, sigs = item
            sig = next(iter(sigs.values()))
            if sig.req_type != RequestType.ALLREDUCE:
                return ("single", name)
            return allreduce_bucket_key(_agreed(sigs))

        def nbytes(item):
            sig = next(iter(item[1].values()))
            return _itemsize(sig.dtype) * math.prod(sig.shape)

        # the handles complete together once every collective of the
        # cycle is issued: a caller woken per bucket would contend with
        # this thread for the interpreter lock until it blocks again
        done, mine, streams = [], 0, set()
        for bucket in plan_buckets(responses, key_fn=key, nbytes_fn=nbytes,
                                   threshold=self._threshold):
            sig = _agreed(bucket[0][1])
            if sig.group and self.rank not in sig.group_ranks:
                continue   # another group's collective
            reqs = [self._local.pop(k, None) for k, _ in bucket]
            mine += sum(req is not None for req in reqs)
            ex = self._executor_for(sig)
            streams.add(ex.stream)
            try:
                done += self._execute(ex, bucket, reqs)
            except Exception as exc:  # noqa: BLE001 — surfaced on handles
                # a peer that died mid-collective breaks it here too:
                # wait for the coordinator to name the origin
                state = self._plane.verdict(exc)
                if state is None:
                    _log.exception("horovod_tpu_torch: collective failed")
                for req in reqs:
                    if req is not None:
                        req.handle.set_error(
                            make_abort_error(*state) if state is not None
                            else f"collective execution failed: {exc!r}")
        for req, out, event in done:
            req.handle.set_result(out, event)
        if mine:
            self._settle(mine, streams)
        if self._autotune is not None and responses:
            # rank 0 scores the negotiated bytes; a new set rides in its
            # next cycle message
            self._autotune.record(sum(nbytes(item) for item in responses))
            update = self._autotune.maybe_update()
            if update is not None:
                self._publish = update

    def _executor_for(self, sig):
        """The world's executor, or the group's own (made at its first
        collective)."""
        if not sig.group:
            return self._executor
        ex = self._group_executors.get(sig.group)
        if ex is None:
            granks = list(sig.group_ranks)
            ex = self._group_executors[sig.group] = Executor(
                groups.plane_group(sig.group), granks.index(self.rank),
                len(granks), self._executor.device)
        return ex

    def _execute(self, ex, bucket, reqs):
        """Issue one bucket's collective on ``ex``; -> (request, result,
        event) of each of this rank's requests in it."""
        sig = _agreed(bucket[0][1])
        order = sig.group_ranks or range(self.size)
        # "ring": after the go-ahead, the peers already inside the
        # collective; a drop leaves this rank's part out
        if faults.check("ring"):
            for req in reqs:
                if req is not None:
                    self.hold(req)
            return []
        tl = self._timeline
        begin = tl.now() if tl is not None else None
        with ex.run(reqs) as run:
            if sig.req_type == RequestType.ALLREDUCE:
                shapes = [_agreed(sigs).shape for _, sigs in bucket]
                outs = ex.allreduce(
                    [r.tensor if r is not None else None for r in reqs],
                    shapes, _torch_dtype(sig.dtype), sig.op,
                    sig.prescale_factor, sig.postscale_factor,
                    sig.compression)
                results = list(zip(reqs, outs))
                run.outputs = [(r, [o]) for r, o in results if r is not None]
            else:
                (name, sigs), req = bucket[0], reqs[0]
                t = None if req is None else req.tensor
                if sig.req_type == RequestType.ADASUM:
                    # one tensor, a joined rank's zeros included
                    out = ex.adasum(t, sig.shape, _torch_dtype(sig.dtype))
                elif sig.req_type == RequestType.ALLGATHER:
                    out = ex.allgather(t, [sigs[r].shape[0] for r in order])
                elif sig.req_type == RequestType.BROADCAST:
                    out = ex.broadcast(t, sig.root_rank)
                elif sig.req_type == RequestType.ALLTOALL:
                    out = ex.alltoall(t, [sigs[r].splits for r in order])
                else:
                    out = ex.reduce_scatter(
                        t, sig.op, sig.prescale_factor, sig.postscale_factor,
                        sig.compression)
                results = [(req, out)]
                run.outputs = [(req, [out[0] if isinstance(out, tuple)
                                      else out])] if req is not None else []
        if tl is not None:
            for req, outs in run.outputs:
                tl.span_after(req.name, sig.req_type.name, begin, run.done,
                              {"bytes": sum(o.numel() * o.element_size()
                                            for o in outs)})
        return [(req, out, run.done) for req, out in results
                if req is not None]


def _error(failure):
    """A handle's error for ``failure``: a message, or an abort's
    ``(origin, reason)`` (a fresh typed error for each handle)."""
    if isinstance(failure, tuple):
        return make_abort_error(*failure)
    return failure


def _agreed(sigs):
    """The signature every rank agreed on, compression aside: a
    disagreement on compression resolves to the exact wire (reference:
    ``resolve_group_compression``)."""
    first = next(iter(sigs.values()))
    if len({s.compression for s in sigs.values()}) > 1:
        return first._replace(compression="none")
    return first


_DTYPES = {dtype_name(d): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool)}


def _torch_dtype(name):
    return _DTYPES[name]


def _itemsize(name):
    return _DTYPES[name].itemsize
