"""Deterministic fault injection for the collective runtime (port of
``horovod_tpu/common/faults.py``: the grammar, its error texts, the
injector and its seed contract, unchanged).

``HVD_TPU_FAULT_SPEC`` holds a comma-separated list of fault specs; each
spec triggers one failure at an exact step of an instrumented point, so
tests and chaos runs (``python -m horovod_tpu_torch.run.chaos``) can
reproduce a failure mode bit for bit:

    HVD_TPU_FAULT_SPEC="rank1:allreduce:2:crash,*:connect:1:refuse"

Grammar (one spec)::

    <target>:<point>:<step>:<action>[:<param>[:<duration_s>]]

    target  rank<N> — only rank N trips the fault; * — any rank
    point   an instrumented site name.  The port's sites:
              allreduce / broadcast / allgather / alltoall / adasum /
              reduce_scatter
                  the eager plane's submit, before negotiation
                  (``ops/eager.py``); ``allreduce`` also at each of
                  ``DistributedOptimizer``'s bucket starts
              ring      the plane's issue of a negotiated collective,
                        just before the NCCL (or gloo) call: the peers
                        are already inside the collective
              connect   every control-plane TCP connection attempt
                        (``run/service/network.py::connect``)
              link      every client-side control-plane frame write
    step    1-based hit count of that point in this process: the fault
            fires on exactly the step-th call
    action  crash   — hard-exit the process (os._exit(1)): a dead rank
            drop    — silently skip the operation: a silent worker
            refuse  — raise ConnectionRefusedError: a transport blip
            preempt — SIGTERM to self: the preemption notice

Degraded-network actions arm at the step-th hit of their point and then
degrade every client-side frame write for ``duration_s`` seconds
(omitted: the rest of the run):

    delay:<ms>        add a fixed sleep before every frame write
    jitter:<ms>       add a uniform [0, ms) sleep before every write
    throttle:<MBps>   pace writes to at most MBps megabytes/second
    flaky:<p>         drop each write with probability p (the transport
                      resends: nothing left the socket)
    partition:<lo-hi> cut every link that crosses the rank-range
                      boundary [lo, hi]

Mid-stream actions arm the same way (step ``*`` allowed: armed from
the start) and cut a control-plane connection mid-frame, the break the
session layer (``run/service/network.py``) heals inside
``HVD_TPU_RECONNECT_BUDGET``:

    reset:<p>[:<duration_s>]  cut each frame write with probability p
    blip:<ms>                 cut the next frame write toward a peer,
                              and refuse connects toward it for ms

The ``send`` / ``recv`` points (the reference's ring chunk transport)
are parsed exactly as the reference parses them, but have no site in
the port: NCCL, not a TCP data plane, carries the port's bytes (ROADMAP
A.13e).

Degradations are deterministic under the seed contract: the
flaky/jitter/reset RNG is seeded from the spec text and the rank, so
the same spec on the same rank rolls the same sequence.

Counters are per-process and per-point.  The module is inert (one dict
lookup per check, one attribute read per frame write) when no spec is
configured.
"""

import math
import os
import random
import signal
import sys
import threading
import time
import zlib

_ACTIONS = ("crash", "drop", "refuse", "preempt")
# parameterized, duration-scoped degradations (arm-and-stay, not
# fire-once); applied at the framing layer via link()
_DEGRADE_ACTIONS = ("delay", "jitter", "throttle", "flaky", "partition")
# mid-stream link breaks: armed like degradations, but they sever the
# connection AFTER bytes hit the wire so the session layer's
# reconnect + replay path is what absorbs them
_MIDSTREAM_ACTIONS = ("reset", "blip")


class FaultSpec:
    __slots__ = ("rank", "point", "step", "action", "param", "duration")

    def __init__(self, rank, point, step, action, param=None,
                 duration=None):
        self.rank = rank        # int, or None for "*"
        self.point = point
        self.step = step
        self.action = action
        self.param = param      # float, or (lo, hi) for partition
        self.duration = duration  # seconds the degradation stays armed

    def __repr__(self):
        target = "*" if self.rank is None else f"rank{self.rank}"
        step = "*" if self.step is None else self.step
        base = f"{target}:{self.point}:{step}:{self.action}"
        if self.action in _DEGRADE_ACTIONS + _MIDSTREAM_ACTIONS:
            if self.action == "partition":
                base += f":{self.param[0]}-{self.param[1]}"
            else:
                base += f":{self.param:g}"
            if self.duration is not None:
                base += f":{self.duration:g}"
        return base


def _parse_degrade_param(part, action, text):
    if action == "partition":
        lo, sep, hi = text.partition("-")
        try:
            lo_i, hi_i = int(lo), int(hi)
        except ValueError:
            raise ValueError(
                f"fault spec {part!r}: partition wants <lo>-<hi> rank "
                f"range, got {text!r}") from None
        if not sep or lo_i < 0 or hi_i < lo_i:
            raise ValueError(
                f"fault spec {part!r}: partition wants <lo>-<hi> with "
                f"0 <= lo <= hi")
        return (lo_i, hi_i)
    try:
        value = float(text)
    except ValueError:
        raise ValueError(
            f"fault spec {part!r}: {action} wants a numeric parameter, "
            f"got {text!r}") from None
    # float() happily parses "nan"/"inf", and nan slides through every
    # one-sided range check below (nan < 0 is False) — a nan delay
    # would reach time.sleep() and crash the transport write path
    if not math.isfinite(value):
        raise ValueError(
            f"fault spec {part!r}: {action} parameter must be finite, "
            f"got {text!r}")
    if action == "flaky":
        if not 0.0 <= value <= 1.0:
            raise ValueError(
                f"fault spec {part!r}: flaky probability must be in "
                f"[0, 1], got {value:g}")
    elif action == "throttle":
        if value <= 0:
            raise ValueError(
                f"fault spec {part!r}: throttle rate must be > 0 MBps")
    elif value < 0:
        raise ValueError(
            f"fault spec {part!r}: {action} must be >= 0 ms")
    return value


def parse_fault_spec(text):
    """Parse a spec string into FaultSpec objects; raises ValueError with
    the offending fragment so a typo fails the job at init, not at the
    (never-reached) injection point."""
    specs = []
    for part in (p.strip() for p in (text or "").split(",")):
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 4:
            raise ValueError(
                f"fault spec {part!r}: expected "
                f"<target>:<point>:<step>:<action>[:<param>"
                f"[:<duration_s>]]")
        target, point, step_s, action = fields[:4]
        if target == "*":
            rank = None
        elif target.startswith("rank"):
            try:
                rank = int(target[4:])
            except ValueError:
                raise ValueError(
                    f"fault spec {part!r}: bad target {target!r}") from None
        else:
            raise ValueError(
                f"fault spec {part!r}: target must be rank<N> or *")
        if step_s == "*":
            # "armed from the first hit" only makes sense for the
            # mid-stream breaks — every other action fires exactly once
            if action not in _MIDSTREAM_ACTIONS:
                raise ValueError(
                    f"fault spec {part!r}: step * is only valid for "
                    f"{'/'.join(_MIDSTREAM_ACTIONS)}")
            step = None
        else:
            try:
                step = int(step_s)
            except ValueError:
                raise ValueError(
                    f"fault spec {part!r}: step must be an integer "
                    f"or *") from None
            if step < 1:
                raise ValueError(f"fault spec {part!r}: step is 1-based")
        if not point:
            raise ValueError(f"fault spec {part!r}: empty point")
        param = duration = None
        if action in _DEGRADE_ACTIONS:
            if len(fields) not in (5, 6):
                raise ValueError(
                    f"fault spec {part!r}: {action} wants "
                    f"<target>:<point>:<step>:{action}:<param>"
                    f"[:<duration_s>]")
            param = _parse_degrade_param(part, action, fields[4])
            if len(fields) == 6:
                try:
                    duration = float(fields[5])
                except ValueError:
                    raise ValueError(
                        f"fault spec {part!r}: duration must be "
                        f"seconds") from None
                if not math.isfinite(duration) or duration <= 0:
                    raise ValueError(
                        f"fault spec {part!r}: duration must be > 0")
        elif action == "reset":
            if len(fields) not in (5, 6):
                raise ValueError(
                    f"fault spec {part!r}: reset wants "
                    f"<target>:<point>:<step>:reset:<p>[:<duration_s>]")
            try:
                param = float(fields[4])
            except ValueError:
                raise ValueError(
                    f"fault spec {part!r}: reset wants a probability, "
                    f"got {fields[4]!r}") from None
            if not math.isfinite(param) or not 0.0 <= param <= 1.0:
                raise ValueError(
                    f"fault spec {part!r}: reset probability must be in "
                    f"[0, 1], got {param:g}")
            if len(fields) == 6:
                try:
                    duration = float(fields[5])
                except ValueError:
                    raise ValueError(
                        f"fault spec {part!r}: duration must be "
                        f"seconds") from None
                if not math.isfinite(duration) or duration <= 0:
                    raise ValueError(
                        f"fault spec {part!r}: duration must be > 0")
        elif action == "blip":
            if len(fields) != 5:
                raise ValueError(
                    f"fault spec {part!r}: blip wants "
                    f"<target>:<point>:<step>:blip:<window_ms>")
            try:
                param = float(fields[4])
            except ValueError:
                raise ValueError(
                    f"fault spec {part!r}: blip wants a window in ms, "
                    f"got {fields[4]!r}") from None
            if not math.isfinite(param) or param < 0:
                raise ValueError(
                    f"fault spec {part!r}: blip window must be >= 0 ms")
        elif action in _ACTIONS:
            if len(fields) != 4:
                raise ValueError(
                    f"fault spec {part!r}: {action} takes no parameter")
        else:
            raise ValueError(
                f"fault spec {part!r}: action must be one of "
                f"{_ACTIONS + _DEGRADE_ACTIONS + _MIDSTREAM_ACTIONS}")
        specs.append(FaultSpec(rank, point, step, action, param=param,
                               duration=duration))
    return specs


class LinkState:
    """Per-frame-write verdict aggregated over the armed degradations.

    ``delay_s`` is the resolved sleep for THIS write (fixed delays plus
    the jitter roll); ``throttle_bps`` is the tightest armed pacing rate
    in bytes/second (0: unthrottled); ``drop`` is the flaky roll for
    this write; ``partitioned`` means the (rank, peer) link crosses an
    armed partition boundary and the write must fail outright; ``reset``
    means the transport must sever the connection MID-FRAME (partial
    prefix on the wire, hard close, ConnectionResetError) so the
    session layer's reconnect + replay path absorbs it."""

    __slots__ = ("delay_s", "throttle_bps", "drop", "partitioned",
                 "reset")

    def __init__(self, delay_s=0.0, throttle_bps=0.0, drop=False,
                 partitioned=False, reset=False):
        self.delay_s = delay_s
        self.throttle_bps = throttle_bps
        self.drop = drop
        self.partitioned = partitioned
        self.reset = reset

    def __bool__(self):
        return bool(self.delay_s or self.throttle_bps or self.drop
                    or self.partitioned or self.reset)


class FaultInjector:
    """Counts hits per point and returns the matching action, if any.

    Degradation specs never return an action from :meth:`fire` — the
    step-th hit of their point ARMS them (stamping the activation time)
    and :meth:`link` aggregates whatever is currently active."""

    def __init__(self, specs, rank=0, seed_text=""):
        self._specs = list(specs)
        self._rank = rank
        self._counts = {}
        # spec -> monotonic arm time; guarded by self._lock
        self._armed = {}
        self._lock = threading.Lock()
        self._degrade = [s for s in self._specs
                         if s.action in _DEGRADE_ACTIONS
                         + _MIDSTREAM_ACTIONS
                         and s.rank in (None, rank)]
        # peer -> monotonic end of an open blip window (the link toward
        # that peer refuses writes AND reconnects until then); guarded
        # by self._lock
        self._blips = {}
        # step `*` mid-stream specs are armed from process start — no
        # counted hit has to happen first
        for spec in self._degrade:
            if spec.step is None:
                self._armed[spec] = time.monotonic()
        # hits of "link" only matter when a spec watches that point —
        # keeps the per-frame-write hot path to one attribute read when
        # faults are armed for other points only
        self.link_live = bool(self._degrade) or any(
            s.point == "link" for s in self._specs)
        # deterministic under the seed contract: same spec text + rank
        # -> same flaky/jitter roll sequence; guarded by self._lock
        self._rng = random.Random(
            zlib.crc32(seed_text.encode()) ^ (rank * 0x9E3779B1))

    def fire(self, point):
        now = time.monotonic()
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            for spec in self._degrade:
                if (spec.point == point and spec.step == n
                        and spec not in self._armed):
                    self._armed[spec] = now
        for spec in self._specs:
            if (spec.point == point and spec.step == n
                    and spec.rank in (None, self._rank)
                    and spec.action in _ACTIONS):
                return spec.action
        return None

    def _active_locked(self, now):  # holds: self._lock
        for spec, armed_at in self._armed.items():
            if spec.duration is None or now - armed_at <= spec.duration:
                yield spec

    def link(self, peer=None):
        """One client-side frame write toward ``peer`` (None: unknown).
        Counts a hit of the "link" point (which may arm link-stepped
        specs or trip a binary action) and returns the aggregated
        LinkState, or None when nothing is active."""
        action = self.fire("link")
        if not self._degrade:
            return _binary_link_state(action)
        delay = jitter = 0.0
        throttle = 0.0
        flaky = 0.0
        reset_p = 0.0
        partitioned = reset = False
        now = time.monotonic()
        with self._lock:
            tripped = []
            for spec in self._active_locked(now):
                if spec.action == "delay":
                    delay = max(delay, spec.param / 1000.0)
                elif spec.action == "jitter":
                    jitter = max(jitter, spec.param / 1000.0)
                elif spec.action == "throttle":
                    bps = spec.param * 1e6
                    throttle = bps if throttle == 0 \
                        else min(throttle, bps)
                elif spec.action == "flaky":
                    flaky = max(flaky, spec.param)
                elif spec.action == "reset":
                    reset_p = max(reset_p, spec.param)
                elif spec.action == "blip" and peer is not None:
                    # one-shot: THIS write severs the link toward its
                    # peer and opens the refuse window; never re-arms
                    self._blips[peer] = now + spec.param / 1000.0
                    tripped.append(spec)
                    reset = True
                elif spec.action == "partition" and peer is not None:
                    lo, hi = spec.param
                    if (lo <= self._rank <= hi) != (lo <= peer <= hi):
                        partitioned = True
            for spec in tripped:
                del self._armed[spec]
            if peer is not None and peer in self._blips:
                if now < self._blips[peer]:
                    reset = True
                else:
                    del self._blips[peer]
            if jitter > 0:
                delay += self._rng.uniform(0.0, jitter)
            drop = flaky > 0 and self._rng.random() < flaky
            if reset_p > 0 and self._rng.random() < reset_p:
                reset = True
        state = LinkState(delay_s=delay, throttle_bps=throttle,
                          drop=drop, partitioned=partitioned,
                          reset=reset)
        if action is not None:
            state.drop = state.drop or action == "drop"
            _trip_binary(action, "link")
        return state if state else None

    def blip_blocked(self, peer):
        """True while an open blip window covers the link toward
        ``peer`` — reconnect attempts inside the window must be refused
        (the flap is still down), so the session layer's backoff loop
        is what rides it out."""
        if peer is None or not self._blips:
            return False
        now = time.monotonic()
        with self._lock:
            until = self._blips.get(peer)
            if until is None:
                return False
            if now < until:
                return True
            del self._blips[peer]
            return False


def _binary_link_state(action):
    if action is None:
        return None
    if action == "drop":
        return LinkState(drop=True)
    _trip_binary(action, "link")
    return None


_injector = None
_configured = False
_config_lock = threading.Lock()


def configure(spec_text, rank=0):
    """Install the process-wide injector (``hvd.init()`` calls this with
    the resolved config + rank; tests call it directly)."""
    global _injector, _configured
    with _config_lock:
        specs = parse_fault_spec(spec_text) if spec_text else []
        _injector = (FaultInjector(specs, rank=rank,
                                   seed_text=spec_text or "")
                     if specs else None)
        _configured = True


def _auto_configure():
    """Fallback for points hit before ``hvd.init()`` (e.g. a connect
    during rendezvous): read the env contract directly.  Only WORKER
    processes (HVD_RANK present) arm the injector — the launcher
    shares the spec env var but must neither trip rank-0 faults itself
    nor advance step counters the workers' determinism depends on."""
    from horovod_tpu_torch.utils import env as env_util

    rank = env_util.get_str(env_util.HVD_RANK)
    if rank is None:
        configure(None)
    else:
        configure(env_util.get_str(env_util.HVD_TPU_FAULT_SPEC),
                  rank=env_util.get_int(env_util.HVD_RANK, 0))


def _trip_binary(action, point):
    """Apply a fired binary action; shared by check() and link()."""
    if action == "refuse":
        raise ConnectionRefusedError(
            f"injected connection refusal at {point} (HVD_TPU_FAULT_SPEC)")
    if action == "preempt":
        # Deliver the preemption notice the way the platform would:
        # asynchronously, to this process, while the operation keeps
        # going.  With drain enabled the installed handler turns this
        # into a planned departure; without it, default disposition
        # kills the process (same observable as the real thing).
        print(f"[hvd-fault] preempting at {point} (injected SIGTERM)",
              file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if action == "crash":
        # crash: bypass every handler — this models a rank dying mid-step
        print(f"[hvd-fault] crashing at {point} (injected)",
              file=sys.stderr, flush=True)
        sys.stderr.flush()
        os._exit(1)


def check(point, peer=None) -> bool:
    """Trip any fault armed for this hit of ``point``.

    Returns True when the caller must DROP the operation; raises
    ConnectionRefusedError for ``refuse``; ``crash`` never returns.
    ``peer`` scopes per-link faults: a ``connect`` toward a peer whose
    blip window is still open is refused (the flap is still down).
    """
    if not _configured:
        _auto_configure()
    injector = _injector
    if injector is None:
        return False
    if point == "connect" and injector.blip_blocked(peer):
        raise ConnectionRefusedError(
            f"injected link blip toward peer {peer}: connection "
            f"refused (HVD_TPU_FAULT_SPEC)")
    action = injector.fire(point)
    if action is None:
        return False
    if action == "drop":
        print(f"[hvd-fault] dropping {point} (injected)",
              file=sys.stderr, flush=True)
        return True
    _trip_binary(action, point)
    return False


def link(peer=None):
    """Degraded-network verdict for one client-side frame write toward
    ``peer`` (a rank, or None when the peer's rank is unknown).  Returns
    a :class:`LinkState` to apply, or None on the (fast) healthy path.

    The transport applies it BEFORE any bytes leave the socket: delay/
    jitter/throttle sleep, flaky raises so the idempotent-send retry
    absorbs it, partition fails the write like an unreachable host."""
    if not _configured:
        _auto_configure()
    injector = _injector
    if injector is None or not injector.link_live:
        return None
    return injector.link(peer)
