"""Secret-keyed pickled-message TCP services (port of
``horovod_tpu/run/service/network.py``; reference:
``horovod/run/common/service/__init__.py`` and
``horovod/run/common/util/network.py``): a threaded socket server
exchanging HMAC-signed pickled request/response objects, the
control-plane messages, the connect path with its retry and fault
sites, and the host's interface addresses.

Wire format per message, the reference's byte for byte: ``[4-byte
big-endian length][32-byte HMAC-SHA256 digest][pickled (direction,
object)]``.  The digest is verified BEFORE unpickling, so an
unauthenticated peer cannot reach the unpickler, and the claimed length
is capped before any buffering, so it cannot make the service hold
gigabytes either.  The signed envelope carries a direction tag ("q"
request / "r" response) so a reflected frame cannot answer a request,
and mux request ids start at a random offset so a frame recorded from an
earlier connection cannot pair with a live request.

Ported: the messages (``PingRequest`` ... ``HeartbeatReply``; a
heartbeat carries the rank, its launcher host hash, its busy flag, its
round trips' EWMA and the peers it is healing a session toward),
``connect`` with ``default_connect_retry`` and backoff,
``_apply_link_faults`` (the degraded-link verdicts of
``common/faults.py``, the mid-stream ``reset``/``blip`` included), the
codec, ``BasicService``/``BasicClient``, ``MuxService``/``MuxClient``
and the session layer on them (below).  Not ported, by decision
(ROADMAP A.13e): the reference's bulk raw-bytes frames,
``StripeClient`` and their bulk sessions (its TCP data plane's; NCCL
carries the port's bytes).  Two additions: a service binds the address
it is given (the coordinator binds the one the other ranks are told,
``common/basics.py``), and ``MuxService._on_refused`` hears of a
connection whose frame failed verification, so that the coordinator
can name the rank it came from.

The session layer (the reference's, frame for frame): with a reconnect
budget above 0 a :class:`MuxClient` opens its connection with a
:class:`SessionHello` naming a session id and its epoch, and the
service's :class:`SessionWelcome` names how far delivery got.  Every
frame carries a sequence number in its request id (``("sq", seq,
req_id)``, ``("sq", seq)`` for a post) and stays in a byte-bounded
replay buffer until the service's cumulative :class:`SessionAck`.  On
a mid-stream break the client reconnects inside the budget, offers the
same session, and sends again only what the service has not
delivered; the service drops duplicates, cuts the connection on a gap,
and answers a request on whichever connection the session holds now,
sending its kept responses again on a resume.  A hello from another
epoch is refused, and the client then raises the original error.  At
budget 0 the layer is inert: no extra frame, request ids unchanged.
"""

import functools
import pickle
import random
import secrets as _secrets
import socket
import socketserver
import struct
import sys
import threading
import time

from horovod_tpu_torch.run.service import secret
from horovod_tpu_torch.utils import env as env_util

# Largest frame accepted before authentication (the reference's).  A
# length word with the high bit set (the reference's bulk frames) is
# above it and refused.
MAX_FRAME_BYTES = 1 << 30


# ------------------------------------------------------------- base messages
class PingRequest:
    pass


class PingResponse:
    def __init__(self, service_name):
        self.service_name = service_name


class AckResponse:
    pass


# Fault-tolerance control messages (ops/tcp_controller.py): any rank can
# report an abort; heartbeats keep the coordinator's last-seen table
# fresh and carry the abort state back.
# epoch-exempt: the abort channel is epoch-agnostic by design — a
# world dying at epoch N must be able to kill collectives on ranks that
# already adopted N+1
class AbortMsg:
    def __init__(self, origin_rank, reason):
        self.origin_rank = origin_rank
        self.reason = reason


# epoch-exempt: liveness must keep flowing across reconfiguration
# boundaries — the coordinator's last-seen table is how a rank that
# died mid-reconfiguration gets detected
class HeartbeatMsg:
    def __init__(self, rank, busy=False, rtt=None, host=None,
                 reconnecting=None):
        self.rank = rank
        # peers this rank is healing a session toward right now: the
        # coordinator treats a healing rank as a busy one (a wider
        # liveness window, no straggler verdict), so that a link blip
        # never turns into an abort
        self.reconnecting = reconnecting
        # sender's launcher host hash (run/host_hash.py)
        self.host = host
        # the sender is inside a slow but live window (a checkpoint
        # write, a drain): the coordinator doubles its liveness window
        self.busy = busy
        # the sender's worst round-trip EWMA in seconds: the coordinator
        # adds an RTT-proportional slack to its liveness window
        self.rtt = rtt


class HeartbeatReply:
    def __init__(self, abort=None):
        self.abort = abort  # (origin_rank, reason) | None


# -------------------------------------------------------- session messages
class SessionHello:
    def __init__(self, session_id, epoch, rx_seen):
        self.session_id = session_id
        # the sender's view of the membership epoch: a hello from before
        # a re-formation must not resume into the new epoch's service
        # (the welcome comes back refused and the client escalates)
        self.epoch = epoch
        self.rx_seen = rx_seen  # reserved: client to service only


class SessionWelcome:
    def __init__(self, rx_seen, refused=False):
        # highest contiguous client seq this service delivered: the
        # client prunes its replay buffer to here and sends the rest
        self.rx_seen = rx_seen
        self.refused = refused  # the epoch fence: do not resume


class SessionAck:
    def __init__(self, seen):
        self.seen = seen  # cumulative: every seq <= seen is delivered


def default_reconnect_budget():
    return env_util.get_float(env_util.HVD_TPU_RECONNECT_BUDGET,
                              env_util.DEFAULT_RECONNECT_BUDGET_SECONDS)


def default_replay_bytes():
    return env_util.get_int(env_util.HVD_TPU_REPLAY_BUFFER_BYTES,
                            env_util.DEFAULT_REPLAY_BUFFER_BYTES)


# the service acks every Nth delivered frame on the session's own
# connection; the client prunes its replay buffer on each
_SESSION_ACK_EVERY = 16
# responses the service keeps a session for sending again after a heal
# (a response can vanish in the kernel buffer of a dying socket without
# the write failing: the resume's flush covers that window)
_SESSION_RESP_KEEP = 256
# the replay buffer's byte estimate of a control frame (its pickled size
# is known only when it is written; the bound needs only its order)
_CTRL_FRAME_EST = 1024
# session ids are 16 hex characters (token_hex(8)); a verified but
# hostile hello must not make megabyte strings into dict keys
_MAX_SESSION_ID_LEN = 64
# sessions a service keeps: sessions outlive their sockets, so without
# a cap a peer helloing with fresh ids would grow the table forever.  At
# the cap, admission first evicts a session with no live socket (oldest
# first), then refuses
_MAX_SESSIONS = 1024


def _valid_seq(value):
    """A sequence or ack number that may be trusted: an int (not a
    bool) in the range a well-behaved peer produces.  Seq, ack ``seen``
    and welcome ``rx_seen`` arrive in verified frames, but verified
    means only that the peer holds the key: these values reach dict
    keys, comparisons and the replay buffer's arithmetic, so they are
    bounds-checked like any other wire input."""
    return (isinstance(value, int) and not isinstance(value, bool)
            and 0 <= value < (1 << 62))


# process-wide session counters
_session_stats_lock = threading.Lock()
_session_stats = {"reconnects_healed": 0, "reconnects_failed": 0,
                  "frames_replayed": 0}


def _session_note(kind, n=1):
    with _session_stats_lock:
        _session_stats[kind] = _session_stats.get(kind, 0) + n


def session_stats():
    """A snapshot of the process-wide session counters."""
    with _session_stats_lock:
        return dict(_session_stats)


# peers with a heal in flight right now: the heartbeat reports them, so
# that the coordinator widens the liveness window instead of reading the
# pause as death
_healing_lock = threading.Lock()
_healing = {}  # peer -> nesting depth; guarded by _healing_lock


def _healing_enter(peer):
    with _healing_lock:
        _healing[peer] = _healing.get(peer, 0) + 1


def _healing_exit(peer):
    with _healing_lock:
        depth = _healing.get(peer, 0) - 1
        if depth <= 0:
            _healing.pop(peer, None)
        else:
            _healing[peer] = depth


def healing_peers():
    """Sorted ranks this process is healing a session toward now."""
    with _healing_lock:
        return sorted(p for p in _healing if p is not None)


class _SessionResumeRefused(ConnectionError):
    """The service fenced the resume (another epoch), or the replay
    buffer no longer holds a frame the service needs: a heal would
    leave a silent gap, so the original transport error escalates."""


class _SessionSender:
    """The client half of a session: assigns the sequence numbers,
    keeps every unacknowledged frame in a byte-bounded replay buffer
    (the oldest dropped first), prunes on cumulative acks.  Callers
    serialise access under their own write lock, so that replay order
    is wire order."""

    def __init__(self, epoch, replay_bytes):
        self.session_id = _secrets.token_hex(8)
        self.epoch = epoch
        self._limit = max(0, int(replay_bytes))
        self._frames = {}      # seq -> (record, nbytes), in seq order
        self._bytes = 0
        self._next = 1
        self._oldest = 1       # oldest seq still kept
        self.acked = 0

    def append(self, make_record, nbytes):
        """Assign the next seq, build the frame's record with
        ``make_record(seq)`` and keep it for replay.  -> ``(seq,
        record)``."""
        seq = self._next
        self._next += 1
        record = make_record(seq)
        self._frames[seq] = (record, nbytes)
        self._bytes += nbytes
        while self._bytes > self._limit and self._frames:
            old = next(iter(self._frames))
            _, nb = self._frames.pop(old)
            self._bytes -= nb
            self._oldest = old + 1
        return seq, record

    def ack(self, seen):
        """Cumulative ack: drop every kept frame with seq <= seen."""
        while self._frames:
            seq = next(iter(self._frames))
            if seq > seen:
                break
            _, nb = self._frames.pop(seq)
            self._bytes -= nb
        if seen + 1 > self._oldest:
            self._oldest = seen + 1
        if seen > self.acked:
            self.acked = seen

    def replayable_from(self, rx_seen):
        """The frame records to send again after a heal: everything
        newer than what the service delivered.  None when the service
        needs a frame the byte bound already dropped (a resume would
        skip it silently, so the caller escalates instead)."""
        self.ack(rx_seen)
        if rx_seen + 1 < self._oldest:
            return None
        return [rec for rec, _ in self._frames.values()]


class _SessionState:
    """The service half of a session.  Outlives any one socket:
    ``sock`` and ``write_lock`` are always the session's current
    connection's, so that a request's answer goes to wherever the
    client is now, not to the socket the request came in on."""

    __slots__ = ("session_id", "epoch", "seen", "dup_drops", "lock",
                 "sock", "write_lock", "responses",
                 "delivered_since_ack")

    def __init__(self, session_id, epoch):
        self.session_id = session_id
        self.epoch = epoch
        self.seen = 0            # highest contiguous seq delivered
        self.dup_drops = 0
        self.lock = threading.Lock()
        self.sock = None         # live socket; guarded by self.lock
        self.write_lock = None   # its write lock; guarded by self.lock
        # req_id -> (req_id, resp) wire tuples kept for sending again
        # after a resume, at most _SESSION_RESP_KEEP; guarded by
        # self.lock
        self.responses = {}
        self.delivered_since_ack = 0   # guarded by self.lock


def _session_handshake_client(sock, key, session, timeout):
    """Open or resume ``session`` on a freshly connected socket: write
    the hello, wait for the welcome (no reader thread exists yet, so
    this read races nothing)."""
    write_message(sock, key, (None, SessionHello(
        session.session_id, session.epoch, 0)), "q")
    old_timeout = sock.gettimeout()
    sock.settimeout(timeout)
    try:
        frame = read_message(sock, key, "r")
    finally:
        sock.settimeout(old_timeout)
    if not (isinstance(frame, tuple) and len(frame) == 2
            and isinstance(frame[1], SessionWelcome)):
        raise ConnectionError(
            "session handshake expected SessionWelcome, got "
            f"{type(frame).__name__}")
    welcome = frame[1]
    # rx_seen goes into the replay buffer's arithmetic: a verified
    # welcome with garbage there fails the handshake typed
    if not welcome.refused and not _valid_seq(welcome.rx_seen):
        raise ConnectionError(
            f"session welcome carried invalid rx_seen "
            f"({type(welcome.rx_seen).__name__})")
    return welcome


# ------------------------------------------------------- retry / backoff
def backoff_delay(attempt, base=0.05, cap=2.0):
    """Exponential backoff with jitter (50-100% of the exponential
    step): ranks that retry after a shared blip decorrelate instead of
    knocking again in lockstep."""
    return min(cap, base * (1 << min(attempt, 16))) * \
        (0.5 + random.random() * 0.5)


def default_connect_retry():
    return env_util.get_float(env_util.HVD_TPU_CONNECT_RETRY_SECONDS,
                              env_util.DEFAULT_CONNECT_RETRY_SECONDS)


def connect(addr, timeout, peer=None):
    """Every control-plane TCP connect funnels through here: one
    fault-injection point ("connect").  A "drop" there is a dropped SYN,
    which the caller can only observe as a failed connect, the same
    surface as "refuse".  ``peer`` scopes per-link faults: a reconnect
    toward a peer whose blip window is still open is refused (the flap
    is still down), so the session layer's backoff rides it out."""
    from horovod_tpu_torch.common import faults

    if faults.check("connect", peer=peer):
        raise ConnectionRefusedError(
            "injected connection drop at connect (HVD_TPU_FAULT_SPEC)")
    return socket.create_connection(addr, timeout=timeout)


class _RetryableSendError(ConnectionError):
    """Internal marker: the request may be safely retried in full
    (nothing reached the service, or the request is idempotent)."""


# ------------------------------------------------- degraded-link injection
# bound on one injected sleep: a chaos cell must slow the job, never
# wedge it past its own deadlines' ability to tell slow from dead
_MAX_DEGRADE_SLEEP = 5.0
_flaky_noted = set()    # peers already logged; guarded by _flaky_note_lock
_reset_noted = set()    # peers already logged; guarded by _flaky_note_lock
_flaky_note_lock = threading.Lock()


def _note_flaky(peer):
    with _flaky_note_lock:
        if peer in _flaky_noted:
            return
        _flaky_noted.add(peer)
    print(f"[hvd-fault] flaky link toward peer {peer}: dropping writes, "
          f"transport resends (injected)", file=sys.stderr, flush=True)


def _note_reset(peer):
    with _flaky_note_lock:
        if peer in _reset_noted:
            return
        _reset_noted.add(peer)
    print(f"[hvd-fault] mid-stream reset toward peer {peer}: cutting "
          f"the connection, session layer heals (injected)",
          file=sys.stderr, flush=True)


def _apply_link_faults(peer, nbytes, sock=None):
    """Client-side framing-layer chaos: every client frame write funnels
    through here, with the frame's size ``nbytes`` (which the throttle
    paces).  ``peer`` is the remote's rank (None: unknown).

    A flaky drop loses the write BEFORE any byte leaves the socket, so
    the resend here is always safe.  A partition fails the write
    outright, exactly like an unreachable host.  A mid-stream
    ``reset``/``blip`` verdict puts a partial frame prefix on the wire
    first (when ``sock`` is given), closes the socket hard and raises
    ConnectionResetError: the failure the session layer's reconnect and
    replay exist for."""
    from horovod_tpu_torch.common import faults

    state = faults.link(peer)
    if state is None:
        return
    attempts = 0
    while state is not None and state.drop and not state.reset:
        _note_flaky(peer)
        attempts += 1
        if attempts >= 1000:
            raise ConnectionResetError(
                f"injected flaky link toward peer {peer} dropped "
                f"{attempts} consecutive writes (HVD_TPU_FAULT_SPEC)")
        time.sleep(0.002)
        state = faults.link(peer)
    if state is None:
        return
    if state.partitioned:
        raise ConnectionResetError(
            f"injected network partition toward peer {peer} "
            f"(HVD_TPU_FAULT_SPEC)")
    if state.reset:
        if sock is not None:
            # two bytes of a frame header, then a hard close: the peer's
            # reader is mid-header when the cut lands, never at a frame
            # boundary.  The shutdown wakes both ends' blocked readers
            # (a close alone leaves a reader in another thread blocked)
            try:
                # wire-safe: deliberately unsigned garbage, the injected
                # fault itself (a torn frame), not a protocol message
                sock.sendall(b"\x15\x03")
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        _note_reset(peer)
        raise ConnectionResetError(
            f"injected mid-stream connection reset toward peer {peer} "
            f"(HVD_TPU_FAULT_SPEC)")
    sleep_s = state.delay_s
    if state.throttle_bps > 0:
        sleep_s += nbytes / state.throttle_bps
    if sleep_s > 0:
        time.sleep(min(sleep_s, _MAX_DEGRADE_SLEEP))


# ---------------------------------------------------------------- wire codec
def encode_message(key, obj, direction):
    """One signed frame's bytes."""
    payload = pickle.dumps((direction, obj))
    if len(payload) > MAX_FRAME_BYTES:
        # fail HERE with a clear error: the receiver would just drop the
        # connection and the sender would see a mute timeout
        raise ValueError(
            f"frame of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte transport limit")
    digest = secret.sign(key, payload)
    return struct.pack(">I", len(payload)) + digest + payload


def write_message(sock, key, obj, direction):
    frame = encode_message(key, obj, direction)
    sock.sendall(frame)  # wire-safe: frame signed by encode_message
    return len(frame)


def _write_client_frame(sock, key, obj, peer):
    """A client's request frame, through the link faults first."""
    frame = encode_message(key, obj, "q")
    _apply_link_faults(peer, len(frame), sock=sock)
    sock.sendall(frame)  # wire-safe: frame signed by encode_message


def read_message(sock, key, expected_direction):
    header = _read_exact(sock, 4 + secret.DIGEST_LEN)
    (length,) = struct.unpack(">I", header[:4])
    digest = header[4:]
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(
            f"frame length {length} exceeds limit {MAX_FRAME_BYTES}")
    payload = _read_exact(sock, length)
    if not secret.check(key, payload, digest):
        raise PermissionError("message failed HMAC verification")
    envelope = _loads_checked(payload)
    if not (isinstance(envelope, tuple) and len(envelope) == 2
            and envelope[0] == expected_direction):
        raise PermissionError(
            "message direction mismatch (reflected frame?)")
    return envelope[1]


def _loads_checked(payload):
    """Unpickle an HMAC-verified envelope, converting any decode failure
    into the transport's typed rejection: a signed-but-undecodable frame
    surfaces like any other malformed frame, never as an arbitrary
    exception type escaping into handler threads."""
    try:
        return pickle.loads(payload)
    except Exception as exc:  # noqa: BLE001 — unpickler raises freely
        raise PermissionError(
            f"verified frame failed to decode: "
            f"{type(exc).__name__}") from exc


def _read_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        # wakeable: closing the socket (the owner's close(), a service
        # shutdown) breaks the blocked recv with an OSError
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf += chunk
    return bytes(buf)


# ------------------------------------------------------------------- service
class BasicService:
    """Threaded TCP service answering one signed request per connection
    (reference: ``network.BasicService``).  ``host``: the address to
    bind (default every interface, the reference's)."""

    def __init__(self, name, key, host="0.0.0.0"):
        self._name = name
        self._key = key
        self._start_server(self._make_handler(), host)

    def _make_handler(self):
        service = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    # wakeable: server shutdown closes the listener and
                    # every accepted socket, breaking this read
                    req = read_message(self.request, service._key, "q")
                except (PermissionError, ConnectionError, EOFError):
                    return  # drop unauthenticated/broken peers silently
                try:
                    resp = service._handle(req, self.client_address)
                except Exception as exc:  # noqa: BLE001 — ship to client
                    resp = exc
                try:
                    write_message(self.request, service._key, resp, "r")
                except OSError:
                    pass  # client went away
                except Exception as exc:  # noqa: BLE001 — unpicklable resp
                    try:
                        write_message(
                            self.request, service._key,
                            RuntimeError(
                                f"response serialization failed: {exc}"),
                            "r")
                    except Exception:  # noqa: BLE001
                        pass

        return Handler

    def _start_server(self, handler, host):
        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, 0), handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"{self._name}-service")
        self._thread.start()

    @property
    def port(self):
        return self._server.server_address[1]

    def addresses(self):
        """{interface: [(ip, port)]} for every non-loopback interface
        (reference: ``network.get_local_host_addresses``)."""
        out = {}
        for iface, ip in local_interfaces().items():
            out[iface] = [(ip, self.port)]
        return out

    def _handle(self, req, client_address):
        if isinstance(req, PingRequest):
            return PingResponse(self._name)
        raise ValueError(f"unknown request type {type(req).__name__}")

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


class BasicClient:
    """One-connection-per-request client (reference:
    ``network.BasicClient``): tries each known (ip, port) until one
    answers, remembers the winner."""

    def __init__(self, addresses, key, timeout=10, read_timeout="same",
                 retry_for=None, peer=None):
        # addresses: {iface: [(ip, port)]} or flat [(ip, port)].
        # ``timeout`` bounds connection establishment; ``read_timeout``
        # bounds the response wait (None = wait forever).  ``retry_for``
        # is the deadline budget for connect-phase retries with
        # backoff+jitter (None = HVD_TPU_CONNECT_RETRY_SECONDS; 0 = a
        # single sweep).  ``peer`` is the remote's rank when known, for
        # link-level fault targeting.
        if isinstance(addresses, dict):
            flat = [a for addrs in addresses.values() for a in addrs]
        else:
            flat = list(addresses)
        if not flat:
            raise ValueError("no addresses to connect to")
        self._addresses = flat
        self._good = None
        self._key = key
        self._timeout = timeout
        self._peer = peer
        self._read_timeout = timeout if read_timeout == "same" \
            else read_timeout
        self._retry_for = (default_connect_retry() if retry_for is None
                           else retry_for)

    def _send_one(self, addr, req):
        with connect(addr, self._timeout, peer=self._peer) as sock:
            sock.settimeout(self._read_timeout)
            _write_client_frame(sock, self._key, req, self._peer)
            resp = read_message(sock, self._key, "r")
        if isinstance(resp, Exception):
            raise resp
        return resp

    def send(self, req, idempotent=False):
        """Address failover happens ONLY at the connect phase: once a
        request has been written, any error propagates (a non-idempotent
        message must not be delivered twice).  ``idempotent=True`` lifts
        that rule: the whole request is retried under the deadline
        budget even after a post-write failure.  When every address
        refuses, the sweep repeats with exponential backoff + jitter
        until the ``retry_for`` budget is spent."""
        deadline = time.monotonic() + self._retry_for
        attempt = 0
        while True:
            try:
                return self._send_sweep(req, idempotent)
            except _RetryableSendError as exc:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionError(str(exc)) from exc
                time.sleep(min(backoff_delay(attempt), max(remaining, 0.0)))
                attempt += 1

    def _send_sweep(self, req, idempotent):
        """One pass over the candidate addresses."""
        candidates = list(self._addresses)
        if self._good is not None and self._good in candidates:
            candidates.remove(self._good)
            candidates.insert(0, self._good)
        last_error = None
        for addr in candidates:
            try:
                sock = connect(addr, self._timeout, peer=self._peer)
            except OSError as exc:
                last_error = exc
                if addr == self._good:
                    self._good = None
                continue
            try:
                with sock:
                    sock.settimeout(self._read_timeout)
                    _write_client_frame(sock, self._key, req, self._peer)
                    resp = read_message(sock, self._key, "r")
            except OSError as exc:
                if idempotent:
                    raise _RetryableSendError(
                        f"idempotent request to {addr} failed after "
                        f"write: {exc}") from exc
                raise  # sent: do NOT fail over to another address
            self._good = addr
            if isinstance(resp, Exception):
                raise resp
            return resp
        raise _RetryableSendError(
            f"could not reach service at any of {self._addresses}: "
            f"{last_error}")

    def probe(self):
        """Which of the candidate addresses actually answer a Ping
        (reference: the task-to-task address check)."""
        good = []
        for addr in self._addresses:
            try:
                resp = self._send_one(addr, PingRequest())
                if isinstance(resp, PingResponse):
                    good.append(addr)
            except (OSError, ConnectionError, PermissionError):
                continue
        return good


def _connect_any(addresses, timeout, retry_for, peer=None):
    """Connect sweep over the address list with exponential backoff +
    jitter under the ``retry_for`` deadline budget; returns a connected
    TCP_NODELAY socket."""
    deadline = time.monotonic() + retry_for
    attempt = 0
    last_error = None
    while True:
        for addr in addresses:
            try:
                sock = connect(addr, timeout, peer=peer)
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError as exc:
                last_error = exc
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise ConnectionError(
                f"could not reach service at any of {addresses}: "
                f"{last_error}")
        time.sleep(min(backoff_delay(attempt), max(remaining, 0.0)))
        attempt += 1


# ------------------------------------------------- persistent mux transport
class MuxService(BasicService):
    """Persistent-connection variant: each connection carries a stream of
    ``(req_id, request)`` frames; every request is handled on its own
    thread and the ``(req_id, response)`` frame is written back whenever
    it completes, so slow (blocking) requests don't head-of-line-block
    the connection.  Fire-and-forget posts (``req_id`` None) are handled
    inline on the reader loop, and so are the requests a subclass takes
    to answer later (``_handle_deferred``; the port's addition: the
    coordinator's cycle messages, answered all at once by the reader
    that brings the last one, with no thread a message).

    A connection whose FIRST frame is a :class:`SessionHello` becomes a
    session (module docstring): frames carry seq numbers in their
    request ids, the service drops duplicates and acks cumulatively, and
    a later connection offering the same session id resumes where the
    broken one stopped."""

    def __init__(self, name, key, host="0.0.0.0"):
        self._inflight = 0   # guarded by self._inflight_cv
        self._inflight_cv = threading.Condition()
        # session_id -> _SessionState: sessions outlive their sockets;
        # guarded by self._sessions_lock
        self._sessions = {}
        self._sessions_lock = threading.Lock()
        self.sessions_resumed = 0     # guarded by self._sessions_lock
        self.session_dup_drops = 0    # guarded by self._sessions_lock
        super().__init__(name, key, host)

    def session_epoch(self):
        """The epoch a hello must name to be admitted (the coordinator:
        its membership epoch)."""
        return 0

    def _on_refused(self, sock, client_address):
        """A frame on the connection from ``client_address`` failed
        verification; the connection is dropped after this returns."""

    def _handle_deferred(self, req, client_address, respond):
        """Take ``req`` to answer later, by calling ``respond(resp)``
        once, instead of on a thread of its own: -> True if taken.  For
        requests that wait on other connections' requests and whose
        answer is quick once they are in."""
        return False

    def _make_handler(self):
        service = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                write_lock = threading.Lock()
                sock = self.request
                first = True
                while True:
                    try:
                        # wakeable: shutdown() and a session resume both
                        # close this socket, breaking the blocked read
                        frame = read_message(sock, service._key, "q")
                    except PermissionError:
                        service._on_refused(sock, self.client_address)
                        return
                    except (ConnectionError, EOFError, OSError):
                        return
                    if not (isinstance(frame, tuple) and len(frame) == 2):
                        return
                    req_id, req = frame
                    if first:
                        first = False
                        if isinstance(req, SessionHello):
                            service._session_serve(sock, write_lock, req,
                                                   self.client_address)
                            return
                    with service._inflight_cv:
                        service._inflight += 1
                    if req_id is not None and service._handle_deferred(
                            req, self.client_address,
                            functools.partial(service._respond, sock,
                                              write_lock, req_id)):
                        continue
                    if req_id is None:
                        # fire-and-forget: no response is ever written
                        try:
                            service._handle(req, self.client_address)
                        except Exception:  # noqa: BLE001 — nowhere to
                            pass           # report without a req_id
                        finally:
                            with service._inflight_cv:
                                service._inflight -= 1
                                service._inflight_cv.notify_all()
                        continue

                    def run(req_id=req_id, req=req):
                        try:
                            try:
                                resp = service._handle(
                                    req, self.client_address)
                            except Exception as exc:  # noqa: BLE001
                                resp = exc
                            service._write_response(sock, write_lock,
                                                    req_id, resp)
                        finally:
                            with service._inflight_cv:
                                service._inflight -= 1
                                service._inflight_cv.notify_all()

                    # lifecycle: ends with its single _handle call;
                    # shutdown() drains in-flight handlers through the
                    # _inflight_cv barrier before the socket closes
                    threading.Thread(target=run, daemon=True,
                                     name=f"{service._name}-req").start()

        return Handler

    # ------------------------------------------------------ session side
    def _session_serve(self, sock, write_lock, hello, client_address):
        """Admit (or resume) a session offered by a fresh connection:
        fence other epochs, make this socket the session's live one,
        tell the client how far delivery got (it sends the rest), send
        again the kept responses the dying socket may have swallowed,
        then serve frames until the connection breaks."""
        # the hello is verified, but its fields are still wire input:
        # the id becomes a dict key, so anything but a short string is
        # refused before the table is touched
        if not (isinstance(hello.session_id, str)
                and 0 < len(hello.session_id) <= _MAX_SESSION_ID_LEN) \
                or hello.epoch != self.session_epoch():
            try:
                with write_lock:
                    write_message(sock, self._key,
                                  (None, SessionWelcome(0, refused=True)),
                                  "r")
            except OSError:
                pass
            return
        with self._sessions_lock:
            state = self._sessions.get(hello.session_id)
            resumed = state is not None
            if not resumed:
                if len(self._sessions) >= _MAX_SESSIONS:
                    self._evict_dead_session_locked()
                if len(self._sessions) >= _MAX_SESSIONS:
                    # a table full of live sessions: refuse rather than
                    # grow without bound
                    state = None
                else:
                    state = _SessionState(hello.session_id, hello.epoch)
                    self._sessions[hello.session_id] = state
            else:
                self.sessions_resumed += 1
        if state is None:
            try:
                with write_lock:
                    write_message(sock, self._key,
                                  (None, SessionWelcome(0, refused=True)),
                                  "r")
            except OSError:
                pass
            return
        with state.lock:
            old_sock = state.sock
            state.sock = sock
            state.write_lock = write_lock
            seen = state.seen
            stash = list(state.responses.values()) if resumed else []
        if old_sock is not None and old_sock is not sock:
            # wake the dead connection's reader, if it has not noticed
            try:
                old_sock.close()
            except OSError:
                pass
        try:
            with write_lock:
                write_message(sock, self._key,
                              (None, SessionWelcome(seen)), "r")
            for wire in stash:
                with write_lock:
                    write_message(sock, self._key, wire, "r")
        except OSError:
            return  # this socket died too; the client will be back
        self._session_loop(sock, write_lock, state, client_address)

    def _evict_dead_session_locked(self):  # holds: self._sessions_lock
        """Drop one session with no live socket, oldest first.  -> True
        when one was dropped."""
        for sid, st in list(self._sessions.items()):
            with st.lock:
                # the server closes a handler's socket when handle()
                # returns, so a session whose connection died holds a
                # closed socket
                dead = st.sock is None or st.sock.fileno() == -1
            if dead:
                del self._sessions[sid]
                return True
        return False

    def _session_loop(self, sock, write_lock, state, client_address):
        """The frame pump of one live session connection: deliver
        exactly the next frame in sequence, drop the duplicates a replay
        sent again, ack cumulatively every few deliveries."""
        while True:
            try:
                # wakeable: the session's next resume (and shutdown)
                # closes this socket, breaking the read
                frame = read_message(sock, self._key, "q")
            except (PermissionError, ConnectionError, EOFError, OSError):
                return
            if not (isinstance(frame, tuple) and len(frame) == 2):
                return
            rid, req = frame
            if not (isinstance(rid, tuple) and len(rid) in (2, 3)
                    and rid[0] == "sq" and _valid_seq(rid[1])):
                return  # not session-framed: a protocol violation
            seq = rid[1]
            need_ack = False
            with state.lock:
                if seq <= state.seen:
                    state.dup_drops += 1
                    verdict = "dup"
                elif seq == state.seen + 1:
                    state.seen = seq
                    state.delivered_since_ack += 1
                    if state.delivered_since_ack >= _SESSION_ACK_EVERY:
                        state.delivered_since_ack = 0
                        need_ack = True
                    verdict = "deliver"
                else:
                    # the sender replayed past a frame this service never
                    # got: resuming would corrupt; cut, and let the
                    # sender's next heal (or its escalation) decide
                    verdict = "gap"
                seen = state.seen
            if verdict == "gap":
                try:
                    sock.close()
                except OSError:
                    pass
                return
            if verdict == "dup":
                with self._sessions_lock:
                    self.session_dup_drops += 1
                continue
            with self._inflight_cv:
                self._inflight += 1
            if len(rid) == 2:
                # fire-and-forget: inline, as the plain post
                try:
                    self._handle(req, client_address)
                except Exception:  # noqa: BLE001 — nowhere to report
                    pass
                finally:
                    with self._inflight_cv:
                        self._inflight -= 1
                        self._inflight_cv.notify_all()
            elif not self._handle_deferred(
                    req, client_address,
                    functools.partial(self._respond_session, state,
                                      rid[2])):
                def run(base_id=rid[2], req=req):
                    try:
                        try:
                            resp = self._handle(req, client_address)
                        except Exception as exc:  # noqa: BLE001
                            resp = exc
                        self._write_session_response(state, base_id, resp)
                    finally:
                        with self._inflight_cv:
                            self._inflight -= 1
                            self._inflight_cv.notify_all()

                # lifecycle: ends with its single _handle call;
                # shutdown() drains in-flight handlers through the
                # _inflight_cv barrier before the socket closes
                threading.Thread(target=run, daemon=True,
                                 name=f"{self._name}-req").start()
            if need_ack:
                try:
                    with write_lock:
                        write_message(sock, self._key,
                                      (None, SessionAck(seen)), "r")
                except OSError:
                    pass  # the connection is dying; the reader notices

    def _respond_session(self, state, req_id, resp):
        """A deferred request's answer on a session."""
        try:
            self._write_session_response(state, req_id, resp)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _write_session_response(self, state, req_id, resp):
        """Send a response to the session's CURRENT socket (the one the
        request came in on may be long dead) and keep it for the next
        resume: a write into a dying socket's kernel buffer can vanish
        without failing."""
        wire = (req_id, resp)
        with state.lock:
            state.responses[req_id] = wire
            while len(state.responses) > _SESSION_RESP_KEEP:
                state.responses.pop(next(iter(state.responses)))
            sock, wlock = state.sock, state.write_lock
        if sock is None:
            return
        try:
            with wlock:
                write_message(sock, self._key, wire, "r")
        except OSError:
            pass  # kept; the resume's flush sends it again
        except Exception as exc:  # noqa: BLE001 — e.g. unpicklable resp
            wire = (req_id,
                    RuntimeError(f"response serialization failed: {exc}"))
            with state.lock:
                state.responses[req_id] = wire
            try:
                with wlock:
                    write_message(sock, self._key, wire, "r")
            except Exception:  # noqa: BLE001
                try:
                    sock.close()
                except OSError:
                    pass

    def _respond(self, sock, write_lock, req_id, resp):
        """A deferred request's answer (``_handle_deferred``)."""
        try:
            self._write_response(sock, write_lock, req_id, resp)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _write_response(self, sock, write_lock, req_id, resp):
        try:
            with write_lock:
                write_message(sock, self._key, (req_id, resp), "r")
        except OSError:
            pass  # client went away
        except Exception as exc:  # noqa: BLE001 — e.g. unpicklable resp
            # a silently-dropped frame would hang the client's send()
            # forever; ship an error, or kill the connection so the
            # client fails fast
            try:
                with write_lock:
                    write_message(
                        sock, self._key,
                        (req_id,
                         RuntimeError(
                             f"response serialization failed: {exc}")),
                        "r")
            except Exception:  # noqa: BLE001
                try:
                    sock.close()
                except OSError:
                    pass

    def shutdown(self):
        """Drain in-flight requests before closing: a coordinator whose
        own rank finishes first must not tear down the socket while
        response frames to other ranks are still being written."""
        deadline = time.monotonic() + 10
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(timeout=remaining)
        super().shutdown()


class MuxClient:
    """Client for :class:`MuxService`: ONE persistent socket, concurrent
    in-flight requests demultiplexed by id.  Thread-safe.

    ``reconnect=False``: a connection that broke is not made again
    (sends raise the break), for a stream whose requests the service
    holds across frames.  A reconnect budget above 0
    (``HVD_TPU_RECONNECT_BUDGET`` by default) makes the connection a
    session that heals a break in place inside that budget (module
    docstring); ``epoch`` goes into its hello, ``replay_bytes`` bounds
    its replay buffer.  ``on_connect(sock)`` runs on each new socket
    before its first frame."""

    def __init__(self, addresses, key, timeout=10, retry_for=None,
                 peer=None, reconnect=True, epoch=0, reconnect_budget=None,
                 replay_bytes=None, on_connect=None):
        if isinstance(addresses, dict):
            flat = [a for addrs in addresses.values() for a in addrs]
        else:
            flat = list(addresses)
        if not flat:
            raise ValueError("no addresses to connect to")
        self._addresses = flat
        self._key = key
        self._timeout = timeout
        # remote's rank when known (the coordinator: 0), for link-level
        # fault targeting; the transport itself never needs it
        self._peer = peer
        self._retry_for = (default_connect_retry() if retry_for is None
                           else retry_for)
        self._reconnect = reconnect
        self._on_connect = on_connect
        budget = (default_reconnect_budget() if reconnect_budget is None
                  else reconnect_budget)
        self._budget = max(0.0, float(budget))
        self._epoch = epoch
        # seq assignment and the replay buffer, or None at budget 0 (the
        # frames as without the layer); the reference is set once here,
        # its contents are guarded by self._send_lock
        self._session = (_SessionSender(epoch, default_replay_bytes()
                                        if replay_bytes is None
                                        else replay_bytes)
                         if self._budget > 0 else None)
        self._sock = None     # guarded by self._state_lock
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        # req_id -> (event, [response]); guarded by self._state_lock
        self._pending = {}
        # random start: a (req_id, resp) frame recorded from an earlier
        # connection/run cannot collide with a live request id
        self._next_id = _secrets.randbits(48)  # guarded by self._state_lock
        self._reader = None   # guarded by self._state_lock
        self._broken = None   # guarded by self._state_lock
        self._closed = False  # guarded by self._state_lock

    def _connect_locked(self, retry_for=None):  # holds: self._state_lock
        """Establish the socket + reader, sweeping the address list with
        exponential backoff + jitter under the ``retry_for`` budget (the
        client's own by default): a refused connection is retried, not
        fatal.  A session's handshake and its replay of unacknowledged
        frames happen here, before the reader thread exists, so that the
        welcome's read races nothing and the replay precedes any new
        frame."""
        sock = _connect_any(self._addresses, self._timeout,
                            self._retry_for if retry_for is None
                            else retry_for, peer=self._peer)
        try:
            if self._on_connect is not None:
                self._on_connect(sock)
            if self._session is not None:  # hvd-lint: ignore[lock-discipline] — set-once reference
                self._resume_locked(sock)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._sock = sock
        self._broken = None
        # lifecycle: exits when its socket dies; close() closes the
        # socket, which breaks the blocked read_message, and a heal
        # hands a new reader the new socket
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,), daemon=True,
            name="mux-client-reader")
        self._reader.start()

    def _resume_locked(self, sock):  # holds: self._state_lock
        """The session's hello on ``sock``, then the replay of what the
        service has not delivered."""
        session = self._session  # hvd-lint: ignore[lock-discipline] — set-once reference
        welcome = _session_handshake_client(sock, self._key, session,
                                            self._timeout)
        if welcome.refused:
            raise _SessionResumeRefused(
                f"service fenced session resume toward peer "
                f"{self._peer} (stale epoch {self._epoch})")
        with self._send_lock:
            frames = session.replayable_from(welcome.rx_seen)
            if frames is None:
                raise _SessionResumeRefused(
                    f"replay buffer no longer holds frames the service "
                    f"needs (peer {self._peer}; raise "
                    f"{env_util.HVD_TPU_REPLAY_BUFFER_BYTES})")
            for wire in frames:
                _write_client_frame(sock, self._key, wire, self._peer)
        if frames:
            _session_note("frames_replayed", len(frames))

    def _try_heal(self, dead_sock, exc):
        """Heal the session in place after a mid-stream break.  -> True
        when the session is live again (this call healed it, or another
        thread already had): the caller's frame is in the replay buffer,
        so it was (or will be) sent again, and a rewrite is dropped as a
        duplicate.  -> False when there is no session, the resume was
        fenced or the budget ran out: the caller raises the ORIGINAL
        error, the path without the session layer."""
        # the reference is set once at construction
        if self._session is None:  # hvd-lint: ignore[lock-discipline] — set-once reference
            return False
        deadline = time.monotonic() + self._budget
        with self._state_lock:
            if self._closed:
                return False
            if self._sock is not None and self._sock is not dead_sock:
                return True  # another thread healed it already
            if self._sock is None and self._broken is not None:
                return False  # an earlier heal gave up
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            from horovod_tpu_torch.common import busy

            _healing_enter(self._peer)
            try:
                # a busy window: the coordinator widens this rank's
                # liveness window while the heal is in flight
                with busy.window():
                    attempt = 0
                    while True:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            self._broken = exc
                            _session_note("reconnects_failed")
                            return False
                        try:
                            self._connect_locked(retry_for=remaining)
                        except _SessionResumeRefused:
                            self._broken = exc
                            _session_note("reconnects_failed")
                            return False
                        except (OSError, ConnectionError, PermissionError):
                            # connected, then cut again (a reset still
                            # armed): back off as a refused connect does
                            self._sock = None
                            time.sleep(min(backoff_delay(attempt),
                                           max(remaining, 0.0)))
                            attempt += 1
                            continue
                        _session_note("reconnects_healed")
                        with self._send_lock:  # acks land under it
                            acked = self._session.acked
                        print(f"[hvd-session] reconnect healed toward "
                              f"peer {self._peer} (control session, "
                              f"acked {acked})", file=sys.stderr,
                              flush=True)
                        return True
            finally:
                _healing_exit(self._peer)

    def _ensure_connected_locked(self):  # holds: self._state_lock
        """Returns the live socket; the returned reference, not a re-read
        of self._sock, is what the write must use."""
        if self._closed:
            raise ConnectionError("client closed")
        if self._broken is not None and not self._reconnect:
            err = ConnectionError(
                f"connection to service lost: {self._broken}")
            err.__cause__ = self._broken
            raise err
        if self._sock is None or self._broken is not None:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            self._connect_locked()
        return self._sock

    def local_address(self):
        """(ip, port) of this client's end of its connection,
        connecting first if it has none."""
        with self._state_lock:
            return self._ensure_connected_locked().getsockname()[:2]

    def _read_loop(self, sock):
        while True:
            try:
                # wakeable: close() severs this socket
                frame = read_message(sock, self._key, "r")
                if not (isinstance(frame, tuple) and len(frame) == 2):
                    raise ConnectionError(
                        f"malformed mux frame {type(frame).__name__}")
                req_id, resp = frame
            except Exception as exc:  # noqa: BLE001 — the reader must
                # never die silently: heal the session in place if there
                # is one (the waiters stay: their responses come again
                # after the resume); else fail every waiter, mark broken
                if isinstance(exc, (OSError, ConnectionError)) \
                        and not isinstance(exc, PermissionError) \
                        and self._try_heal(sock, exc):
                    return  # a new reader owns the healed socket
                with self._state_lock:
                    if self._broken is None:
                        self._broken = exc
                    pending, self._pending = self._pending, {}
                for event, slot in pending.values():
                    err = ConnectionError(
                        f"connection to service lost: {exc}")
                    err.__cause__ = exc
                    slot[0] = err
                    event.set()
                return
            if req_id is None:
                # a session ack prunes the replay buffer (its seen is
                # wire input even in a verified frame); a post's echo
                # has nothing waiting on it
                if isinstance(resp, SessionAck) and _valid_seq(resp.seen) \
                        and self._session is not None:  # hvd-lint: ignore[lock-discipline] — set-once reference
                    with self._send_lock:
                        self._session.ack(resp.seen)
                continue
            with self._state_lock:
                entry = self._pending.pop(req_id, None)
            if entry is not None:
                entry[1][0] = resp
                entry[0].set()

    def _write(self, make_wire):
        """Write one frame, healing the session across a break: the
        frame is numbered and kept once, then written on whichever
        socket the session holds."""
        wire = None
        while True:
            with self._state_lock:
                sock = self._ensure_connected_locked()
            try:
                with self._send_lock:
                    if wire is None:
                        wire = make_wire()
                    _write_client_frame(sock, self._key, wire, self._peer)
                return
            except OSError as exc:
                if self._try_heal(sock, exc):
                    # the replay may have carried the frame already: the
                    # service drops the rewrite as a duplicate
                    continue
                raise

    def _wire(self, req_id, req):
        """The frame of ``req`` (``req_id`` None: a post); in a session,
        numbered and kept for replay (caller holds _send_lock)."""
        if self._session is None:  # hvd-lint: ignore[lock-discipline] — set-once reference
            return (req_id, req)
        tail = () if req_id is None else (req_id,)
        _, wire = self._session.append(  # hvd-lint: ignore[lock-discipline] — caller holds _send_lock
            lambda seq: (("sq", seq) + tail, req), _CTRL_FRAME_EST)
        return wire

    def send(self, req, timeout=None):
        with self._state_lock:
            req_id = self._next_id
            self._next_id += 1
            event, slot = threading.Event(), [None]
            self._pending[req_id] = (event, slot)
        try:
            self._write(lambda: self._wire(req_id, req))
        except Exception:
            with self._state_lock:
                self._pending.pop(req_id, None)
            raise
        if not event.wait(timeout):
            with self._state_lock:
                self._pending.pop(req_id, None)
            raise TimeoutError("no response from service")
        resp = slot[0]
        if isinstance(resp, Exception):
            raise resp
        return resp

    def post(self, req):
        """Fire-and-forget: write the frame without expecting a response
        (req_id None).  TCP ordering + HMAC still apply."""
        self._write(lambda: self._wire(None, req))

    def close(self):
        with self._state_lock:
            self._closed = True
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def local_interfaces():
    """{interface_name: ipv4} for every up non-loopback interface
    (``ioctl`` SIOCGIFADDR on each of ``socket.if_nameindex``); a
    hostname lookup under the pseudo-interface ``_default`` when none
    answers."""
    import fcntl

    out = {}
    try:
        ifaces = socket.if_nameindex()
    except OSError:
        ifaces = []
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _, name in ifaces:
            if name == "lo":
                continue
            try:
                packed = fcntl.ioctl(
                    s.fileno(), 0x8915,  # SIOCGIFADDR
                    struct.pack("256s", name.encode()[:15]))
                out[name] = socket.inet_ntoa(packed[20:24])
            except OSError:
                continue  # an interface without an IPv4 address
    finally:
        s.close()
    if not out:
        try:
            out["_default"] = socket.gethostbyname(socket.gethostname())
        except OSError:
            out["_default"] = "127.0.0.1"
    return out
