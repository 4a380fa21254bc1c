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
heartbeat carries the rank, its launcher host hash, its busy flag and
its round trips' EWMA), ``connect`` with
``default_connect_retry`` and backoff, ``_apply_link_faults`` (the
degraded-link verdicts of ``common/faults.py``), the codec,
``BasicService``/``BasicClient`` and ``MuxService``/``MuxClient``.  Not
ported: the reference's bulk raw-bytes frames and ``StripeClient`` (its
TCP data plane's; NCCL carries the port's bytes) and the session layer
with its mid-stream ``reset``/``blip`` branch (ROADMAP A.13e).  Two
additions: a service binds the address it is given (the coordinator
binds the one the other ranks are told, ``common/basics.py``), and
``MuxService._on_refused`` hears of a connection whose frame failed
verification, so that the coordinator can name the rank it came from.
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
    def __init__(self, rank, busy=False, rtt=None, host=None):
        self.rank = rank
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
    surface as "refuse"."""
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
_flaky_note_lock = threading.Lock()


def _note_flaky(peer):
    with _flaky_note_lock:
        if peer in _flaky_noted:
            return
        _flaky_noted.add(peer)
    print(f"[hvd-fault] flaky link toward peer {peer}: dropping writes, "
          f"transport resends (injected)", file=sys.stderr, flush=True)


def _apply_link_faults(peer, nbytes):
    """Client-side framing-layer chaos: every client frame write funnels
    through here, with the frame's size ``nbytes`` (which the throttle
    paces).  ``peer`` is the remote's rank (None: unknown).

    A flaky drop loses the write BEFORE any byte leaves the socket, so
    the resend here is always safe.  A partition fails the write
    outright, exactly like an unreachable host.  The reference's
    mid-stream ``reset``/``blip`` verdicts are not applied (module
    docstring)."""
    from horovod_tpu_torch.common import faults

    state = faults.link(peer)
    if state is None:
        return
    attempts = 0
    while state is not None and state.drop:
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
    _apply_link_faults(peer, len(frame))
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
    that brings the last one, with no thread a message)."""

    def __init__(self, name, key, host="0.0.0.0"):
        self._inflight = 0   # guarded by self._inflight_cv
        self._inflight_cv = threading.Condition()
        super().__init__(name, key, host)

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
                while True:
                    try:
                        # wakeable: shutdown() closes this socket,
                        # breaking the blocked read
                        frame = read_message(sock, service._key, "q")
                    except PermissionError:
                        service._on_refused(sock, self.client_address)
                        return
                    except (ConnectionError, EOFError, OSError):
                        return
                    if not (isinstance(frame, tuple) and len(frame) == 2):
                        return
                    req_id, req = frame
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
    in-flight requests demultiplexed by id.  Thread-safe."""

    def __init__(self, addresses, key, timeout=10, retry_for=None,
                 peer=None, reconnect=True):
        # ``reconnect=False``: a connection that broke is not made again
        # (sends raise the break): for a stream whose requests the
        # service holds across frames, which a new connection cannot
        # resume without the reference's session layer
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

    def _connect_locked(self):  # holds: self._state_lock
        """Establish the socket + reader, sweeping the address list with
        exponential backoff + jitter under the ``retry_for`` budget: a
        refused connection is retried, not fatal."""
        sock = _connect_any(self._addresses, self._timeout,
                            self._retry_for, peer=self._peer)
        self._sock = sock
        self._broken = None
        # lifecycle: exits when its socket dies; close() closes the
        # socket, which breaks the blocked read_message
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,), daemon=True,
            name="mux-client-reader")
        self._reader.start()

    def _ensure_connected_locked(self):  # holds: self._state_lock
        """Returns the live socket; the returned reference, not a re-read
        of self._sock, is what the write must use."""
        if self._closed:
            raise ConnectionError("client closed")
        if self._broken is not None and not self._reconnect:
            raise ConnectionError(
                f"connection to service lost: {self._broken}")
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
                # never die silently: fail every waiter, mark broken
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
                continue   # a post's echo: nothing waits on it
            with self._state_lock:
                entry = self._pending.pop(req_id, None)
            if entry is not None:
                entry[1][0] = resp
                entry[0].set()

    def send(self, req, timeout=None):
        with self._state_lock:
            req_id = self._next_id
            self._next_id += 1
            event, slot = threading.Event(), [None]
            self._pending[req_id] = (event, slot)
        try:
            with self._state_lock:
                sock = self._ensure_connected_locked()
            with self._send_lock:
                _write_client_frame(sock, self._key, (req_id, req),
                                    self._peer)
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
        with self._state_lock:
            sock = self._ensure_connected_locked()
        with self._send_lock:
            _write_client_frame(sock, self._key, (None, req), self._peer)

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
