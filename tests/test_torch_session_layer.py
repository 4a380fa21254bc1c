"""The port's session layer (``horovod_tpu_torch/run/service/network.py``)
against the JAX package's (``horovod_tpu/run/service/network.py``), case
by case after ``tests/test_session_layer.py``.

Unit layer: the client's replay buffer fed the same operations as the
reference's, the service's dedup, gap and resume verdicts over a raw
protocol socket, the epoch fence, and budget 0 frame for frame the
reference's.  Integration layer (in-process, real loopback TCP): a
control session healing a cut socket with exactly-once delivery, a send
blocked across the break, a replay gap and an epoch bump escalating the
original error, the budget running out, the healing-peer registry, the
malformed-frame matrix, and the coordinator keeping a healing rank out
of the liveness and straggler verdicts.  The reference's bulk-frame
cases (``StripeClient``'s sessions) have no counterpart: the port has
no TCP data plane (ROADMAP A.13e); their gap and fence cases are shown
here on a control session."""

import socket as socket_mod
import struct
import threading
import time

import pytest

from horovod_tpu.run.service import network as jax_network
from horovod_tpu_torch.common import busy, faults
from horovod_tpu_torch.ops import tcp_controller
from horovod_tpu_torch.run.service import network, secret


class EchoService(network.MuxService):
    """Records every request it handles and echoes sends back: the
    delivery ledger the exactly-once assertions read."""

    def __init__(self, key, epoch=0):
        self.got = []
        self.got_lock = threading.Lock()
        self.epoch = epoch
        super().__init__("session echo", key, host="127.0.0.1")

    def session_epoch(self):
        return self.epoch

    def _handle(self, req, client_address):
        if req == "slow":
            time.sleep(1.0)
        with self.got_lock:
            self.got.append(req)
        return ("echo", req)

    def received(self):
        with self.got_lock:
            return list(self.got)


class JaxEcho(jax_network.MuxService):
    def _handle(self, req, client_address):
        return ("echo", req)


@pytest.fixture
def key():
    return secret.make_secret_key()


@pytest.fixture
def echo(key):
    svc = EchoService(key)
    yield svc
    svc.shutdown()


@pytest.fixture(autouse=True)
def _no_faults():
    faults.configure(None)
    yield
    faults.configure(None)


def _client(svc, key, **kw):
    return network.MuxClient([("127.0.0.1", svc.port)], key, timeout=10,
                             retry_for=kw.pop("retry_for", 10), **kw)


def _sever(client):
    """Cut the client's live connection the way an RST does: the next
    write on it raises, its reader wakes with an error."""
    with client._state_lock:
        client._sock.shutdown(socket_mod.SHUT_RDWR)


def _wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# ------------------------------------------------------- sender unit layer
def _drive(mod, limit, ops):
    """The same operations on a module's _SessionSender: -> what each
    returned and the sequence numbers kept after each."""
    s = mod._SessionSender(epoch=0, replay_bytes=limit)
    trace = []
    for op, arg in ops:
        if op == "append":
            got = s.append(lambda q: ("frame", q), arg)
        elif op == "ack":
            got = s.ack(arg)
        else:
            got = s.replayable_from(arg)
        trace.append((op, arg, got, sorted(s._frames), s.acked))
    return trace


@pytest.mark.parametrize("limit,ops", [
    (1 << 20, [("append", 100)] * 5 + [("ack", 3), ("replay", 3),
                                       ("replay", 4), ("ack", 2)]),
    (250, [("append", 100)] * 4 + [("replay", 1), ("replay", 2)]),
    (1000, [("append", 1024)] * 3 + [("replay", 2), ("replay", 3),
                                     ("append", 10), ("replay", 3)]),
], ids=["seq-ack-replay", "byte-bound-gap", "self-evicting"])
def test_session_sender_matches_the_reference(limit, ops):
    """Sequence numbers, cumulative acks, the byte bound evicting the
    oldest frame and leaving a gap (``replayable_from`` None): the
    port's sender and the reference's on the same operations."""
    got = _drive(network, limit, ops)
    assert got == _drive(jax_network, limit, ops)
    if limit == 250:
        # 400 bytes > 250: the two oldest went, frame 2 cannot be replayed
        assert got[3][3] == [3, 4] and got[4][2] is None
        assert got[5][2] == [("frame", 3), ("frame", 4)]


# ---------------------------------------------- service-side protocol unit
def _raw_session(port, key, session_id="cafe", epoch=0):
    """A hand-rolled session client: connect, hello, welcome."""
    sock = socket_mod.create_connection(("127.0.0.1", port), timeout=10)
    network.write_message(sock, key, (None, network.SessionHello(
        session_id, epoch, 0)), "q")
    sock.settimeout(10)
    _, welcome = network.read_message(sock, key, "r")
    return sock, welcome


def test_service_dedups_by_seq_and_severs_on_gap(echo, key):
    sock, welcome = _raw_session(echo.port, key)
    assert isinstance(welcome, network.SessionWelcome)
    assert welcome.rx_seen == 0 and not welcome.refused
    try:
        # in order, then a replay of seq 1 and 2: delivered once each
        for seq, req in ((1, "a"), (2, "b"), (1, "a"), (2, "b")):
            network.write_message(sock, key, (("sq", seq), req), "q")
        _wait_for(lambda: len(echo.received()) >= 2, msg="delivery")
        time.sleep(0.2)   # would-be duplicate deliveries need time
        assert echo.received() == ["a", "b"]
        assert echo.session_dup_drops == 2
        # a gap (seq 9 when seen is 2) cuts the connection
        network.write_message(sock, key, (("sq", 9), "z"), "q")
        with pytest.raises((ConnectionError, OSError)):
            sock.settimeout(5)
            while True:
                network.read_message(sock, key, "r")
    finally:
        sock.close()
    assert echo.received() == ["a", "b"]


def test_service_resume_reports_seen_and_redelivers_responses(echo, key):
    sock, _ = _raw_session(echo.port, key, session_id="beef")
    network.write_message(sock, key, (("sq", 1, 1000), "ping"), "q")
    sock.settimeout(10)
    rid, resp = network.read_message(sock, key, "r")
    assert rid == 1000 and resp == ("echo", "ping")
    sock.close()
    # the welcome of the resume names how far delivery got, and the kept
    # response is sent again (the dying socket may have eaten it)
    sock2, welcome = _raw_session(echo.port, key, session_id="beef")
    try:
        assert welcome.rx_seen == 1
        assert echo.sessions_resumed == 1
        sock2.settimeout(10)
        rid, resp = network.read_message(sock2, key, "r")
        assert rid == 1000 and resp == ("echo", "ping")
    finally:
        sock2.close()


@pytest.mark.parametrize("session_id,epoch", [
    ("cafe", 3), ("x" * 65, 0), ("", 0), (7, 0)],
    ids=["stale-epoch", "long-id", "empty-id", "int-id"])
def test_a_fenced_or_malformed_hello_is_refused(echo, key, session_id,
                                                epoch):
    sock, welcome = _raw_session(echo.port, key, session_id=session_id,
                                 epoch=epoch)
    sock.close()
    assert welcome.refused
    assert echo._sessions == {}


# ----------------------------------------------------- budget 0: no layer
def _record(monkeypatch, mod, attr):
    """Every (req_id, request) a module's clients write."""
    frames = []
    real = getattr(mod, attr)
    if attr == "write_message":
        def spy(sock, k, obj, direction):
            if direction == "q":
                frames.append(obj)
            return real(sock, k, obj, direction)
    else:
        def spy(sock, k, obj, peer):
            frames.append(obj)
            return real(sock, k, obj, peer)
    monkeypatch.setattr(mod, attr, spy)
    return frames


def _encoded(mod, key, obj):
    a, b = socket_mod.socketpair()
    with a, b:
        n = mod.write_message(a, key, obj, "q")
        return b.recv(n + 1)


@pytest.mark.parametrize("budget", [0, 30], ids=["budget-0", "session"])
def test_frames_are_the_references(monkeypatch, key, budget):
    """At budget 0 no hello goes out, request ids are the plain ints and
    None, the service makes no session, and every frame is the
    reference client's byte for byte; with a budget the numbered frames
    are the reference's too, after a hello of the same fields."""
    mine = _record(monkeypatch, network, "_write_client_frame")
    mine_hello = _record(monkeypatch, network, "write_message")
    theirs = _record(monkeypatch, jax_network, "write_message")
    svc = EchoService(key)
    jax_svc = JaxEcho("jax echo", key)
    try:
        client = _client(svc, key, reconnect_budget=budget)
        jax_client = jax_network.MuxClient(
            [("127.0.0.1", jax_svc.port)], key, timeout=10,
            reconnect_budget=budget)
        jax_client._next_id = client._next_id = 1 << 40
        for c in (client, jax_client):
            try:
                c.post("fire")
                assert c.send("ask") == ("echo", "ask")
                assert c.send(("ask", 2)) == ("echo", ("ask", 2))
            finally:
                c.close()
    finally:
        svc.shutdown()
        jax_svc.shutdown()
    hellos = [f for f in theirs if isinstance(f[1], jax_network.SessionHello)]
    theirs = [f for f in theirs if f not in hellos]
    assert mine == theirs
    for obj in mine:
        assert _encoded(network, key, obj) == _encoded(jax_network, key, obj)
    mine_hello = [f for f in mine_hello
                  if isinstance(f[1], network.SessionHello)]
    if budget == 0:
        assert client._session is None and not mine_hello and not hellos
        assert [f[0] for f in mine] == [None, 1 << 40, (1 << 40) + 1]
        assert svc._sessions == {} and svc.sessions_resumed == 0
    else:
        assert [f[0] for f in mine] == [("sq", 1), ("sq", 2, 1 << 40),
                                        ("sq", 3, (1 << 40) + 1)]
        (_, mine_h), (_, their_h) = mine_hello[0], hellos[0]
        assert (mine_h.epoch, mine_h.rx_seen, len(mine_h.session_id)) == \
            (their_h.epoch, their_h.rx_seen, len(their_h.session_id))


# ------------------------------------------------ control session healing
def test_control_session_heals_midstream(echo, key, capfd):
    client = _client(echo, key, peer=7, reconnect_budget=30)
    before = network.session_stats()["reconnects_healed"]
    try:
        for i in range(5):
            client.post(("post", i))
        assert client.send(("ask", 0)) == ("echo", ("ask", 0))
        # cut the live socket: the reader wakes with an error and heals
        # in place; the next writes ride the healed session
        _sever(client)
        for i in range(5, 10):
            client.post(("post", i))
        assert client.send(("ask", 1)) == ("echo", ("ask", 1))
        _wait_for(lambda: len([r for r in echo.received()
                               if r[0] == "post"]) >= 10,
                  msg="post delivery")
    finally:
        client.close()
    assert network.session_stats()["reconnects_healed"] - before >= 1
    assert echo.sessions_resumed >= 1
    # exactly once, in order
    posts = [r for r in echo.received() if r[0] == "post"]
    assert posts == [("post", i) for i in range(10)]
    assert "[hvd-session] reconnect healed toward peer 7" in \
        capfd.readouterr().err


def test_acks_prune_the_replay_buffer(echo, key):
    client = _client(echo, key, reconnect_budget=30)
    try:
        for i in range(40):
            client.post(i)
        _wait_for(lambda: client._session.acked >= 32, msg="cumulative ack")
        with client._send_lock:
            assert len(client._session._frames) <= \
                2 * network._SESSION_ACK_EVERY
    finally:
        client.close()


def test_send_blocked_across_the_break_still_completes(echo, key):
    """A request in flight when the connection dies completes after the
    heal: the service keeps its response and sends it again on the
    resume, so the waiter never sees the break, and sees it once."""
    client = _client(echo, key, reconnect_budget=30)
    try:
        out = []

        def ask():
            out.append(client.send("slow", timeout=20))

        t = threading.Thread(target=ask)
        t.start()
        _wait_for(lambda: client._session.acked or client._pending,
                  msg="slow in flight")
        time.sleep(0.3)
        _sever(client)
        t.join(20)
        assert not t.is_alive(), "send never completed across the heal"
        assert out == [("echo", "slow")]
        assert echo.received() == ["slow"]
    finally:
        client.close()


def test_injected_blip_heals_and_refuses_connects_inside_the_window(
        echo, key):
    """``link:K:blip:MS`` cuts the K-th frame write mid-frame and refuses
    connects toward the peer for MS: the client heals after the window,
    and the torn frame is delivered once, by the replay."""
    faults.configure("rank0:link:3:blip:400", rank=0)
    client = _client(echo, key, peer=0, reconnect_budget=5)
    before = network.session_stats()
    try:
        t0 = time.monotonic()
        for i in range(6):
            assert client.send(i) == ("echo", i)
        elapsed = time.monotonic() - t0
    finally:
        client.close()
    after = network.session_stats()
    assert echo.received() == list(range(6))
    assert after["reconnects_healed"] - before["reconnects_healed"] == 1
    assert after["frames_replayed"] - before["frames_replayed"] >= 1
    assert elapsed >= 0.4


def test_replay_gap_escalates_original_error(echo, key):
    """A replay buffer too small for the unacknowledged window must not
    heal (a resume would skip the dropped frame): the original write
    error escalates, and the frame is never delivered."""
    # every control frame counts 1024 bytes: each drops itself at once,
    # so the heal's welcome (rx_seen 2) asks for frame 3, which is gone
    faults.configure("rank0:link:3:blip:0", rank=0)
    client = _client(echo, key, peer=7, reconnect_budget=5,
                     replay_bytes=1000)
    before = network.session_stats()["reconnects_failed"]
    try:
        client.post("a")
        client.post("b")
        _wait_for(lambda: len(echo.received()) == 2, msg="two posts")
        with pytest.raises(ConnectionResetError, match="mid-stream"):
            client.post("c")
    finally:
        client.close()
    assert network.session_stats()["reconnects_failed"] - before >= 1
    time.sleep(0.2)
    assert echo.received() == ["a", "b"]


def test_epoch_bump_fences_the_heal(echo, key):
    """A client healing across a re-formation is refused by the fence
    (its epoch is stale) and escalates instead of replaying into the new
    epoch."""
    client = _client(echo, key, epoch=0, reconnect_budget=5,
                     reconnect=False)
    before = network.session_stats()["reconnects_failed"]
    try:
        assert client.send("a") == ("echo", "a")
        echo.epoch = 1
        _sever(client)
        with pytest.raises(OSError):
            client.send("b", timeout=10)
    finally:
        client.close()
    assert network.session_stats()["reconnects_failed"] - before >= 1
    assert echo.received() == ["a"]


def test_budget_exhaustion_escalates_after_the_window(key):
    """No service to come back to: the heal spends its budget, then the
    original error escalates instead of a hang."""
    svc = EchoService(key)
    client = _client(svc, key, reconnect_budget=1.0, retry_for=0,
                     reconnect=False)
    try:
        assert client.send("a") == ("echo", "a")
        svc.shutdown()
        start = time.monotonic()
        _sever(client)
        with pytest.raises(OSError):
            client.send("b", timeout=10)
        elapsed = time.monotonic() - start
        assert elapsed >= 0.9, f"gave up before the budget: {elapsed}"
    finally:
        client.close()


def test_healing_peers_registry_reports_in_flight_heals(key):
    """While a heal is in flight the peer is in ``healing_peers()`` and
    the process is busy, which the heartbeat carries to the
    coordinator."""
    svc = EchoService(key)
    client = _client(svc, key, peer=5, reconnect_budget=2.0, retry_for=0,
                     reconnect=False)
    try:
        assert client.send("a") == ("echo", "a")
        svc.shutdown()
        _sever(client)
        _wait_for(lambda: 5 in network.healing_peers(), timeout=1.5,
                  msg="healing registry entry")
        assert busy.active()
        _wait_for(lambda: 5 not in network.healing_peers(), timeout=10,
                  msg="the heal to give up")
        with pytest.raises(OSError):
            client.send("b", timeout=10)
        assert not busy.active()
    finally:
        client.close()


def test_session_stats_snapshot_shape():
    mine, theirs = network.session_stats(), jax_network.session_stats()
    assert set(mine) == set(theirs) == {"reconnects_healed",
                                        "reconnects_failed",
                                        "frames_replayed"}
    assert all(v >= 0 for v in mine.values())


# ---------------------------------------- malformed-frame rejection matrix
def _frame_bytes(key, obj):
    a, b = socket_mod.socketpair()
    with a, b:
        n = network.write_message(a, key, obj, "q")
        return b.recv(n + 1)


def _truncated(frame):
    return frame[:len(frame) - 3]   # the payload's last bytes never come


def _flipped_bulk_flag(frame):
    # the reference's bulk-frame bit on a control frame's length word:
    # above the frame limit here, refused before any buffering
    (word,) = struct.unpack(">I", frame[:4])
    return struct.pack(">I", word | jax_network.RAW_FRAME_FLAG) + frame[4:]


def _corrupted_hmac(frame):
    buf = bytearray(frame)
    buf[4 + 7] ^= 0x40  # inside the 32-byte digest
    return bytes(buf)


def _oversize_raw_header(frame):
    return struct.pack(">I", jax_network.RAW_FRAME_FLAG
                       | (jax_network.MAX_RAW_HEADER_BYTES + 1)) + frame[4:]


def _midstream_garbage(frame):
    return bytes((i * 37 + 11) % 256 for i in range(64))


@pytest.mark.parametrize(
    "mutate", [_truncated, _flipped_bulk_flag, _corrupted_hmac,
               _oversize_raw_header, _midstream_garbage],
    ids=lambda f: f.__name__.strip("_"))
def test_malformed_frame_rejection_matrix(echo, key, mutate):
    """Hostile bytes on an established session cut THAT connection; the
    session survives for the heal and the service keeps serving."""
    sid = ("mal-" + mutate.__name__.strip("_"))[:32]
    sock, welcome = _raw_session(echo.port, key, session_id=sid)
    assert not welcome.refused
    try:
        network.write_message(sock, key, (("sq", 1), ("good", sid)), "q")
        _wait_for(lambda: ("good", sid) in echo.received(),
                  msg="delivery before the poison")
        sock.sendall(mutate(_frame_bytes(key, (("sq", 2), ("lost", sid)))))
        # half-close: a parser waiting for claimed but absent bytes sees
        # EOF instead of hanging the test
        sock.shutdown(socket_mod.SHUT_WR)
        sock.settimeout(10)
        with pytest.raises((ConnectionError, EOFError, OSError)):
            while True:
                network.read_message(sock, key, "r")
    finally:
        sock.close()
    sock2, welcome2 = _raw_session(echo.port, key, session_id=sid)
    try:
        assert not welcome2.refused and welcome2.rx_seen == 1
        network.write_message(sock2, key, (("sq", 2), ("next", sid)), "q")
        _wait_for(lambda: ("next", sid) in echo.received(),
                  msg="delivery after the heal")
    finally:
        sock2.close()
    sock3, welcome3 = _raw_session(echo.port, key,
                                   session_id=("f-" + sid)[:32])
    sock3.close()
    assert not welcome3.refused
    got = [r for r in echo.received()
           if isinstance(r, tuple) and len(r) == 2 and r[1] == sid]
    assert got == [("good", sid), ("next", sid)]


# ------------------------------------------------------------ coordinator
def _beat(coord, rank, **kw):
    return coord._handle(network.HeartbeatMsg(rank, **kw), ("x", 0))


def test_coordinator_spares_a_healing_rank(key):
    """A rank whose heartbeat reports a heal in flight counts as busy
    (a doubled liveness window) and gets no straggler verdict, however
    slow its link reads; once it stops reporting the heal, the plain
    window and the verdict apply again; a departing rank leaves the
    set."""
    coord = tcp_controller.CoordinatorService(
        4, key, host="127.0.0.1", liveness_timeout_sec=1.0,
        straggler_factor=2.0, straggler_windows=1)

    def scan(silent_s=None):
        with coord._cv:
            now = time.monotonic()
            for r in coord._last_seen:
                coord._last_seen[r] = now
            if silent_s is not None:
                coord._last_seen[3] = now - silent_s
            coord._last_liveness_scan = 0.0
        coord._check_liveness()

    try:
        for r in range(3):
            _beat(coord, r, rtt=0.01)
        # rank 3's window: 1 s, doubled while it heals, plus the RTT
        # slack min(0.5 x 2, 1 x 2) = 1 s: 3 s healing, else 2 s
        _beat(coord, 3, rtt=0.5, reconnecting=[0])
        with coord._cv:
            assert coord._reconnecting_ranks == {3}
            assert 3 in coord._busy_ranks
        scan(silent_s=2.5)
        assert coord.abort_state() is None
        assert coord.straggler_verdicts() == {}
        _beat(coord, 3, rtt=0.5)
        with coord._cv:
            assert not coord._reconnecting_ranks
        scan()
        assert 3 in coord.straggler_verdicts()
        _beat(coord, 2, reconnecting=[0])
        coord._handle(tcp_controller.ShutdownMsg(2), ("x", 0))
        with coord._cv:
            assert 2 not in coord._reconnecting_ranks
        scan(silent_s=2.5)
        assert coord.abort_state()[0] == 3
    finally:
        coord.shutdown()


def test_coordinator_fences_a_session_of_another_epoch(key):
    coord = tcp_controller.CoordinatorService(2, key, host="127.0.0.1",
                                              epoch=2)
    try:
        for epoch in (1, 2):
            sock, welcome = _raw_session(coord.port, key, epoch=epoch,
                                         session_id=f"e{epoch}")
            sock.close()
            if epoch == 1:
                stale = welcome
            else:
                live = welcome
        assert stale.refused and not live.refused
    finally:
        coord.shutdown()

