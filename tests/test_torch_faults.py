"""The control plane's pieces held against the JAX package (the oracle):
the fault grammar and its error texts, the injector's firing and its
link verdicts under the seed contract, chaos specs byte for byte,
culprit attribution, the new config fields and launcher flags, the
frame bytes both ways, the abort error's text; and, in one process, the
coordinator's exchange, liveness and refusal, and the transport's
connect retry.

The JAX cases are those of ``tests/test_fault_injection.py`` (:25, :45,
:235-280, :804, :832, :1071, :1095)."""

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
import types

import pytest
import torch
import torch.distributed as dist

from horovod_tpu.common import config as jax_config
from horovod_tpu.common import faults as jax_faults
from horovod_tpu.common import handles as jax_handles
from horovod_tpu.run import chaos as jax_chaos
from horovod_tpu.run import config_parser as jax_config_parser
from horovod_tpu.run import launch as jax_launch
from horovod_tpu.run import runner as jax_runner
from horovod_tpu.run.service import network as jax_network
from horovod_tpu_torch.common import config
from horovod_tpu_torch.common import faults
from horovod_tpu_torch.common import handles
from horovod_tpu_torch.ops import tcp_controller
from horovod_tpu_torch.run import chaos
from horovod_tpu_torch.run import config_parser
from horovod_tpu_torch.run import launch
from horovod_tpu_torch.run import runner
from horovod_tpu_torch.run.service import network, secret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GOOD_SPECS = [
    # :25
    "rank1:allreduce:2:crash, rank0:send:5:drop ,*:connect:1:refuse",
    "",
    # :804
    "rank1:link:2:delay:40:6, rank0:link:1:flaky:0.2 ,"
    "*:link:3:throttle:16:2,rank2:link:1:jitter:5:1,"
    "rank0:link:1:partition:2-5:4",
    # :1071
    "rank2:link:*:reset:0.3, rank1:link:2:reset:0.2:6 ,"
    "rank1:link:5:blip:30000",
    "rank3:ring:4:preempt,*:adasum:1:drop",
]

BAD_SPECS = [
    # :45
    "rank1:allreduce:crash", "node1:allreduce:1:crash",
    "rank1:allreduce:0:crash", "rank1:allreduce:x:crash",
    "rank1:allreduce:1:explode", "rank1::1:crash",
    # :832
    "rank1:allreduce:1:crash:5", "rank1:allreduce:1:crash:5:2",
    "rank1:link:1:delay", "rank1:link:1:delay:-1", "rank1:link:1:flaky:2",
    "rank1:link:1:throttle:0", "rank1:link:1:partition:5",
    "rank1:link:1:partition:5-2", "rank1:link:1:delay:10:0",
    "rank1:link:1:degrade:1",
    # :1095
    "rank1:allreduce:*:crash", "rank1:link:*:delay:40",
    "rank1:link:1:reset", "rank1:link:1:reset:1.5",
    "rank1:link:1:reset:often", "rank1:link:1:blip:3000:5",
    "rank1:link:1:blip:-5", "rank1:link:1:blip",
    # more of the texts
    "rank1:link:1:delay:nan", "rank1:link:1:delay:10:x",
    "rankx:allreduce:1:crash", "rank1:link:1:partition:a-b",
]


def _fields(specs):
    return [(s.rank, s.point, s.step, s.action, s.param, s.duration,
             repr(s)) for s in specs]


@pytest.mark.parametrize("text", GOOD_SPECS)
def test_parse_fault_spec_matches_jax(text):
    assert _fields(faults.parse_fault_spec(text)) == _fields(
        jax_faults.parse_fault_spec(text))


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_fault_spec_refuses_with_the_jax_text(text):
    with pytest.raises(ValueError) as want:
        jax_faults.parse_fault_spec(text)
    with pytest.raises(ValueError) as got:
        faults.parse_fault_spec(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text,rank", [
    ("rank1:send:3:drop,*:recv:2:refuse", 1),
    ("rank1:send:1:drop", 0),
    ("rank0:allreduce:2:crash,rank0:allreduce:4:drop,*:ring:1:refuse", 0),
])
def test_injector_fires_at_the_same_steps(text, rank):
    mine = faults.FaultInjector(faults.parse_fault_spec(text), rank=rank)
    ref = jax_faults.FaultInjector(jax_faults.parse_fault_spec(text),
                                   rank=rank)
    for point in ("send", "recv", "allreduce", "ring") * 3:
        assert [mine.fire(point) for _ in range(5)] == [
            ref.fire(point) for _ in range(5)]


def _link_states(mod, spec, rank, peers):
    inj = mod.FaultInjector(mod.parse_fault_spec(spec), rank=rank,
                            seed_text=spec)
    out = []
    for peer in peers:
        s = inj.link(peer=peer)
        out.append(None if s is None else (
            round(s.delay_s, 9), s.throttle_bps, s.drop, s.partitioned,
            s.reset))
    return out


@pytest.mark.parametrize("spec", [
    "rank0:link:1:delay:20",
    "rank0:link:2:jitter:50",
    "rank0:link:1:throttle:16,rank0:link:1:delay:5",
    "rank0:link:1:flaky:0.5,rank0:link:1:jitter:50",
    "rank0:link:1:partition:2-5",
    "*:link:3:flaky:0.2,rank0:link:1:delay:10,rank0:link:1:delay:30",
], ids=["delay", "jitter", "throttle", "flaky", "partition", "mixed"])
@pytest.mark.parametrize("rank", [0, 3])
def test_link_sequences_match_jax_under_the_seed_contract(spec, rank):
    peers = [1, 3, None, 6, 0, 2] * 8
    assert _link_states(faults, spec, rank, peers) == _link_states(
        jax_faults, spec, rank, peers)


def test_check_and_configure_match_jax():
    spec = "rank0:allreduce:2:drop,rank0:connect:1:refuse"
    try:
        faults.configure(spec, rank=0)
        jax_faults.configure(spec, rank=0)
        for point in ("allreduce", "allreduce", "allreduce"):
            assert faults.check(point) == jax_faults.check(point)
        for mod in (faults, jax_faults):
            with pytest.raises(ConnectionRefusedError) as exc:
                mod.check("connect")
        assert "HVD_TPU_FAULT_SPEC" in str(exc.value)
    finally:
        faults.configure(None)
        jax_faults.configure(None)


CHAOS_OPTIONS = [
    dict(num_ranks=2, num_faults=1),
    dict(num_ranks=4, num_faults=3, elastic=True),
    dict(num_ranks=8, num_faults=2, degrade=3),
    dict(num_ranks=4, num_faults=1, coord_failover=True, groups=True),
    dict(num_ranks=1, num_faults=2, groups=True, blips=2),
    dict(num_ranks=16, num_faults=0, degrade=1, blips=3),
]


@pytest.mark.parametrize("options", CHAOS_OPTIONS,
                         ids=[str(i) for i in range(len(CHAOS_OPTIONS))])
def test_generate_spec_is_byte_identical(options):
    for seed in range(64):
        got = chaos.generate_spec(seed, **options)
        assert got == jax_chaos.generate_spec(seed, **options)
        faults.parse_fault_spec(got)


@pytest.mark.parametrize("flags,kw", [
    ((), {}), (("--elastic",), {"elastic": True}),
    (("--coord-failover",), {"elastic": True, "coord_failover": True})],
    ids=["plain", "elastic", "coord-failover"])
def test_chaos_cli_prints_the_spec_and_launches(flags, kw):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run.chaos", "--seed",
         "7", "--faults", "2", *flags, "--", "-np", "2", "--version"],
        env=env, capture_output=True, text=True, timeout=60, cwd=REPO)
    assert out.returncode == 0, out.stderr
    want = jax_chaos.generate_spec(7, 2, 2, **kw)
    assert f"HVD_TPU_FAULT_SPEC={want!r}" in out.stdout
    assert ("(elastic)" in out.stdout) == bool(kw)
    assert out.stdout.strip().endswith(runner.__version__)


def test_culprit_attribution_matches_jax():
    cases = [
        ([(0, 1, False, 105.0), (1, 7, False, 100.0)], frozenset()),
        ([(2, -15, True, 99.0), (1, 7, False, 100.0)], frozenset()),
        ([(2, -15, True, 99.0), (0, -15, True, 98.0)], frozenset()),
        ([(0, 1, False, 100.0), (1, 1, False, 101.0)], frozenset({1})),
        ([(0, 1, False, None), (1, 7, False, 100.0)], frozenset()),
    ]
    for failures, crash in cases:
        assert launch.pick_culprit(failures, crash) == \
            jax_launch.pick_culprit(failures, crash)
    assert launch.pick_culprit(*cases[3]) == (1, 1)
    for env in ({"HVD_TPU_FAULT_SPEC":
                 "rank1:ring:1:crash,rank0:send:2:drop,*:connect:1:refuse"},
                {}, {"HVD_TPU_FAULT_SPEC": "garbage"},
                {"HVD_TPU_FAULT_SPEC": "rank2:allreduce:3:preempt,"
                                       "*:allreduce:1:crash"}):
        assert launch.fault_crash_ranks(env) == \
            jax_launch.fault_crash_ranks(env)
    assert launch.fault_crash_ranks(
        {"HVD_TPU_FAULT_SPEC": "rank1:ring:1:crash"}) == frozenset({1})


FT_FIELDS = ("stall_shutdown_seconds", "abort_timeout_seconds",
             "heartbeat_interval_seconds", "liveness_timeout_seconds",
             "fault_spec", "reconnect_budget_seconds",
             "replay_buffer_bytes")


@pytest.mark.parametrize("env", [
    {},
    {"HVD_STALL_SHUTDOWN_TIME_SECONDS": "2", "HVD_TPU_ABORT_TIMEOUT": "10",
     "HVD_TPU_HEARTBEAT_INTERVAL": "0.25", "HVD_TPU_LIVENESS_TIMEOUT": "2",
     "HVD_TPU_FAULT_SPEC": "rank1:allreduce:1:crash"},
    {"HVD_TPU_ABORT_TIMEOUT": "0", "HVD_TPU_HEARTBEAT_INTERVAL": "0"},
    {"HVD_TPU_ABORT_TIMEOUT": "4", "HVD_TPU_HEARTBEAT_INTERVAL": "5"},
    {"HVD_TPU_ABORT_TIMEOUT": "0", "HVD_TPU_HEARTBEAT_INTERVAL": "3"},
    {"HVD_TPU_RECONNECT_BUDGET": "5", "HVD_TPU_REPLAY_BUFFER_BYTES": "4096",
     "HVD_TPU_FAULT_SPEC": "rank1:link:3:blip:1000"},
], ids=["defaults", "tight", "off", "clamped", "no-abort-deadline",
        "session"])
def test_config_fields_match_jax(monkeypatch, env):
    for name in list(os.environ):
        if name.startswith("HVD_"):
            monkeypatch.delenv(name)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got, want = config.Config.from_env(), jax_config.Config.from_env()
    for field in FT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert config.effective_heartbeat_interval(got) == \
        jax_config.effective_heartbeat_interval(want)


def test_config_refuses_a_bad_fault_spec_like_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FAULT_SPEC", "rank1:allreduce:1:explode")
    with pytest.raises(ValueError) as want:
        jax_config.Config.from_env()
    with pytest.raises(ValueError) as got:
        config.Config.from_env()
    assert str(got.value) == str(want.value)


FT_ARGV = ["-np", "2", "--abort-timeout", "12", "--heartbeat-interval",
           "0.5", "--liveness-timeout", "6", "--connect-retry-seconds", "8",
           "--fault-spec", "rank1:ring:2:crash",
           "--stall-check-shutdown-time-seconds", "3",
           "--reconnect-budget", "5", "--replay-buffer-bytes", "1048576",
           "python", "x.py"]


def test_fault_flags_give_the_jax_runners_env():
    def env(parser_mod, cfg):
        return cfg.env_from_args(parser_mod.make_parser().parse_args(
            FT_ARGV))

    got = env(runner, config_parser)
    assert got == env(jax_runner, jax_config_parser)
    assert got["HVD_TPU_FAULT_SPEC"] == "rank1:ring:2:crash"
    assert got["HVD_STALL_SHUTDOWN_TIME_SECONDS"] == "3.0"
    assert got["HVD_TPU_RECONNECT_BUDGET"] == "5.0"
    assert got["HVD_TPU_REPLAY_BUFFER_BYTES"] == "1048576"


def test_fault_yaml_keys_are_the_references(tmp_path):
    path = tmp_path / "ft.yaml"
    path.write_text("fault_tolerance:\n  abort_timeout: 20\n"
                    "  heartbeat_interval: 1.5\n  liveness_timeout: 10\n"
                    "  connect_retry_seconds: 12\n"
                    "  spec: 'rank0:link:1:delay:5:2'\n"
                    "stall_check:\n  shutdown_time_seconds: 40\n")
    got = config_parser.load_config_file(str(path))
    assert got == jax_config_parser.load_config_file(str(path))
    args = argparse.Namespace(**{k: None for k in config_parser._PARAMS})
    config_parser.apply_config_to_args(args, got)
    env = config_parser.env_from_args(args)
    assert env["HVD_TPU_LIVENESS_TIMEOUT"] == "10"
    assert env["HVD_TPU_FAULT_SPEC"] == "rank0:link:1:delay:5:2"


def test_abort_error_text_matches_jax():
    for origin, reason in ((1, "rank 1 sent no heartbeat for more than 2s "
                               "(presumed dead)"), (0, "aborted by user"),
                           (-1, "")):
        got = handles.make_abort_error(origin, reason)
        want = jax_handles.make_abort_error(origin, reason)
        assert str(got) == str(want)
        assert (got.origin_rank, got.reason) == (want.origin_rank,
                                                  want.reason)
        assert isinstance(got, handles.HvdError)


# ------------------------------------------------------------------ framing
PAYLOADS = [(7, {"a": [1, 2.5, "x"], "b": b"\x00\x01"}), None,
            ("q", list(range(300)))]


def _frame(mod, key, obj, direction):
    a, b = socket.socketpair()
    with a, b:
        n = mod.write_message(a, key, obj, direction)
        a.shutdown(socket.SHUT_WR)
        data = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                break
            data += chunk
    assert len(data) == n
    return data


def _read(mod, key, data, direction):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(data)
        a.shutdown(socket.SHUT_WR)
        return mod.read_message(b, key, direction)


@pytest.mark.parametrize("obj", PAYLOADS, ids=["dict", "none", "list"])
def test_frames_are_the_references_both_ways(obj):
    key = secret.make_secret_key()
    mine = _frame(network, key, obj, "q")
    assert mine == _frame(jax_network, key, obj, "q")
    assert _read(network, key, _frame(jax_network, key, obj, "r"),
                 "r") == obj
    assert _read(jax_network, key, _frame(network, key, obj, "q"),
                 "q") == obj


_TRIPPED = []


def _trip():
    _TRIPPED.append(1)
    return "unpickled"


class _Tripwire:
    def __reduce__(self):
        return _trip, ()


@pytest.mark.parametrize("writer", [network, jax_network],
                         ids=["port-writes", "jax-writes"])
@pytest.mark.parametrize("reader", [network, jax_network],
                         ids=["port-reads", "jax-reads"])
def test_a_frame_under_another_key_is_refused_unread(writer, reader):
    data = _frame(writer, b"a" * 32, _Tripwire(), "q")
    _TRIPPED.clear()
    with pytest.raises(PermissionError) as exc:
        _read(reader, b"b" * 32, data, "q")
    assert "HMAC" in str(exc.value)
    assert not _TRIPPED
    # and a reflected frame (right key, wrong direction) is refused too
    with pytest.raises(PermissionError, match="direction"):
        _read(reader, b"a" * 32, _frame(writer, b"a" * 32, 1, "r"), "q")


# ---------------------------------------------------- transport and plane
def test_mux_client_retries_refused_connects():
    key = secret.make_secret_key()
    svc = network.MuxService("mux retry target", key, host="127.0.0.1")
    try:
        faults.configure("*:connect:1:refuse,*:connect:2:refuse", rank=0)
        client = network.MuxClient([("127.0.0.1", svc.port)], key,
                                   retry_for=20)
        assert isinstance(client.send(network.PingRequest(), timeout=10),
                          network.PingResponse)
        client.close()
        basic = network.BasicClient([("127.0.0.1", 1)], key, timeout=1,
                                    retry_for=0)
        start = time.monotonic()
        with pytest.raises(ConnectionError):
            basic.send(network.PingRequest())
        assert time.monotonic() - start < 5.0
    finally:
        faults.configure(None)
        svc.shutdown()


def _coordinator(size=3, **kw):
    return tcp_controller.CoordinatorService(
        size, secret.make_secret_key(), host="127.0.0.1", **kw)


def test_coordinator_relays_each_cycle_in_rank_order():
    svc = _coordinator(3)
    clients = [network.MuxClient([("127.0.0.1", svc.port)], svc._key,
                                 peer=0) for _ in range(3)]
    try:
        replies = [None] * 3

        def one(r):
            replies[r] = [clients[r].send(tcp_controller.CycleMsg(
                r, seq, f"r{r}s{seq}".encode()), timeout=10).msgs
                for seq in range(3)]

        threads = [threading.Thread(target=one, args=(r,))
                   for r in (2, 0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        for r in range(3):
            assert replies[r] == [[f"r{q}s{seq}".encode()
                                   for q in range(3)] for seq in range(3)]
        assert not svc._cycles
    finally:
        for c in clients:
            c.close()
        svc.shutdown()


def test_liveness_names_the_silent_rank_and_spares_a_departed_one():
    svc = _coordinator(3, liveness_timeout_sec=0.3)
    try:
        hb = network.HeartbeatMsg
        for r in range(3):
            svc._handle(hb(r), None)
        svc._handle(tcp_controller.ShutdownMsg(2), None)
        time.sleep(0.4)
        svc._handle(hb(0), None)
        reply = svc._handle(hb(0), None)
        assert svc.abort_state() == (
            1, "rank 1 sent no heartbeat for more than 0.3s "
               "(presumed dead)")
        assert reply.abort == svc.abort_state()
        # sticky: a later abort does not replace it
        svc._initiate_abort(0, "later")
        assert svc.abort_state()[0] == 1
        assert svc.wait_told(me=0, timeout=0.1)
    finally:
        svc.shutdown()


def test_a_pending_cycle_learns_the_abort_at_once():
    svc = _coordinator(2)
    client = network.MuxClient([("127.0.0.1", svc.port)], svc._key, peer=0)
    try:
        got = []
        t = threading.Thread(target=lambda: got.append(client.send(
            tcp_controller.CycleMsg(0, 0, b"x"), timeout=10)))
        t.start()
        time.sleep(0.2)
        svc._initiate_abort(1, "stalled")
        t.join(timeout=5)
        assert got[0].aborted == (1, "stalled")
        assert 0 in svc._told
    finally:
        client.close()
        svc.shutdown()


def test_coordinator_names_the_rank_whose_frames_fail_verification():
    svc = _coordinator(2, rank_of_client=lambda addr: 1)
    bad = network.MuxClient([("127.0.0.1", svc.port)], b"x" * 32, peer=0)
    good = network.MuxClient([("127.0.0.1", svc.port)], svc._key, peer=0)
    try:
        with pytest.raises(ConnectionError) as exc:
            bad.send(network.HeartbeatMsg(1), timeout=10)
        assert isinstance(exc.value.__cause__, PermissionError)
        reply = good.send(tcp_controller.CycleMsg(0, 0, b"m"), timeout=10)
        assert reply.error == tcp_controller.key_refused(1)
        assert "rank 1 failed HMAC verification" in reply.error
    finally:
        bad.close()
        good.close()
        svc.shutdown()


CALLER_ERRORS = [
    RuntimeError("ProcessGroupGloo::allgather: invalid tensor size at "
                 "index 1 (expected (2), got (1))"),
    RuntimeError("Invalid scalar type"),
    ValueError("all_to_all: dim 1 of shape (3, 5) does not split into 2 "
               "parts"),
    TypeError("all_reduce(): argument 'tensor' must be Tensor"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
]
COMM_ERRORS = [
    RuntimeError("[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:553]"
                 " Connection closed by peer [127.0.0.1]:17559"),
    RuntimeError("[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc"
                 ":81] Timed out waiting 1800000ms for recv operation"),
    dist.DistBackendError("NCCL communicator was aborted on rank 0."),
    ConnectionResetError("Connection reset by peer"),
]


def _plane(rank=1, size=2, liveness=15.0, key=None):
    cfg = config.Config(liveness_timeout_seconds=liveness,
                        heartbeat_interval_seconds=0.25)
    return tcp_controller.ControlPlane(
        rank, size, key or secret.make_secret_key(), cfg)


@pytest.mark.parametrize("exc", CALLER_ERRORS + COMM_ERRORS,
                         ids=lambda e: type(e).__name__)
def test_only_a_broken_communication_waits_for_the_verdict(exc):
    """The caller's own error (a shape, a dtype, memory) is raised at
    once; a broken communication waits for the coordinator's verdict, so
    that a survivor names the dead peer."""
    comm = any(exc is e for e in COMM_ERRORS)
    assert tcp_controller.is_comm_error(exc) == comm
    plane = _plane()
    timer = threading.Timer(0.3, plane._local_abort, (0, "rank 0 died"))
    timer.start()
    try:
        t0 = time.monotonic()
        got = plane.verdict(exc)
        elapsed = time.monotonic() - t0
    finally:
        timer.cancel()
    if comm:
        assert got == (0, "rank 0 died") and elapsed >= 0.25
    else:
        assert got is None and elapsed < 0.25
    # once the job has aborted, any error is its abort, at once
    plane._local_abort(0, "rank 0 died")
    t0 = time.monotonic()
    assert plane.verdict(exc) == (0, "rank 0 died")
    assert time.monotonic() - t0 < 0.25


@pytest.mark.parametrize("exc", CALLER_ERRORS[:2] + COMM_ERRORS[:1],
                         ids=["shape", "dtype", "peer"])
def test_abortable_raises_a_callers_error_unchanged(monkeypatch, exc):
    from horovod_tpu_torch.common import basics

    plane = _plane()
    monkeypatch.setattr(basics, "_state", types.SimpleNamespace(plane=plane))
    comm = tcp_controller.is_comm_error(exc)
    if comm:
        threading.Timer(0.2, plane._local_abort, (0, "rank 0 died")).start()
    t0 = time.monotonic()
    with pytest.raises(Exception) as got:
        with basics.abortable():
            raise exc
    if comm:
        assert isinstance(got.value, handles.HvdAbortedError)
        assert got.value.origin_rank == 0 and got.value.__cause__ is exc
    else:
        assert got.value is exc and time.monotonic() - t0 < 0.25


def test_a_commit_after_the_abort_is_refused(monkeypatch):
    """``elastic.State.commit()`` refuses a snapshot taken once the job
    has aborted (it may hold an update of a partly reduced gradient) and
    keeps the last one, which ``restore()`` brings back."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.elastic import State

    plane = _plane()
    monkeypatch.setattr(basics, "_state", types.SimpleNamespace(plane=plane))
    model = torch.nn.Linear(4, 4)
    state = State(params=model.state_dict(), step=1)
    good = model.weight.detach().clone()
    plane._local_abort(1, "rank 1 sent no heartbeat for more than 2s "
                          "(presumed dead)")
    with torch.no_grad():
        model.weight.add_(1.0)
    state.step = 2
    with pytest.raises(handles.HvdAbortedError) as got:
        state.commit()
    assert got.value.origin_rank == 1
    assert state._committed[2] == 1
    state.restore()
    assert torch.equal(model.weight, good) and state.step == 1


def test_a_coordinator_lost_in_the_init_barrier_aborts_naming_rank_0():
    """Rank 0's process can die as soon as its own ``hvd.init()``
    returns, resetting a peer's connection before that peer has read
    its barrier reply: the peer's ``init`` raises the typed abort naming
    rank 0, not the transport's error."""
    class Lost(tcp_controller.CoordinatorService):
        def _handle_deferred(self, req, client_address, respond):
            if isinstance(req, tcp_controller.CycleMsg) and req.seq == -1:
                respond.args[0].shutdown(socket.SHUT_RDWR)
                respond(None)   # the write fails; the request is done
                return True
            return super()._handle_deferred(req, client_address, respond)

    key = secret.make_secret_key()
    svc = Lost(2, key, host="127.0.0.1")
    plane = _plane(key=key)
    try:
        plane.start(("127.0.0.1", svc.port))
        with pytest.raises(handles.HvdAbortedError) as got:
            plane.barrier(10)
        assert got.value.origin_rank == 0
        assert "coordinator unreachable during hvd.init()" in \
            got.value.reason
        assert plane.abort_state()[0] == 0
    finally:
        plane.shutdown()
        svc.shutdown()
