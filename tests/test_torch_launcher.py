"""The port's launcher pieces (``horovod_tpu_torch/run``,
``common/topology.py``, ``common/config.py``) against the JAX package's
(``horovod_tpu/run``, ``horovod_tpu/common/topology.py``) as oracle: the
same inputs give the same slots, env, topology, digests, KV answers,
commands and culprits.  No cluster: the KV servers bind loopback ports,
the commands are compared as built, and the processes are local."""

import argparse
import dataclasses
import io
import logging
import os
import signal
import sys
import threading
import time

import pytest

from horovod_tpu.common import topology as jax_topology
from horovod_tpu.run import allocate as jax_alloc
from horovod_tpu.run import cache as jax_cache
from horovod_tpu.run import config_parser as jax_config_parser
from horovod_tpu.run import host_hash as jax_host_hash
from horovod_tpu.run import http_client as jax_client
from horovod_tpu.run import js_run as jax_js_run
from horovod_tpu.run import launch as jax_launch
from horovod_tpu.run import lsf as jax_lsf
from horovod_tpu.run import mpi_run as jax_mpi_run
from horovod_tpu.run import runner as jax_runner
from horovod_tpu.run import safe_shell_exec as jax_sse
from horovod_tpu.run import ssh_check as jax_ssh_check
from horovod_tpu.run.http_server import RendezvousServer as JaxServer
from horovod_tpu.run.service import secret as jax_secret

from horovod_tpu_torch.common import config as config_mod
from horovod_tpu_torch.common import topology
from horovod_tpu_torch.run import allocate as alloc
from horovod_tpu_torch.run import cache as cache_mod
from horovod_tpu_torch.run import config_parser
from horovod_tpu_torch.run import host_hash
from horovod_tpu_torch.run import http_client
from horovod_tpu_torch.run import js_run, launch, lsf, mpi_run, runner
from horovod_tpu_torch.run import safe_shell_exec as sse
from horovod_tpu_torch.run import ssh_check
from horovod_tpu_torch.run.http_server import RendezvousServer
from horovod_tpu_torch.run.service import secret

HOST_SPECS = ["h1:4, h2:2,h3", "h1:2,h2:2", "h1:2,h2:4", "a:1,a:2,b:0,c:3",
              "localhost:4", "h1:2,h2:2,h1:1"]
ALLOCATIONS = [("h1:2,h2:2", 4), ("h1:2,h2:4", 3), ("a:1,a:2,b:0,c:3", 5),
               ("h1:2,h2:2,h1:1", 5), ("localhost:4", 1), ("h1:3", 3)]


def _slots(slots):
    return [dataclasses.astuple(s) for s in slots]


# ------------------------------------------------------------- allocation --
@pytest.mark.parametrize("spec", HOST_SPECS)
def test_parse_hosts_matches_jax(spec):
    assert ([dataclasses.astuple(h) for h in alloc.parse_hosts(spec)]
            == [dataclasses.astuple(h) for h in jax_alloc.parse_hosts(spec)])


def test_parse_hostfile_matches_jax(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# comment\nh1 slots=4\nh2:2  # two\nh3\n\nh1 slots=1\n")
    assert ([dataclasses.astuple(h) for h in alloc.parse_hostfile(hf)]
            == [dataclasses.astuple(h)
                for h in jax_alloc.parse_hostfile(hf)])
    empty = tmp_path / "empty"
    empty.write_text("# nothing\n")
    for parse in (alloc.parse_hostfile, jax_alloc.parse_hostfile):
        with pytest.raises(ValueError, match="contains no hosts"):
            parse(empty)


@pytest.mark.parametrize("spec,np_total", ALLOCATIONS)
def test_allocate_matches_jax(spec, np_total):
    """Full, partial and duplicate hosts and a drained 0-slot host."""
    got = alloc.allocate(alloc.parse_hosts(spec), np_total)
    want = jax_alloc.allocate(jax_alloc.parse_hosts(spec), np_total)
    assert _slots(got) == _slots(want)


@pytest.mark.parametrize("spec,np_total", [("h1:2", 3), ("a:0", 1)])
def test_allocate_refuses_as_jax(spec, np_total):
    with pytest.raises(ValueError) as want:
        jax_alloc.allocate(jax_alloc.parse_hosts(spec), np_total)
    with pytest.raises(ValueError) as got:
        alloc.allocate(alloc.parse_hosts(spec), np_total)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------- config surface --
# every flag of the port's parser, with a value of its type
PORT_ARGV = [
    "-np", "4", "--start-timeout", "33", "--network-interface", "eth7",
    "--fusion-threshold-mb", "2.5", "--cycle-time-ms", "3.5",
    "--cache-capacity", "77", "--disable-cache", "--hier-local-size", "2",
    "--adasum-hierarchical", "--compression", "int8",
    "--hierarchical-allreduce", "--no-hierarchical-allreduce",
    "--hierarchical-allgather", "--no-hierarchical-allgather",
    "--autotune", "--no-autotune", "--autotune-log-file", "/tune.csv",
    "--autotune-warmup-samples", "2", "--autotune-steady-state-samples", "4",
    "--autotune-bayes-opt-max-samples", "6",
    "--autotune-gaussian-process-noise", "0.3",
    "--timeline-filename", "/tl.json", "--timeline-mark-cycles",
    "--zero-min-size", "99", "--executor", "mesh", "--group-max", "12",
    "--term-grace", "7.5", "--ckpt-dir", "/ckpt", "--ckpt-interval", "4",
    "--ckpt-keep", "3", "--no-stall-check", "--stall-check",
    "--stall-check-warning-time-seconds", "11",
    "--stall-check-shutdown-time-seconds", "13", "--abort-timeout", "12",
    "--heartbeat-interval", "0.5", "--liveness-timeout", "6",
    "--connect-retry-seconds", "8",
    "--fault-spec", "rank1:allreduce:2:crash,*:connect:1:refuse",
    "--drain", "--no-drain", "--rtt-alpha", "0.4",
    "--reconnect-budget", "7.5", "--replay-buffer-bytes", "65536",
    "--straggler-factor", "5", "--straggler-windows", "2",
    "--straggler-exclude", "--no-straggler-exclude", "--elastic",
    "--min-ranks", "2", "--max-ranks", "6", "--reconfig-timeout", "45",
    "--coord-failover", "--election-timeout", "4",
    "--log-level", "debug",
    "--log-hide-timestamp", "python", "train.py", "--lr", "0.1"]

CONFIG_YAML = """\
params:
  fusion_threshold_mb: 32
  cycle_time_ms: 2.5
  cache_capacity: 512  # comment
  hier_local_size: 2
  adasum_hierarchical: true
  compression: "bf16"
  hierarchical_allreduce: true
  hierarchical_allgather: yes
autotune:
  enabled: true
  log_file: /tmp/tune.csv
  warmup_samples: 2
  steady_state_samples: 5
  bayes_opt_max_samples: 7
  gaussian_process_noise: 0.4
timeline:
  filename: "/tmp/tl #1.json"
  mark_cycles: on
stall_check:
  disabled: false
  warning_time_seconds: 30
  shutdown_time_seconds: 40
logging:
  level: debug
  hide_timestamp: yes
timeouts:
  start_timeout: 45
network:
  interface: 'eth0'
fault_tolerance:
  term_grace: 9
  abort_timeout: 20
  heartbeat_interval: 1.5
  liveness_timeout: 10
  connect_retry_seconds: 12
  spec: "rank0:link:1:delay:5:2"
  drain: false
  rtt_alpha: 0.3
  reconnect_budget: 4
  replay_buffer_bytes: 1048576
  straggler_factor: 6
  straggler_windows: 4
  straggler_exclude: true
elastic:
  enabled: true
  min_ranks: 2
  max_ranks: 5
  reconfig_timeout: 30
  coord_failover: yes
  election_timeout: 3
checkpoint:
  dir: /tmp/run#3/ckpt
  interval: 5
  keep: 0
sharding:
  zero_min_size: 2048
  executor: psum
groups:
  max: 8
"""


def _port_flags():
    return {opt for action in runner.make_parser()._actions
            for opt in action.option_strings}


def test_port_flags_are_the_references():
    """The port exposes the reference's flags under their names, and
    none of those it leaves out; elastic membership's and the session
    layer's are among them."""
    jax_flags = {opt for action in jax_runner.make_parser()._actions
                 for opt in action.option_strings}
    assert _port_flags() <= jax_flags
    for absent in ("--tpu", "--global-mesh", "--race", "--proto-depth",
                   "--fuzz-seed", "--soak-ranks", "--controller",
                   "--ring-segment-bytes", "--ring-stripes",
                   "--tcp-ring-threshold", "--schedule"):
        assert absent not in _port_flags()
    for present in ("--elastic", "--min-ranks", "--max-ranks",
                    "--reconfig-timeout", "--coord-failover",
                    "--election-timeout", "--drain", "--no-drain",
                    "--rtt-alpha", "--reconnect-budget",
                    "--replay-buffer-bytes", "--straggler-factor",
                    "--straggler-windows", "--straggler-exclude",
                    "--no-straggler-exclude", "--autotune", "--no-autotune",
                    "--timeline-filename", "--timeline-mark-cycles",
                    "--hierarchical-allreduce", "--no-hierarchical-allgather"):
        assert present in _port_flags()


def test_every_port_flag_in_the_argv():
    """PORT_ARGV, the argv of the parity test below, covers every flag
    of the port's parser that sets a knob."""
    skip = {"-h", "--help", "-H", "--hosts", "--hostfile", "--ssh-port",
            "--mpi-args", "--launcher", "--verbose", "--version",
            "--output-filename", "--config-file", "-cb", "--check-build",
            "-np", "--num-proc"}
    assert _port_flags() - skip <= set(PORT_ARGV)


def _env(parser_mod, cfg, argv, yaml_path=None, simple=False):
    args = parser_mod.make_parser().parse_args(argv)
    if yaml_path is not None:
        tree = (cfg._parse_simple_yaml(yaml_path) if simple
                else cfg.load_config_file(yaml_path))
        if simple:
            tree = {arg: cfg._dig(tree, path)
                    for arg, (_, path) in cfg._PARAMS.items()
                    if cfg._dig(tree, path) is not None}
        cfg.apply_config_to_args(args, tree)
    return cfg.env_from_args(args), args.command


@pytest.mark.parametrize("argv", [
    PORT_ARGV,
    ["-np", "2", "--cycle-time-ms", "0", "--cache-capacity", "0",
     "python", "x.py"],
    ["-np", "1", "--stall-check", "python", "x.py"],
    ["-np", "4", "--hierarchical-allreduce", "--hierarchical-allgather",
     "--hier-local-size", "2", "--autotune", "--autotune-log-file", "t.csv",
     "--timeline-filename", "tl.json", "python", "x.py"],
    ["-np", "4", "--no-autotune", "--no-hierarchical-allreduce",
     "--no-hierarchical-allgather", "--timeline-mark-cycles", "python",
     "x.py"],
], ids=["every-flag", "explicit-zeros", "stall-check-on",
        "tune-timeline-hier", "negations"])
def test_env_from_args_matches_jax(argv):
    assert (_env(runner, config_parser, argv)
            == _env(jax_runner, jax_config_parser, argv))


@pytest.mark.parametrize("simple", [False, True],
                         ids=["load_config_file", "fallback-parser"])
@pytest.mark.parametrize("argv", [
    ["-np", "2", "python", "x.py"],
    ["-np", "2", "--cycle-time-ms", "5", "--ckpt-keep", "1",
     "--compression", "none", "python", "x.py"],
    ["-np", "2", "--no-autotune", "--no-hierarchical-allgather",
     "--autotune-warmup-samples", "9", "--timeline-filename", "cli.json",
     "python", "x.py"],
], ids=["file-only", "cli-over-file", "negations-over-file"])
def test_yaml_config_matches_jax(tmp_path, argv, simple):
    """The same file (through PyYAML where it imports, and through the
    fallback parser the card's machine uses) and argv give the same
    env; the port's file keys are the reference's."""
    path = tmp_path / "cfg.yaml"
    path.write_text(CONFIG_YAML)
    got = _env(runner, config_parser, argv, path, simple)
    want = _env(jax_runner, jax_config_parser, argv, path, simple)
    assert got == want
    assert got[0]["HVD_TPU_CKPT_DIR"] == "/tmp/run#3/ckpt"
    assert {arg: path for arg, (_, path) in config_parser._PARAMS.items()} \
        .items() <= {arg: path for arg, (_, path)
                     in jax_config_parser._PARAMS.items()}.items()


def test_fallback_yaml_parser_matches_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(CONFIG_YAML + "odd:\n  quoted: \"a #3\"\n")
    assert (config_parser._parse_simple_yaml(path)
            == jax_config_parser._parse_simple_yaml(path))


def test_config_from_env_matches_jax(monkeypatch):
    """The port's ``Config`` reads each knob it holds as the reference's
    ``Config`` reads it, and refuses the same typos with the same
    text."""
    from horovod_tpu.common.config import Config as JaxConfig

    for name, value in [("HVD_FUSION_THRESHOLD", "1234"),
                        ("HVD_CYCLE_TIME", "2.5"),
                        ("HVD_CACHE_CAPACITY", "9"),
                        ("HVD_STALL_CHECK_DISABLE", "1"),
                        ("HVD_STALL_CHECK_TIME_SECONDS", "7"),
                        ("HVD_ADASUM_HIERARCHICAL", "yes"),
                        ("HVD_TPU_COMPRESSION", "FP16"),
                        ("HVD_TPU_EXECUTOR", "mesh"),
                        ("HVD_TPU_ZERO_MIN_SIZE", "5"),
                        ("HVD_TPU_ELASTIC", "1"),
                        ("HVD_TPU_MIN_RANKS", "0"),
                        ("HVD_TPU_MAX_RANKS", "6"),
                        ("HVD_TPU_RECONFIG_TIMEOUT", "12.5"),
                        ("HVD_TPU_COORD_FAILOVER", "on"),
                        ("HVD_TPU_ELECTION_TIMEOUT", "3"),
                        ("HVD_TPU_DRAIN", "no"),
                        ("HVD_TPU_RTT_ALPHA", "0.5"),
                        ("HVD_TPU_STRAGGLER_FACTOR", "2.5"),
                        ("HVD_TPU_STRAGGLER_WINDOWS", "0"),
                        ("HVD_TPU_STRAGGLER_EXCLUDE", "1"),
                        ("HVD_TIMELINE", "/tmp/tl.json"),
                        ("HVD_TIMELINE_MARK_CYCLES", "yes"),
                        ("HVD_AUTOTUNE", "on"),
                        ("HVD_AUTOTUNE_LOG", "/tmp/tune.csv"),
                        ("HVD_AUTOTUNE_WARMUP_SAMPLES", "2"),
                        ("HVD_AUTOTUNE_STEADY_STATE_SAMPLES", "x"),
                        ("HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "7"),
                        ("HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", "0.25"),
                        ("HVD_HIERARCHICAL_ALLREDUCE", "1"),
                        ("HVD_HIERARCHICAL_ALLGATHER", "true")]:
        monkeypatch.setenv(name, value)
    got = dataclasses.asdict(config_mod.Config.from_env())
    want = dataclasses.asdict(JaxConfig.from_env())
    assert {k: got[k] for k in got if k in want} == {
        k: want[k] for k in got if k in want}
    tuned = {"timeline_path", "timeline_mark_cycles", "autotune",
             "autotune_log", "autotune_warmup_samples",
             "autotune_steady_state_samples",
             "autotune_bayes_opt_max_samples",
             "autotune_gaussian_process_noise", "hierarchical_allreduce",
             "hierarchical_allgather"}
    assert tuned <= set(got) & set(want)
    assert (got["autotune"], got["autotune_steady_state_samples"],
            got["hierarchical_allgather"]) == (True, 10, True)
    monkeypatch.setenv("HVD_HIER_LOCAL_SIZE", "2")
    monkeypatch.setenv("HVD_START_TIMEOUT", "9.5")
    cfg = config_mod.Config.from_env()
    assert (cfg.hier_local_size, cfg.start_timeout_seconds) == (2, 9.5)
    for name, bad in [("HVD_TPU_EXECUTOR", "bogus"),
                      ("HVD_TPU_ZERO_MIN_SIZE", "-1"),
                      ("HVD_TPU_MAX_RANKS", "-2"),
                      ("HVD_TPU_COMPRESSION", "zip")]:
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError) as want_err:
            JaxConfig.from_env()
        with pytest.raises(ValueError) as got_err:
            config_mod.Config.from_env()
        assert str(got_err.value) == str(want_err.value)
        monkeypatch.delenv(name)


# ---------------------------------------------------------------- topology --
TOPOLOGY_ENVS = {
    "contract": {"HVD_RANK": "3", "HVD_SIZE": "8", "HVD_LOCAL_RANK": "1",
                 "HVD_LOCAL_SIZE": "2", "HVD_CROSS_RANK": "1",
                 "HVD_CROSS_SIZE": "4"},
    "contract-defaults": {"HVD_RANK": "1", "HVD_SIZE": "2"},
    "contract-wins-over-ompi": {
        "HVD_RANK": "0", "HVD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
        "OMPI_COMM_WORLD_SIZE": "2", "HVD_RENDEZVOUS_ADDR": "127.0.0.1"},
    "host-slots": {"HVD_RENDEZVOUS_ADDR": "10.0.0.1",
                   "OMPI_COMM_WORLD_RANK": "4", "OMPI_COMM_WORLD_SIZE": "5",
                   "HVD_HOST_SLOTS": "a:3,b:2"},
    "host-slots-stale": {"HVD_RENDEZVOUS_ADDR": "10.0.0.1",
                         "OMPI_COMM_WORLD_RANK": "2",
                         "OMPI_COMM_WORLD_SIZE": "4",
                         "OMPI_COMM_WORLD_LOCAL_RANK": "0",
                         "OMPI_COMM_WORLD_LOCAL_SIZE": "2",
                         "HVD_HOST_SLOTS": "a:3,b:2"},
    "ompi": {"HVD_RENDEZVOUS_ADDR": "10.0.0.1", "OMPI_COMM_WORLD_RANK": "5",
             "OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_LOCAL_RANK": "1",
             "OMPI_COMM_WORLD_LOCAL_SIZE": "4"},
    "pmi": {"HVD_RENDEZVOUS_ADDR": "10.0.0.1", "PMI_RANK": "2",
            "PMI_SIZE": "4", "MPI_LOCALRANKID": "0", "MPI_LOCALNRANKS": "2"},
    "ompi-without-launcher": {"OMPI_COMM_WORLD_RANK": "1",
                              "OMPI_COMM_WORLD_SIZE": "2"},
    "nothing": {},
}


@pytest.mark.parametrize("name", sorted(TOPOLOGY_ENVS))
def test_topology_from_env_matches_jax(monkeypatch, name):
    for key in list(os.environ):
        if key.startswith(("HVD_", "OMPI_", "PMI_", "MPI_")):
            monkeypatch.delenv(key)
    for key, value in TOPOLOGY_ENVS[name].items():
        monkeypatch.setenv(key, value)
    got, want = topology.from_env(), jax_topology.from_env()
    if want is None:
        assert got is None
    else:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.is_homogeneous == want.is_homogeneous


def test_topology_leaves_device_mode_out():
    assert not hasattr(topology, "from_devices")


# ------------------------------------------------------------------ secret --
@pytest.mark.parametrize("payload", [b"", b"x", bytes(range(256)) * 40])
def test_secret_digests_match_jax(payload):
    key = jax_secret.make_secret_key()
    assert secret.DIGEST_LEN == jax_secret.DIGEST_LEN
    assert secret.sign(key, payload) == jax_secret.sign(key, payload)
    parts = (payload[:7], payload[7:], b"tail")
    assert (secret.sign_parts(key, *parts)
            == jax_secret.sign_parts(key, *parts)
            == jax_secret.sign(key, b"".join(parts)))
    digest = jax_secret.sign(key, payload)
    assert secret.check(key, payload, digest)
    assert not secret.check(key, payload + b"!", digest)
    assert not secret.check(secret.make_secret_key(), payload, digest)
    assert secret.check_parts(key, jax_secret.sign_parts(key, *parts),
                              *parts)
    assert len(secret.make_secret_key()) == 32


# -------------------------------------------------------------- KV server --
def _kv_session(client, port):
    """The verbs of the rendezvous KV, each answer recorded."""
    out = []
    client.put("127.0.0.1", port, "scope", "k1", b"value1")
    client.put("127.0.0.1", port, "scope", "k2", b"")
    out.append(client.get("127.0.0.1", port, "scope", "k1"))
    out.append(client.get("127.0.0.1", port, "scope", "k2"))
    out.append(client.list_keys("127.0.0.1", port, "scope"))
    out.append(client.list_keys("127.0.0.1", port, "empty"))
    out.append(client.cas_put("127.0.0.1", port, "elect", "w", b"first"))
    out.append(client.cas_put("127.0.0.1", port, "elect", "w", b"second"))
    client.delete("127.0.0.1", port, "scope", "k1")
    with pytest.raises(KeyError):
        client.get("127.0.0.1", port, "scope", "k1", timeout=0.2)
    client.delete_scope("127.0.0.1", port, "scope")
    out.append(client.list_keys("127.0.0.1", port, "scope"))

    def producer():
        time.sleep(0.3)
        client.put("127.0.0.1", port, "scope", "late", b"v")

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    out.append(client.get("127.0.0.1", port, "scope", "late", timeout=5))
    t.join(timeout=5)
    return out


@pytest.mark.parametrize("server_cls,client", [
    (JaxServer, http_client), (RendezvousServer, jax_client),
    (RendezvousServer, http_client)],
    ids=["port-client-jax-server", "jax-client-port-server",
         "port-client-port-server"])
def test_kv_verbs_match_jax(server_cls, client):
    """Each pairing answers every verb as the JAX client against the JAX
    server does; status codes included (a path without a key is 400)."""
    import urllib.error
    import urllib.request

    answers = []
    for cls, cli in ((JaxServer, jax_client), (server_cls, client)):
        server = cls()
        port = server.start()
        try:
            session = _kv_session(cli, port)
            assert server.get("elect", "w") == b"first"
            assert server.scope_size("elect") == 1
            req = urllib.request.Request(f"http://127.0.0.1:{port}/nokey",
                                         data=b"x", method="PUT")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=5)
            answers.append((session, err.value.code))
        finally:
            server.stop()
    assert answers[0] == answers[1]


def test_kv_client_retries_then_gives_up():
    """A server that is not there: the verb retries within its budget and
    raises the transport error."""
    import socket
    import urllib.error

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(urllib.error.URLError):
        http_client.put("127.0.0.1", port, "s", "k", b"v", retry_for=0.5)
    assert 0.3 < time.monotonic() - t0 < 10


# --------------------------------------------------------- safe_shell_exec --
@pytest.mark.parametrize("impl", [sse, jax_sse], ids=["port", "jax"])
@pytest.mark.parametrize("code", [0, 3])
def test_safe_shell_exec_exit_code_and_output(impl, code):
    out, err = io.StringIO(), io.StringIO()
    got = impl.execute(
        [sys.executable, "-c",
         f"import sys; print('out-line'); print('err-line', file=sys.stderr);"
         f" sys.exit({code})"], stdout=out, stderr=err)
    assert got == code
    assert out.getvalue() == "out-line\n" and err.getvalue() == "err-line\n"


def test_safe_shell_exec_shell_string_and_stdin():
    out = io.StringIO()
    assert sse.execute("read -r x; echo got:$x", stdout=out,
                       stdin_data=b"secret\n") == 0
    assert out.getvalue() == "got:secret\n"


def test_safe_shell_exec_event_terminates_the_tree(tmp_path):
    """A fired event kills the child's whole process group: the child
    and its grandchild; ``info`` marks the kill."""
    pid_file = tmp_path / "grandchild.pid"
    event = threading.Event()
    result, info = {}, {}
    script = (f"import subprocess, sys, time; "
              f"p = subprocess.Popen([sys.executable, '-c', "
              f"'import time; time.sleep(60)']); "
              f"open({str(pid_file)!r}, 'w').write(str(p.pid)); "
              f"time.sleep(60)")

    def run():
        result["code"] = sse.execute([sys.executable, "-c", script],
                                     events=[event], info=info)

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 20
    while not (pid_file.exists() and pid_file.read_text()):
        assert time.monotonic() < deadline
        time.sleep(0.05)
    event.set()
    t.join(timeout=20)
    assert not t.is_alive()
    assert result["code"] == -signal.SIGTERM
    assert info["terminated_by_event"] and "exit_ts" in info
    grandchild = int(pid_file.read_text())
    deadline = time.monotonic() + 10
    while _alive(grandchild):
        assert time.monotonic() < deadline, "grandchild outlived the tree"
        time.sleep(0.05)


def _alive(pid):
    """Running and not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_termination_grace_escalates_to_sigkill(monkeypatch):
    """A child that ignores SIGTERM is killed when the grace window
    (``HVD_TPU_TERM_GRACE``) ends."""
    import subprocess

    monkeypatch.setenv("HVD_TPU_TERM_GRACE", "0.5")
    assert sse.termination_grace_seconds() == jax_sse \
        .termination_grace_seconds() == 0.5
    proc = subprocess.Popen(
        [sys.executable, "-c", "import signal, sys, time; "
         "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
         "print('ready', flush=True); time.sleep(60)"],
        start_new_session=True, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline() == "ready\n"
        t0 = time.monotonic()
        sse.terminate_process_group(proc)
        assert proc.wait(timeout=10) == -signal.SIGKILL
        assert 0.4 < time.monotonic() - t0 < 8
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


# ------------------------------------------------------------------ launch --
@pytest.mark.parametrize("spec,np_total", ALLOCATIONS[:3])
def test_slot_env_matches_jax(spec, np_total):
    extra = {"HVD_SECRET_KEY": "a2V5", "HVD_TPU_COMPRESSION": "int8"}
    for got_slot, want_slot in zip(
            alloc.allocate(alloc.parse_hosts(spec), np_total),
            jax_alloc.allocate(jax_alloc.parse_hosts(spec), np_total)):
        assert (launch.slot_env(got_slot, "10.0.0.1", 4242, extra)
                == jax_launch.slot_env(want_slot, "10.0.0.1", 4242, extra))


PICK_CASES = {
    "earliest-death": ([(1, 3, False, 5.0), (0, -15, True, 6.0),
                        (2, 1, False, 4.0)], frozenset()),
    "reaped-before-culprit": ([(0, 1, False, 9.0), (3, 2, False, 1.5)],
                              frozenset()),
    "all-victims": ([(1, -15, True, 3.0), (2, -9, True, 2.0)], frozenset()),
    "no-timestamps": ([(2, 1, False, None), (1, 4, False, None)],
                      frozenset()),
    "armed-crash": ([(1, 3, False, 1.0), (2, 5, False, 2.0)],
                    frozenset({2})),
    "zero-exit-ignored": ([(0, 0, False, 0.5), (1, 7, False, 1.0)],
                          frozenset()),
}


@pytest.mark.parametrize("name", sorted(PICK_CASES))
def test_pick_culprit_matches_jax(name):
    failures, armed = PICK_CASES[name]
    assert (launch.pick_culprit(failures, armed)
            == jax_launch.pick_culprit(failures, armed))


@pytest.mark.parametrize("code", [0, 3, -9, -15, -200])
def test_describe_exit_matches_jax(code):
    assert launch.describe_exit(code) == jax_launch.describe_exit(code)


def test_ssh_command_matches_jax_and_keeps_the_key_off_the_line():
    slot = alloc.allocate(alloc.parse_hosts("remote:1"), 1)[0]
    env = launch.slot_env(slot, "10.0.0.1", 4242,
                          {"HVD_SECRET_KEY": "c2VjcmV0"})
    got = launch._ssh_command(slot, "python train.py", env, ssh_port=2222)
    assert got == jax_launch._ssh_command(slot, "python train.py", env,
                                          ssh_port=2222)
    assert "c2VjcmV0" not in got[0]
    assert got[1] == b"HVD_SECRET_KEY=c2VjcmV0\n"


def test_launch_job_names_the_culprit_and_writes_rank_logs(tmp_path):
    """One process a slot with the contract; rank 1 exits with 3, the
    others are terminated; the culprit's code is returned and per-rank
    logs land in rank.<NN>/."""
    slots = alloc.allocate([alloc.HostInfo("localhost", 3)], 3)
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "r = int(os.environ['HVD_RANK'])\n"
        "print('rank', r, os.environ['HVD_SIZE'], os.environ['X_EXTRA'],"
        " flush=True)\n"
        "if r == 1:\n    time.sleep(0.5); sys.exit(3)\n"
        "time.sleep(60)\n")
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("horovod_tpu_torch")
    logger.addHandler(handler)
    t0 = time.monotonic()
    try:
        code = launch.launch_job(slots, f"{sys.executable} {script}",
                                 "127.0.0.1", 1, extra_env={"X_EXTRA": "e"},
                                 output_filename=str(tmp_path / "logs"))
    finally:
        logger.removeHandler(handler)
    assert code == 3
    assert time.monotonic() - t0 < 30
    for r in range(3):
        out = (tmp_path / "logs" / f"rank.{r}" / "stdout").read_text()
        assert out == f"rank {r} 3 e\n"
    assert any("rank 1 failed first (exit code 3)" in r for r in records)


@pytest.mark.parametrize("dies,kw,want", [
    (1, {"elastic": True}, 0),
    (0, {"elastic": True}, 3),
    (0, {"elastic": True, "coord_failover": True}, 0),
    (1, {"elastic": True, "min_ranks": 3}, 3)])
def test_launch_job_refuses_what_needs_elastic_membership(tmp_path, dies,
                                                          kw, want):
    """What elastic membership makes of a lost rank (the JAX launcher's
    supervision, ``tests/test_coord_failover.py``'s launcher cases): a
    non-rank-0 loss leaves the survivors running to their end (exit 0);
    rank 0's loss, or one below ``min_ranks``, still fires the kill
    fan-out and names the culprit, unless fail-over is armed."""
    slots = alloc.allocate([alloc.HostInfo("localhost", 3)], 3)
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "r = int(os.environ['HVD_RANK'])\n"
        f"if r == {dies}:\n    sys.exit(3)\n"
        "time.sleep(2.0)\n")
    t0 = time.monotonic()
    code = launch.launch_job(slots, f"{sys.executable} {script}",
                             "127.0.0.1", 1, **kw)
    assert code == want
    # the fan-out ends the sleepers at once; supervision waits for them
    assert (time.monotonic() - t0 >= 2.0) == (want == 0)
    assert code == jax_launch.launch_job(
        slots, f"{sys.executable} {script}", "127.0.0.1", 1, **kw)


# ---------------------------------------------- delegated placement, LSF --
def test_mpirun_commands_match_jax():
    env = {"HVD_SIZE": "4", "PATH": "/usr/bin", "HOME": "/home/user",
           "PYTHONPATH": "/repo", "LD_LIBRARY_PATH": "/lib"}
    hosts = ",".join(f"h{i}:2" for i in range(70))
    for impl in (mpi_run.OPENMPI, mpi_run.SPECTRUM, mpi_run.MPICH):
        for spec, np_total in (("h1:2,h2:2", 4), (hosts, 140), (None, 2)):
            args = (np_total, spec, ["python", "train.py"])
            kw = dict(env=env, impl=impl, extra_args=["--mca", "x", "y"])
            assert (mpi_run.build_mpirun_command(*args, **kw)
                    == jax_mpi_run.build_mpirun_command(*args, **kw))
    for impl in (mpi_run.UNKNOWN, mpi_run.MISSING):
        with pytest.raises(RuntimeError, match="no usable MPI"):
            mpi_run.build_mpirun_command(2, None, ["x"], env=env, impl=impl)


@pytest.mark.parametrize("text,want", [
    ("mpirun (Open MPI) 4.1.4", "OpenMPI"), ("IBM Spectrum MPI 10.3",
                                            "SpectrumMPI"),
    ("HYDRA build details:", "MPICH"), ("something else", "Unknown")])
def test_detect_impl_matches_jax(monkeypatch, text, want):
    class Proc:
        stdout, stderr = text, ""

    monkeypatch.setattr("shutil.which", lambda _: "/usr/bin/mpirun")
    assert (mpi_run.detect_impl(lambda *a, **k: Proc())
            == jax_mpi_run.detect_impl(lambda *a, **k: Proc()) == want)


def test_jsrun_and_lsf_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("LSB_JOBID", "7")
    monkeypatch.setenv("LSB_MCPU_HOSTS", "a 4 b 4 c 2")
    assert lsf.using_lsf() and jax_lsf.using_lsf()
    for fn in ("get_compute_hosts", "get_slots_per_host",
               "get_num_processes", "host_spec"):
        assert getattr(lsf, fn)() == getattr(jax_lsf, fn)()
    monkeypatch.delenv("LSB_MCPU_HOSTS")
    monkeypatch.setenv("LSB_HOSTS", "a a b b b")
    assert lsf.get_slots_per_host() == jax_lsf.get_slots_per_host()
    trimmed = js_run._trim_allocation({"a": 4, "b": 4, "c": 2}, 9)
    assert trimmed == jax_js_run._trim_allocation({"a": 4, "b": 4, "c": 2},
                                                   9)
    got = js_run.generate_rankfile(trimmed, str(tmp_path / "p.erf"))
    want = jax_js_run.generate_rankfile(trimmed, str(tmp_path / "j.erf"))
    assert open(got).read() == open(want).read()
    for rankfile in (None, got):
        assert (js_run.build_jsrun_command(9, ["python", "t.py"], rankfile,
                                           ["-x"])
                == jax_js_run.build_jsrun_command(9, ["python", "t.py"],
                                                  rankfile, ["-x"]))


def test_runner_delegates_to_mpirun_with_the_contract(monkeypatch):
    """``--launcher mpirun``: one mpirun call with the constant contract
    (size, rendezvous, key; no per-rank values) and the host layout."""
    seen = {}

    def fake_mpi_run(num_proc, hosts, command, env=None, extra_args=None):
        seen.update(num_proc=num_proc, hosts=hosts, command=command,
                    env=env, extra_args=extra_args)
        return 0

    monkeypatch.setattr(mpi_run, "mpi_run", fake_mpi_run)
    monkeypatch.setattr(ssh_check, "check_all_hosts_ssh_successful",
                        lambda *a, **k: pytest.fail("no ssh check"))
    code = runner.run_commandline(
        ["-np", "4", "-H", "a:2,b:2", "--launcher", "mpirun", "--mpi-args",
         "--mca btl tcp", "--cycle-time-ms", "2", "python", "t.py"])
    assert code == 0
    assert (seen["num_proc"], seen["hosts"], seen["command"],
            seen["extra_args"]) == (4, "a:2,b:2", ["python", "t.py"],
                                    ["--mca", "btl", "tcp"])
    env = seen["env"]
    assert env["HVD_SIZE"] == "4" and "HVD_RANK" not in env
    assert env["HVD_CYCLE_TIME"] == "2.0" and env["HVD_CONTROLLER"] == "tcp"
    assert len(secret_key_bytes(env["HVD_SECRET_KEY"])) == 32
    assert env["HVD_RENDEZVOUS_ADDR"] and int(env["HVD_RENDEZVOUS_PORT"])


def secret_key_bytes(b64):
    import base64

    return base64.b64decode(b64)


def test_build_slots_matches_jax(monkeypatch, tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("a slots=2\nb:3\n")
    for argv in (["-np", "4", "-H", "a:2,b:2", "x"], ["-np", "3", "x"],
                 ["-np", "5", "--hostfile", str(hf), "x"]):
        got = runner.build_slots(runner.make_parser().parse_args(argv))
        want = jax_runner.build_slots(
            jax_runner.make_parser().parse_args(argv))
        assert _slots(got) == _slots(want)
    monkeypatch.setenv("LSB_JOBID", "1")
    monkeypatch.setenv("LSB_MCPU_HOSTS", "a 2 b 2")
    args = runner.make_parser().parse_args(["x"])
    jargs = jax_runner.make_parser().parse_args(["x"])
    assert _slots(runner.build_slots(args)) == _slots(
        jax_runner.build_slots(jargs))
    assert args.num_proc == jargs.num_proc == 4


def test_check_build_reports_the_ports_dependencies(capsys):
    assert runner.check_build(verbose=True) == 0
    out = capsys.readouterr().out
    for word in ("PyTorch", "nvcc", "kernel library built", "triton",
                 "NCCL", "gloo", "horovod_tpu_torch v"):
        assert word in out


def test_version_and_missing_command(capsys):
    assert runner.run_commandline(["--version"]) == 0
    assert capsys.readouterr().out.strip() == runner.__version__
    with pytest.raises(SystemExit):
        runner.run_commandline(["-np", "2"])


# -------------------------------------------------------- ssh preflight --
def test_ssh_check_matches_jax(tmp_path):
    """Local hosts skip the probe; remote ones are probed in parallel and
    the full unreachable list raised; successes are cached."""
    calls = []

    def probe(cmd, **kw):
        calls.append(cmd[-2])

        class R:
            returncode = 0 if cmd[-2].startswith("up") else 255
        return R()

    assert ssh_check.check_all_hosts_ssh_successful(
        ["localhost", "127.0.0.1"], runner=probe)
    assert calls == []
    for mod, cache in ((ssh_check, cache_mod.Cache(str(tmp_path / "p"))),
                       (jax_ssh_check, jax_cache.Cache(str(tmp_path / "j")))):
        with pytest.raises(RuntimeError) as err:
            mod.check_all_hosts_ssh_successful(
                ["up1", "down2", "down1", "localhost"], cache=cache,
                runner=probe)
        assert "['down1', 'down2']" in str(err.value)
        assert cache.get("ssh:up1") is True and cache.get("ssh:down1") is None
    assert ssh_check._probe("h", ssh_port=2222, runner=lambda c, **k: (
        calls.append(c) or type("R", (), {"returncode": 0})()))
    assert calls[-1] == ["ssh", "-o", "BatchMode=yes", "-o",
                         "StrictHostKeyChecking=no", "-o",
                         f"ConnectTimeout={ssh_check.SSH_TIMEOUT_S}", "-p",
                         "2222", "h", "true"]


def test_cache_and_host_hash_match_jax(tmp_path, monkeypatch):
    c = cache_mod.Cache(str(tmp_path / "c.json"), ttl_seconds=60,
                        parameters_hash="p1")
    c.put("k", [1, 2])
    assert cache_mod.Cache(str(tmp_path / "c.json"),
                           parameters_hash="p1").get("k") == [1, 2]
    assert jax_cache.Cache(str(tmp_path / "c.json"),
                           parameters_hash="p1").get("k") == [1, 2]
    assert cache_mod.Cache(str(tmp_path / "c.json"),
                           parameters_hash="p2").get("k") is None
    monkeypatch.setenv("HVD_HOSTNAME_HASH_SALT", "s")
    assert host_hash.host_hash() == jax_host_hash.host_hash()
    assert host_hash.host_hash("t") == jax_host_hash.host_hash("t")


def test_parser_namespace_defaults_are_unset():
    """Every knob flag defaults to None, so a config file fills exactly
    what the CLI left out (the reference's precedence rule)."""
    args = runner.make_parser().parse_args(["python", "x.py"])
    for arg in config_parser._PARAMS:
        assert getattr(args, arg) is None, arg
    assert isinstance(args, argparse.Namespace)
