"""Environment-variable surface of the PyTorch port.

The subset of ``horovod_tpu/utils/env.py`` that the port reads: the
launcher -> worker rank contract and the job key, the launcher's own
knobs (start timeout, termination grace, interface, logging), the fusion
threshold, the job-wide default compression, ZeRO's replicated-update
threshold, the cap on live process groups, the eager plane's executor
and its cycle, cache and stall knobs, the control plane's abort,
heartbeat, liveness and connect-retry windows and the fault spec, the
session layer's reconnect budget and replay buffer, the drain and the
degraded-network knobs, elastic membership with the coordinator's
fail-over, hierarchical Adasum, the hierarchical
allreduce and allgather, the timeline, autotune, and durable
checkpointing.  Kept as a copy so that the port never imports the JAX
package.

Every knob outside ``LAUNCHER_CONTRACT`` has an ``hvdrun-torch`` flag
and a YAML key in ``run/config_parser.py`` (the reference's
tri-surface rule, ``bin/hvd-lint``'s config-surface checker).
"""

import logging
import os
import threading

HVD_FUSION_THRESHOLD = "HVD_FUSION_THRESHOLD"          # bytes, default 64 MB
HVD_CYCLE_TIME = "HVD_CYCLE_TIME"                      # ms, default 1.0
HVD_CACHE_CAPACITY = "HVD_CACHE_CAPACITY"              # default 1024
HVD_STALL_CHECK_DISABLE = "HVD_STALL_CHECK_DISABLE"
HVD_STALL_CHECK_TIME_SECONDS = "HVD_STALL_CHECK_TIME_SECONDS"  # default 60
HVD_STALL_SHUTDOWN_TIME_SECONDS = "HVD_STALL_SHUTDOWN_TIME_SECONDS"
# default on-the-wire allreduce compression: none | bf16 | fp16 | int8
HVD_TPU_COMPRESSION = "HVD_TPU_COMPRESSION"
# flat parameter count below which ZeroDistributedOptimizer keeps the
# update replicated (tiny models pay more in collective latency than they
# save in state memory)
HVD_TPU_ZERO_MIN_SIZE = "HVD_TPU_ZERO_MIN_SIZE"
# cap on live process groups (hvd.new_group); groups leak when created
# per step
HVD_TPU_GROUP_MAX = "HVD_TPU_GROUP_MAX"
# the eager plane's executor: psum (over the world) | mesh (over a mesh's
# dp axis, sharding/mesh_executor.py)
HVD_TPU_EXECUTOR = "HVD_TPU_EXECUTOR"
# ranks per fast group of the hierarchy (default: HVD_LOCAL_SIZE)
HVD_HIER_LOCAL_SIZE = "HVD_HIER_LOCAL_SIZE"
# opt-in hierarchical Adasum: Adasum of the local groups' averages, a
# different result from the flat Adasum of every rank's tensor
HVD_ADASUM_HIERARCHICAL = "HVD_ADASUM_HIERARCHICAL"
# the eager plane's two-level allreduce and allgather over the (cross,
# local) grid: a schedule, the same sums in another order
HVD_HIERARCHICAL_ALLREDUCE = "HVD_HIERARCHICAL_ALLREDUCE"
HVD_HIERARCHICAL_ALLGATHER = "HVD_HIERARCHICAL_ALLGATHER"

# --- timeline and autotune (utils/timeline.py, ops/autotune.py) -------------
HVD_TIMELINE = "HVD_TIMELINE"                  # path -> enable timeline
HVD_TIMELINE_MARK_CYCLES = "HVD_TIMELINE_MARK_CYCLES"
HVD_AUTOTUNE = "HVD_AUTOTUNE"
HVD_AUTOTUNE_LOG = "HVD_AUTOTUNE_LOG"          # rank 0's CSV of the walk
HVD_AUTOTUNE_WARMUP_SAMPLES = "HVD_AUTOTUNE_WARMUP_SAMPLES"
HVD_AUTOTUNE_STEADY_STATE_SAMPLES = "HVD_AUTOTUNE_STEADY_STATE_SAMPLES"
HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = "HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"

# --- the coordinated control plane (ops/tcp_controller.py) -------------------
# bound on "abort initiated anywhere -> every rank raises HvdAbortedError"
HVD_TPU_ABORT_TIMEOUT = "HVD_TPU_ABORT_TIMEOUT"
# coordinator heartbeat period, seconds
HVD_TPU_HEARTBEAT_INTERVAL = "HVD_TPU_HEARTBEAT_INTERVAL"
# missed-heartbeat window: a rank silent for longer is declared dead and
# the coordinator converts the silence into a coordinated abort (0 = off)
HVD_TPU_LIVENESS_TIMEOUT = "HVD_TPU_LIVENESS_TIMEOUT"
# deadline budget for connection-establishment retry (backoff + jitter)
HVD_TPU_CONNECT_RETRY_SECONDS = "HVD_TPU_CONNECT_RETRY_SECONDS"
# deterministic fault injection spec (common/faults.py grammar)
HVD_TPU_FAULT_SPEC = "HVD_TPU_FAULT_SPEC"
# reconnect window: on a mid-stream break of a rank's coordinator link
# the client heals the session in place (reconnect with backoff, the
# session handshake, replay of the unacknowledged frames) for up to this
# many seconds before the original transport error goes to the abort
# path (0 = off: every break escalates at once, the frames as without
# the session layer)
HVD_TPU_RECONNECT_BUDGET = "HVD_TPU_RECONNECT_BUDGET"
# bound on the client's replay buffer of unacknowledged session frames
# (bytes); a heal that would need a frame older than the oldest one kept
# escalates instead of resuming with a silent gap
HVD_TPU_REPLAY_BUFFER_BYTES = "HVD_TPU_REPLAY_BUFFER_BYTES"

# graceful drain: a worker turns SIGTERM (the preemption notice) into a
# planned departure instead of dying as a crash (default on)
HVD_TPU_DRAIN = "HVD_TPU_DRAIN"

# --- degraded-network tolerance ----------------------------------------------
# EWMA smoothing factor of each rank's control-plane round trips; the
# liveness window widens by an RTT-proportional slack so that a slow but
# live rank is not aborted as dead
HVD_TPU_RTT_ALPHA = "HVD_TPU_RTT_ALPHA"
# k of the straggler verdict (rank RTT > k x median for m windows) and
# the multiplier of the RTT slack added to the liveness window
HVD_TPU_STRAGGLER_FACTOR = "HVD_TPU_STRAGGLER_FACTOR"
# m of the straggler verdict: consecutive liveness scans a rank must
# exceed k x median before the verdict is recorded
HVD_TPU_STRAGGLER_WINDOWS = "HVD_TPU_STRAGGLER_WINDOWS"
# under elastic, a confirmed straggler is proposed for a drain-style
# exclusion (a reconfiguration, no abort) instead of only logged
HVD_TPU_STRAGGLER_EXCLUDE = "HVD_TPU_STRAGGLER_EXCLUDE"

# --- elastic membership (elastic/, ops/tcp_controller.py) --------------------
# survive rank loss: re-form the world at a new membership epoch instead
# of aborting the job
HVD_TPU_ELASTIC = "HVD_TPU_ELASTIC"
# budget for one reconfiguration: the survivors must rendezvous again
# and make their groups within this many seconds
HVD_TPU_RECONFIG_TIMEOUT = "HVD_TPU_RECONFIG_TIMEOUT"
# below this many survivors a failure is fatal even under elastic
HVD_TPU_MIN_RANKS = "HVD_TPU_MIN_RANKS"
# cap on the membership after admitting late joiners (0 = unlimited)
HVD_TPU_MAX_RANKS = "HVD_TPU_MAX_RANKS"
# coordinator fail-over: the survivors of a rank-0 loss elect a new
# coordinator at the launcher's KV instead of aborting
HVD_TPU_COORD_FAILOVER = "HVD_TPU_COORD_FAILOVER"
# budget for one fail-over election (the CAS and adopting its winner)
HVD_TPU_ELECTION_TIMEOUT = "HVD_TPU_ELECTION_TIMEOUT"

HVD_LOG_LEVEL = "HVD_LOG_LEVEL"      # trace|debug|info|warning|error|fatal
HVD_LOG_HIDE_TIME = "HVD_LOG_HIDE_TIME"
# the process-mode controller the workers run; the port has one (the
# eager plane), and its launcher exports the reference's value so that
# both packages' workers read one contract
HVD_CONTROLLER = "HVD_CONTROLLER"

# --- durable sharded checkpointing --------------------------------------------
# checkpoint directory (unset = durable checkpointing off): each rank
# writes its parameter and optimizer shard there from the commit snapshot
HVD_TPU_CKPT_DIR = "HVD_TPU_CKPT_DIR"
# commit-steps between checkpoint snapshots (default 10)
HVD_TPU_CKPT_INTERVAL = "HVD_TPU_CKPT_INTERVAL"
# complete checkpoints retained before pruning (default 2; 0 = keep all)
HVD_TPU_CKPT_KEEP = "HVD_TPU_CKPT_KEEP"

# --- launcher -> worker contract ---------------------------------------------
HVD_RANK = "HVD_RANK"
HVD_SIZE = "HVD_SIZE"
HVD_LOCAL_RANK = "HVD_LOCAL_RANK"
HVD_LOCAL_SIZE = "HVD_LOCAL_SIZE"
HVD_CROSS_RANK = "HVD_CROSS_RANK"
HVD_CROSS_SIZE = "HVD_CROSS_SIZE"
HVD_SECRET_KEY = "HVD_SECRET_KEY"              # base64 job secret (HMAC)
# the launcher's rendezvous KV server (run/http_server.py); rank 0
# publishes its torch.distributed store's address there
HVD_RENDEZVOUS_ADDR = "HVD_RENDEZVOUS_ADDR"
HVD_RENDEZVOUS_PORT = "HVD_RENDEZVOUS_PORT"
HVD_IFACE = "HVD_IFACE"        # NIC whose address rank 0's store binds
HVD_HOST_SLOTS = "HVD_HOST_SLOTS"      # "h1:n1,h2:n2" rank-block layout
HVD_START_TIMEOUT = "HVD_START_TIMEOUT"  # gang-start deadline, s (default 120)
# explicit rendezvous-reachability override for the launcher host
HVD_RENDEZVOUS_HOST_ADDR = "HVD_RENDEZVOUS_HOST_ADDR"
# the launcher's SIGTERM -> SIGKILL escalation window, s (default 5)
HVD_TPU_TERM_GRACE = "HVD_TPU_TERM_GRACE"
# the NIC-discovery task server (run/service/task_main.py; the job key
# rides its stdin, never its environment or command line)
HVD_TASK_INDEX = "HVD_TASK_INDEX"
HVD_DRIVER_ADDRS = "HVD_DRIVER_ADDRS"          # "ip:port;ip:port"
HVD_TASK_TIMEOUT = "HVD_TASK_TIMEOUT"          # seconds, default 120
# folded into run/host_hash.py's identity (containers sharing a hostname)
HVD_HOSTNAME_HASH_SALT = "HVD_HOSTNAME_HASH_SALT"  # hvd-lint: ignore[config-surface]

# The launcher -> worker contract above is exempt from the tri-surface
# rule: the launcher writes it, no user sets it by flag.
LAUNCHER_CONTRACT = frozenset({
    HVD_RANK, HVD_SIZE, HVD_LOCAL_RANK, HVD_LOCAL_SIZE,
    HVD_CROSS_RANK, HVD_CROSS_SIZE, HVD_SECRET_KEY,
    HVD_RENDEZVOUS_ADDR, HVD_RENDEZVOUS_PORT, HVD_HOST_SLOTS,
    HVD_RENDEZVOUS_HOST_ADDR, HVD_CONTROLLER, HVD_TASK_INDEX,
    HVD_DRIVER_ADDRS, HVD_TASK_TIMEOUT,
})

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_STALL_WARNING_SECONDS = 60
DEFAULT_ABORT_TIMEOUT_SECONDS = 30.0
DEFAULT_HEARTBEAT_INTERVAL_SECONDS = 2.0
DEFAULT_LIVENESS_TIMEOUT_SECONDS = 15.0
DEFAULT_CONNECT_RETRY_SECONDS = 30.0
# the session heal is opt-in: a dead peer keeps surfacing through the
# abort and liveness path until a deployment grants a reconnect window
DEFAULT_RECONNECT_BUDGET_SECONDS = 0.0
DEFAULT_REPLAY_BUFFER_BYTES = 64 << 20
DEFAULT_ZERO_MIN_SIZE = 1024  # flat params below this stay replicated
DEFAULT_GROUP_MAX = 64  # live process groups per job
DEFAULT_CKPT_INTERVAL_STEPS = 10
DEFAULT_CKPT_KEEP = 2
DEFAULT_START_TIMEOUT_SECONDS = 120.0
DEFAULT_RECONFIG_TIMEOUT_SECONDS = 60.0
DEFAULT_MIN_RANKS = 1
DEFAULT_MAX_RANKS = 0  # unlimited
DEFAULT_ELECTION_TIMEOUT_SECONDS = 10.0
DEFAULT_RTT_ALPHA = 0.25
DEFAULT_STRAGGLER_FACTOR = 4.0
DEFAULT_STRAGGLER_WINDOWS = 3

_warned = set()
_warned_lock = threading.Lock()

_TRUE_WORDS = ("1", "true", "yes", "on")
_FALSE_WORDS = ("0", "false", "no", "off")


def _warn_malformed(name, value, default):
    with _warned_lock:
        if name in _warned:
            return
        _warned.add(name)
    logging.getLogger("horovod_tpu_torch").warning(
        "ignoring malformed %s=%r: using default %r", name, value,
        default)


def get_int(name, default=0):
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    try:
        return int(value)
    except ValueError:
        _warn_malformed(name, value, default)
        return default


def get_bool(name, default=False):
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    word = value.strip().lower()
    if word in _TRUE_WORDS:
        return True
    if word not in _FALSE_WORDS:
        _warn_malformed(name, value, default)
        return default
    return False


def get_str(name, default=None):
    value = os.environ.get(name)
    return default if value in (None, "") else value


def get_float(name, default=0.0):
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    try:
        return float(value)
    except ValueError:
        _warn_malformed(name, value, default)
        return default


def get_required(name):
    """A launcher-contract variable that must be present (the worker entry
    points): missing means the process was started outside its
    launcher."""
    value = os.environ.get(name)
    if value in (None, ""):
        raise RuntimeError(
            f"{name} is not set: this entry point runs under the launcher "
            f"(python -m horovod_tpu_torch.run)")
    return value
