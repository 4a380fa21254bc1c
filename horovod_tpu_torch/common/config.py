"""Runtime configuration, resolved from env vars at ``hvd.init()`` time
(port of ``horovod_tpu/common/config.py``; reference: knob parsing in
``horovod/common/operations.cc:404-500``).

The fields are those of the knobs the port reads at ``init``: the
eager plane's fusion threshold, cycle time, cache capacity, stall
warning and stall shutdown, the timeline, autotune and the hierarchical
allreduce and allgather, the control plane's abort, heartbeat and
liveness windows and the fault spec, the session layer's reconnect
budget and replay buffer, the degraded-network windows (RTT smoothing,
the straggler verdict), elastic membership with the
coordinator's fail-over and the drain, the job's default compression,
the plane's executor, ZeRO's replicated-update threshold, hierarchical
Adasum with its local size, and the gang-start deadline of the
rendezvous.  Field names, defaults and validation texts are the
reference's; ``hier_local_size`` and ``start_timeout_seconds`` have no
reference field (the reference reads those two variables where it uses
them).  Not ported, by decision (ROADMAP A.13e): ``controller`` (the
port has one eager plane), ``ring_segment_bytes``, ``ring_stripes`` and
``schedule`` (the JAX package's TCP data plane; NCCL carries every byte
here).
"""

import dataclasses

from horovod_tpu_torch.utils import env as env_util


@dataclasses.dataclass
class Config:
    fusion_threshold_bytes: int = env_util.DEFAULT_FUSION_THRESHOLD
    cycle_time_ms: float = env_util.DEFAULT_CYCLE_TIME_MS
    cache_capacity: int = env_util.DEFAULT_CACHE_CAPACITY
    timeline_path: str | None = None
    timeline_mark_cycles: bool = False
    stall_check_disable: bool = False
    stall_warning_seconds: float = env_util.DEFAULT_STALL_WARNING_SECONDS
    stall_shutdown_seconds: float = 0.0
    autotune: bool = False
    autotune_log: str | None = None
    autotune_warmup_samples: int = 3
    autotune_steady_state_samples: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # Opt-in: hierarchical Adasum changes the result (Adasum of the
    # local groups' averages), it is not a schedule-only switch.
    adasum_hierarchical: bool = False
    # ranks per fast group of the hierarchy (0: the launcher's local
    # size)
    hier_local_size: int = 0
    # Default on-the-wire allreduce compression ("none" | "bf16" |
    # "fp16" | "int8") for requests that don't pass one explicitly.
    compression: str = "none"
    # the eager plane's executor: "psum" over the world, "mesh" over a
    # mesh's dp axis (sharding/mesh_executor.py)
    executor: str = "psum"
    # flat parameter count below which ZeroDistributedOptimizer keeps
    # the update replicated
    zero_min_size: int = env_util.DEFAULT_ZERO_MIN_SIZE
    # how long a rank waits for rank 0's store address at the rendezvous
    start_timeout_seconds: float = env_util.DEFAULT_START_TIMEOUT_SECONDS
    # Fault-tolerant runtime knobs (ops/tcp_controller.py): bound on
    # abort propagation, heartbeat period, missed-heartbeat window
    # (0 disables liveness tracking), and the deterministic fault spec.
    abort_timeout_seconds: float = env_util.DEFAULT_ABORT_TIMEOUT_SECONDS
    heartbeat_interval_seconds: float = \
        env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS
    liveness_timeout_seconds: float = \
        env_util.DEFAULT_LIVENESS_TIMEOUT_SECONDS
    fault_spec: str | None = None
    # Degraded-network tolerance: RTT EWMA smoothing, the k x median
    # straggler verdict (k = factor, m = windows), and whether a
    # confirmed straggler is proposed for a drain-style exclusion under
    # elastic.
    rtt_alpha: float = env_util.DEFAULT_RTT_ALPHA
    # The session layer (run/service/network.py): the reconnect window a
    # broken coordinator link may heal inside (0 = off, a break
    # escalates at once) and the bound on the client's replay buffer of
    # unacknowledged frames.
    reconnect_budget_seconds: float = \
        env_util.DEFAULT_RECONNECT_BUDGET_SECONDS
    replay_buffer_bytes: int = env_util.DEFAULT_REPLAY_BUFFER_BYTES
    straggler_factor: float = env_util.DEFAULT_STRAGGLER_FACTOR
    straggler_windows: int = env_util.DEFAULT_STRAGGLER_WINDOWS
    straggler_exclude: bool = False
    # Elastic membership: survive rank loss by re-forming the world;
    # bounds on the reconfiguration window and on the membership's size.
    elastic: bool = False
    reconfig_timeout_seconds: float = \
        env_util.DEFAULT_RECONFIG_TIMEOUT_SECONDS
    min_ranks: int = env_util.DEFAULT_MIN_RANKS
    max_ranks: int = env_util.DEFAULT_MAX_RANKS
    # Coordinator fail-over: the survivors of a rank-0 loss race a CAS
    # election at the launcher's KV and re-form under a new coordinator.
    coord_failover: bool = False
    election_timeout_seconds: float = \
        env_util.DEFAULT_ELECTION_TIMEOUT_SECONDS
    # the graceful drain: a worker's SIGTERM becomes a planned departure
    drain: bool = True

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold_bytes=env_util.get_int(
                env_util.HVD_FUSION_THRESHOLD,
                env_util.DEFAULT_FUSION_THRESHOLD),
            cycle_time_ms=env_util.get_float(
                env_util.HVD_CYCLE_TIME, env_util.DEFAULT_CYCLE_TIME_MS),
            cache_capacity=env_util.get_int(
                env_util.HVD_CACHE_CAPACITY, env_util.DEFAULT_CACHE_CAPACITY),
            timeline_path=env_util.get_str(env_util.HVD_TIMELINE),
            timeline_mark_cycles=env_util.get_bool(
                env_util.HVD_TIMELINE_MARK_CYCLES),
            stall_check_disable=env_util.get_bool(
                env_util.HVD_STALL_CHECK_DISABLE),
            stall_warning_seconds=env_util.get_float(
                env_util.HVD_STALL_CHECK_TIME_SECONDS,
                env_util.DEFAULT_STALL_WARNING_SECONDS),
            stall_shutdown_seconds=env_util.get_float(
                env_util.HVD_STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            autotune=env_util.get_bool(env_util.HVD_AUTOTUNE),
            autotune_log=env_util.get_str(env_util.HVD_AUTOTUNE_LOG),
            autotune_warmup_samples=env_util.get_int(
                env_util.HVD_AUTOTUNE_WARMUP_SAMPLES, 3),
            autotune_steady_state_samples=env_util.get_int(
                env_util.HVD_AUTOTUNE_STEADY_STATE_SAMPLES, 10),
            autotune_bayes_opt_max_samples=env_util.get_int(
                env_util.HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES, 20),
            autotune_gaussian_process_noise=env_util.get_float(
                env_util.HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE, 0.8),
            hierarchical_allreduce=env_util.get_bool(
                env_util.HVD_HIERARCHICAL_ALLREDUCE),
            hierarchical_allgather=env_util.get_bool(
                env_util.HVD_HIERARCHICAL_ALLGATHER),
            adasum_hierarchical=env_util.get_bool(
                env_util.HVD_ADASUM_HIERARCHICAL),
            hier_local_size=env_util.get_int(
                env_util.HVD_HIER_LOCAL_SIZE, 0),
            compression=_validated_compression(env_util.get_str(
                env_util.HVD_TPU_COMPRESSION, "none")),
            executor=_validated_executor(env_util.get_str(
                env_util.HVD_TPU_EXECUTOR, "psum")),
            zero_min_size=_validated_nonneg(
                env_util.HVD_TPU_ZERO_MIN_SIZE,
                env_util.DEFAULT_ZERO_MIN_SIZE),
            start_timeout_seconds=env_util.get_float(
                env_util.HVD_START_TIMEOUT,
                env_util.DEFAULT_START_TIMEOUT_SECONDS),
            abort_timeout_seconds=env_util.get_float(
                env_util.HVD_TPU_ABORT_TIMEOUT,
                env_util.DEFAULT_ABORT_TIMEOUT_SECONDS),
            heartbeat_interval_seconds=env_util.get_float(
                env_util.HVD_TPU_HEARTBEAT_INTERVAL,
                env_util.DEFAULT_HEARTBEAT_INTERVAL_SECONDS),
            liveness_timeout_seconds=env_util.get_float(
                env_util.HVD_TPU_LIVENESS_TIMEOUT,
                env_util.DEFAULT_LIVENESS_TIMEOUT_SECONDS),
            fault_spec=_validated_fault_spec(env_util.get_str(
                env_util.HVD_TPU_FAULT_SPEC)),
            rtt_alpha=env_util.get_float(
                env_util.HVD_TPU_RTT_ALPHA, env_util.DEFAULT_RTT_ALPHA),
            reconnect_budget_seconds=env_util.get_float(
                env_util.HVD_TPU_RECONNECT_BUDGET,
                env_util.DEFAULT_RECONNECT_BUDGET_SECONDS),
            replay_buffer_bytes=_validated_nonneg(
                env_util.HVD_TPU_REPLAY_BUFFER_BYTES,
                env_util.DEFAULT_REPLAY_BUFFER_BYTES),
            straggler_factor=env_util.get_float(
                env_util.HVD_TPU_STRAGGLER_FACTOR,
                env_util.DEFAULT_STRAGGLER_FACTOR),
            straggler_windows=max(1, env_util.get_int(
                env_util.HVD_TPU_STRAGGLER_WINDOWS,
                env_util.DEFAULT_STRAGGLER_WINDOWS)),
            straggler_exclude=env_util.get_bool(
                env_util.HVD_TPU_STRAGGLER_EXCLUDE),
            elastic=env_util.get_bool(env_util.HVD_TPU_ELASTIC),
            reconfig_timeout_seconds=env_util.get_float(
                env_util.HVD_TPU_RECONFIG_TIMEOUT,
                env_util.DEFAULT_RECONFIG_TIMEOUT_SECONDS),
            min_ranks=max(1, env_util.get_int(
                env_util.HVD_TPU_MIN_RANKS, env_util.DEFAULT_MIN_RANKS)),
            max_ranks=_validated_nonneg(
                env_util.HVD_TPU_MAX_RANKS, env_util.DEFAULT_MAX_RANKS),
            coord_failover=env_util.get_bool(
                env_util.HVD_TPU_COORD_FAILOVER),
            election_timeout_seconds=env_util.get_float(
                env_util.HVD_TPU_ELECTION_TIMEOUT,
                env_util.DEFAULT_ELECTION_TIMEOUT_SECONDS),
            drain=env_util.get_bool(env_util.HVD_TPU_DRAIN, True),
        )


def effective_heartbeat_interval(config) -> float:
    """The heartbeat period the control plane actually runs: the
    configured interval clamped to at most a quarter of the abort
    deadline (so abort propagation meets it); 0 only when the interval
    AND the abort timeout are both disabled."""
    interval = config.heartbeat_interval_seconds
    if config.abort_timeout_seconds > 0:
        interval = min(interval or 1e9,
                       config.abort_timeout_seconds / 4.0)
    return interval


def _validated_nonneg(name, default):
    """A negative count fails at init() like the other validated
    knobs."""
    value = env_util.get_int(name, default)
    if value < 0:
        raise ValueError(f"{name} must be >= 0, got {value}")
    return value


def _validated_fault_spec(text):
    """Same fail-at-init rule as compression: a fault spec with a typo
    would otherwise silently never fire and the chaos run would prove
    nothing."""
    if text:
        from horovod_tpu_torch.common.faults import parse_fault_spec

        parse_fault_spec(text)
    return text


def _validated_executor(name: str) -> str:
    """Same fail-at-init rule: an HVD_TPU_EXECUTOR typo must not
    silently run the default data plane."""
    if name not in ("psum", "mesh"):
        raise ValueError(
            f"HVD_TPU_EXECUTOR must be 'psum' or 'mesh', got {name!r}")
    return name


def _validated_compression(name: str) -> str:
    """Fail at init() with a clear message rather than at the first
    allreduce when HVD_TPU_COMPRESSION holds a typo."""
    from horovod_tpu_torch.common.compression import resolve_compression

    return resolve_compression(name)
