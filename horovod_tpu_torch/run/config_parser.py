"""Tri-surface configuration: YAML config file <-> CLI args <-> env vars
(port of ``horovod_tpu/run/config_parser.py``).

Reference: ``horovod/run/common/util/config_parser.py``: a YAML file sets
the same knobs as CLI flags; CLI flags override the file; everything lands
in the worker env contract (``set_env_from_args``).  The knobs are those
the port reads (``utils/env.py``), under the reference's flag names and
YAML paths; the reference's others join with the module that reads them.
"""

from horovod_tpu_torch.utils import env as env_util

# arg name -> (env var, yaml path)
_PARAMS = {
    "fusion_threshold_mb": (env_util.HVD_FUSION_THRESHOLD,
                            "params.fusion_threshold_mb"),
    "cycle_time_ms": (env_util.HVD_CYCLE_TIME, "params.cycle_time_ms"),
    "cache_capacity": (env_util.HVD_CACHE_CAPACITY,
                       "params.cache_capacity"),
    "hierarchical_allreduce": (env_util.HVD_HIERARCHICAL_ALLREDUCE,
                               "params.hierarchical_allreduce"),
    "hierarchical_allgather": (env_util.HVD_HIERARCHICAL_ALLGATHER,
                               "params.hierarchical_allgather"),
    "hier_local_size": (env_util.HVD_HIER_LOCAL_SIZE,
                        "params.hier_local_size"),
    "adasum_hierarchical": (env_util.HVD_ADASUM_HIERARCHICAL,
                            "params.adasum_hierarchical"),
    "compression": (env_util.HVD_TPU_COMPRESSION, "params.compression"),
    "autotune": (env_util.HVD_AUTOTUNE, "autotune.enabled"),
    "autotune_log_file": (env_util.HVD_AUTOTUNE_LOG, "autotune.log_file"),
    "autotune_warmup_samples": (env_util.HVD_AUTOTUNE_WARMUP_SAMPLES,
                                "autotune.warmup_samples"),
    "autotune_steady_state_samples": (
        env_util.HVD_AUTOTUNE_STEADY_STATE_SAMPLES,
        "autotune.steady_state_samples"),
    "autotune_bayes_opt_max_samples": (
        env_util.HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES,
        "autotune.bayes_opt_max_samples"),
    "autotune_gaussian_process_noise": (
        env_util.HVD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE,
        "autotune.gaussian_process_noise"),
    "timeline_filename": (env_util.HVD_TIMELINE, "timeline.filename"),
    "timeline_mark_cycles": (env_util.HVD_TIMELINE_MARK_CYCLES,
                             "timeline.mark_cycles"),
    "no_stall_check": (env_util.HVD_STALL_CHECK_DISABLE,
                       "stall_check.disabled"),
    "stall_check_warning_time_seconds": (
        env_util.HVD_STALL_CHECK_TIME_SECONDS,
        "stall_check.warning_time_seconds"),
    "stall_check_shutdown_time_seconds": (
        env_util.HVD_STALL_SHUTDOWN_TIME_SECONDS,
        "stall_check.shutdown_time_seconds"),
    "log_level": (env_util.HVD_LOG_LEVEL, "logging.level"),
    "log_hide_timestamp": (env_util.HVD_LOG_HIDE_TIME,
                           "logging.hide_timestamp"),
    "start_timeout": (env_util.HVD_START_TIMEOUT, "timeouts.start_timeout"),
    "network_interface": (env_util.HVD_IFACE, "network.interface"),
    "abort_timeout": (env_util.HVD_TPU_ABORT_TIMEOUT,
                      "fault_tolerance.abort_timeout"),
    "heartbeat_interval": (env_util.HVD_TPU_HEARTBEAT_INTERVAL,
                           "fault_tolerance.heartbeat_interval"),
    "liveness_timeout": (env_util.HVD_TPU_LIVENESS_TIMEOUT,
                         "fault_tolerance.liveness_timeout"),
    "connect_retry_seconds": (env_util.HVD_TPU_CONNECT_RETRY_SECONDS,
                              "fault_tolerance.connect_retry_seconds"),
    "fault_spec": (env_util.HVD_TPU_FAULT_SPEC, "fault_tolerance.spec"),
    "term_grace": (env_util.HVD_TPU_TERM_GRACE,
                   "fault_tolerance.term_grace"),
    "drain": (env_util.HVD_TPU_DRAIN, "fault_tolerance.drain"),
    "rtt_alpha": (env_util.HVD_TPU_RTT_ALPHA, "fault_tolerance.rtt_alpha"),
    "reconnect_budget": (env_util.HVD_TPU_RECONNECT_BUDGET,
                         "fault_tolerance.reconnect_budget"),
    "replay_buffer_bytes": (env_util.HVD_TPU_REPLAY_BUFFER_BYTES,
                            "fault_tolerance.replay_buffer_bytes"),
    "straggler_factor": (env_util.HVD_TPU_STRAGGLER_FACTOR,
                         "fault_tolerance.straggler_factor"),
    "straggler_windows": (env_util.HVD_TPU_STRAGGLER_WINDOWS,
                          "fault_tolerance.straggler_windows"),
    "straggler_exclude": (env_util.HVD_TPU_STRAGGLER_EXCLUDE,
                          "fault_tolerance.straggler_exclude"),
    "elastic": (env_util.HVD_TPU_ELASTIC, "elastic.enabled"),
    "min_ranks": (env_util.HVD_TPU_MIN_RANKS, "elastic.min_ranks"),
    "max_ranks": (env_util.HVD_TPU_MAX_RANKS, "elastic.max_ranks"),
    "reconfig_timeout": (env_util.HVD_TPU_RECONFIG_TIMEOUT,
                         "elastic.reconfig_timeout"),
    "coord_failover": (env_util.HVD_TPU_COORD_FAILOVER,
                       "elastic.coord_failover"),
    "election_timeout": (env_util.HVD_TPU_ELECTION_TIMEOUT,
                         "elastic.election_timeout"),
    "ckpt_dir": (env_util.HVD_TPU_CKPT_DIR, "checkpoint.dir"),
    "ckpt_interval": (env_util.HVD_TPU_CKPT_INTERVAL,
                      "checkpoint.interval"),
    "ckpt_keep": (env_util.HVD_TPU_CKPT_KEEP, "checkpoint.keep"),
    "zero_min_size": (env_util.HVD_TPU_ZERO_MIN_SIZE,
                      "sharding.zero_min_size"),
    "executor": (env_util.HVD_TPU_EXECUTOR, "sharding.executor"),
    "group_max": (env_util.HVD_TPU_GROUP_MAX, "groups.max"),
}

# negation flags -> env var forced to "0" (reference: --no-autotune etc.)
_NEGATIONS = {
    "no_autotune": env_util.HVD_AUTOTUNE,
    "no_hierarchical_allreduce": env_util.HVD_HIERARCHICAL_ALLREDUCE,
    "no_hierarchical_allgather": env_util.HVD_HIERARCHICAL_ALLGATHER,
    "stall_check": env_util.HVD_STALL_CHECK_DISABLE,  # enable = disable-var 0
    # drain defaults on; the negation is the interesting direction
    "no_drain": env_util.HVD_TPU_DRAIN,
    "no_straggler_exclude": env_util.HVD_TPU_STRAGGLER_EXCLUDE,
}


def _dig(tree, dotted):
    node = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def load_config_file(path):
    """Parse the YAML config file into a flat {arg_name: value} dict.

    Uses a minimal built-in YAML-subset parser (two-level ``key: value``
    maps) when PyYAML is unavailable, matching the reference's file schema.
    """
    try:
        import yaml
        with open(path) as f:
            try:
                tree = yaml.safe_load(f) or {}
            except yaml.YAMLError as exc:
                # surface the same typed error a hand-rolled-parser
                # failure would: the runner reports it and exits
                # instead of a raw ScannerError traceback
                raise ValueError(f"config file {path}: {exc}") from exc
    except ImportError:
        tree = _parse_simple_yaml(path)
    if not isinstance(tree, dict):
        # a YAML file whose top level is a list/scalar has no sections
        # to dig into — reject it by name rather than returning nothing
        raise ValueError(
            f"config file {path}: top level must be a mapping, got "
            f"{type(tree).__name__}")

    out = {}
    for arg, (_env, dotted) in _PARAMS.items():
        value = _dig(tree, dotted)
        if value is not None:
            out[arg] = value
    return out


def _parse_simple_yaml(path):
    """Two-level ``section:\\n  key: value`` parser for the config schema."""
    tree = {}
    section = None
    with open(path) as f:
        for raw in f:
            # strip comments only when the ' #' occurs OUTSIDE quotes
            # ('/tmp/run#3' and "a #3" keep their hashes)
            line = raw.rstrip("\n")
            if line.lstrip().startswith("#"):
                continue
            in_quote = None
            for i, ch in enumerate(line):
                if in_quote:
                    if ch == in_quote:
                        in_quote = None
                elif ch in "'\"":
                    in_quote = ch
                elif ch == "#" and i > 0 and line[i - 1] == " ":
                    line = line[:i]
                    break
            line = line.rstrip()
            if not line.strip():
                continue
            indented = line.startswith((" ", "\t"))
            key, _, value = line.strip().partition(":")
            value = value.strip()
            if not indented:
                section = key
                tree[section] = {}
            elif section is not None:
                tree[section][key] = _coerce(value)
    return tree


def _coerce(value: str):
    if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
        return value[1:-1]  # quoted string: verbatim (like PyYAML)
    low = value.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def apply_config_to_args(args, config: dict):
    """File values fill in args the CLI left at default (None).

    Identity comparison, not equality: an EXPLICIT ``--flag 0`` /
    ``0.0`` compares equal to False and would be silently overridden by
    the file, violating CLI-over-file precedence.  (Store-true flags
    use ``default=None`` in the parser, so ``False`` never appears as a
    default here; ``None`` is the only unset sentinel.)"""
    for key, value in config.items():
        if getattr(args, key, None) is None:
            setattr(args, key, value)


def env_from_args(args) -> dict:
    """Build the worker env contract from parsed args (reference:
    config_parser.set_env_from_args)."""
    env = {}

    def setenv(var, value):
        if value is None:
            return
        if isinstance(value, bool):
            if value:
                env[var] = "1"
        else:
            env[var] = str(value)

    for arg, (var, _path) in _PARAMS.items():
        value = getattr(args, arg, None)
        if arg == "fusion_threshold_mb" and value is not None:
            value = int(float(value) * 1024 * 1024)
        setenv(var, value)
    if getattr(args, "disable_cache", None):
        env[env_util.HVD_CACHE_CAPACITY] = "0"
    for arg, var in _NEGATIONS.items():
        if getattr(args, arg, None):
            env[var] = "0"
    return env
