"""``hvdrun-torch``: the launcher CLI of the port (port of
``horovod_tpu/run/runner.py``).

Reference: ``horovod/run/runner.py``: every knob is a CLI flag mapped onto
the worker env contract; hosts come from ``-H`` or a hostfile; the config
file fills in whatever the CLI left unset.  Usage:

    python -m horovod_tpu_torch.run -np 4 python train.py
    hvdrun-torch -np 8 -H host1:4,host2:4 python train.py

The flags are the reference's, under its names, for the knobs the port
reads (``utils/env.py``).  Not ported: ``--tpu`` and ``--global-mesh``
(the JAX package's one-process-per-host device-rank mode; a torch process
drives one card), the race, protocol, fuzz and soak flags (the
``tools/`` analysers and the soak rig, which run on the JAX package);
by decision (ROADMAP A.13e), ``--controller``, ``--ring-segment-bytes``,
``--ring-stripes``, ``--tcp-ring-threshold`` and ``--schedule`` (the JAX
package's controllers and TCP data plane: NCCL carries every byte and
picks its own algorithm).
"""

import argparse
import os
import sys

from horovod_tpu_torch.run import allocate as allocate_mod
from horovod_tpu_torch.run import config_parser
from horovod_tpu_torch.run.http_server import RendezvousServer
from horovod_tpu_torch.run.launch import launch_job
from horovod_tpu_torch.utils import env as env_util

__version__ = "0.1.0"


def make_parser():
    parser = argparse.ArgumentParser(
        prog=os.path.basename(sys.argv[0]) or "hvdrun-torch",
        description="Launch a horovod_tpu_torch distributed job.")
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="Total number of training processes.")
    parser.add_argument("-H", "--hosts", default=None,
                        help="host:slots[,host:slots,...]; default "
                             "localhost with np slots.")
    parser.add_argument("--hostfile", default=None,
                        help="File with one 'hostname slots=N' per line.")
    parser.add_argument("--ssh-port", type=int, default=None)
    parser.add_argument("--mpi-args", default=None,
                        help="Extra arguments appended to the delegated "
                             "mpirun command (--launcher mpirun), e.g. "
                             "--mpi-args='--mca btl_tcp_if_include eth0'")
    parser.add_argument("--launcher", choices=["ssh", "mpirun", "jsrun"],
                        default="ssh",
                        help="Process placement: built-in ssh fan-out "
                             "(default), one mpirun invocation, or jsrun "
                             "on LSF (workers derive ranks from the MPI "
                             "runtime env).")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--version", action="store_true",
                        help="Print the framework version and exit.")
    parser.add_argument("--start-timeout", type=float, default=None,
                        help="Gang-start deadline in seconds: a rank that "
                             "cannot read rank 0's store address from "
                             "the rendezvous within this window fails "
                             "with a clear message (default 120).")
    parser.add_argument("--output-filename", default=None,
                        help="Directory for per-rank logs: each rank's "
                             "stdout/stderr are captured to "
                             "<dir>/rank.<NN>/stdout|stderr (rank "
                             "zero-padded to the width of np-1) while "
                             "still teeing to the console (reference: "
                             "horovodrun --output-filename).")
    parser.add_argument("--network-interface", default=None,
                        help="NIC whose address rank 0's store binds "
                             "(maps to HVD_IFACE; default: the host "
                             "name's address, or loopback for a local "
                             "job).")
    parser.add_argument("--config-file", default=None,
                        help="YAML config file (CLI flags take precedence).")

    group = parser.add_argument_group("tunable parameters")
    group.add_argument("--fusion-threshold-mb", type=float, default=None)
    group.add_argument("--cycle-time-ms", type=float, default=None)
    group.add_argument("--cache-capacity", type=int, default=None)
    group.add_argument("--disable-cache", action="store_true",
                       default=None,
                       help="Disable the response cache entirely "
                            "(HVD_CACHE_CAPACITY=0).")
    group.add_argument("--no-hierarchical-allreduce",
                       action="store_true", default=None,
                       help="Force flat allreduce, overriding "
                            "env/config.")
    group.add_argument("--no-hierarchical-allgather",
                       action="store_true", default=None,
                       help="Force flat allgather, overriding "
                            "env/config.")
    group.add_argument("--hierarchical-allreduce", action="store_true",
                       default=None,
                       help="The eager plane's allreduce as a "
                            "reduce-scatter within each fast group, an "
                            "allreduce across the groups and an "
                            "allgather back "
                            "(HVD_HIERARCHICAL_ALLREDUCE).")
    group.add_argument("--hierarchical-allgather", action="store_true",
                       default=None,
                       help="The eager plane's allgather within each "
                            "fast group, then across the groups "
                            "(HVD_HIERARCHICAL_ALLGATHER).")
    group.add_argument("--hier-local-size", type=int, default=None,
                       help="Ranks per fast group for the hierarchical "
                            "collectives and hierarchical Adasum "
                            "(HVD_HIER_LOCAL_SIZE; default: the "
                            "topology's local size).")
    group.add_argument("--adasum-hierarchical", action="store_true",
                       default=None,
                       help="Opt into the reference's NCCL+MPI-style "
                            "hierarchical Adasum (adasum of per-group "
                            "averages — numerically different from flat "
                            "Adasum)")
    group.add_argument("--compression",
                       choices=["none", "bf16", "fp16", "int8"],
                       default=None,
                       help="Default on-the-wire allreduce compression "
                            "(HVD_TPU_COMPRESSION); int8 is block-scaled "
                            "quantization.")

    auto = parser.add_argument_group("autotune")
    auto.add_argument("--autotune", action="store_true", default=None,
                      help="Tune the fusion threshold, the cycle time, "
                           "the hierarchical collectives, the response "
                           "cache and (with a compressor) compression "
                           "on/off on rank 0, and apply the values on "
                           "every rank in the same cycle "
                           "(HVD_AUTOTUNE).")
    auto.add_argument("--no-autotune", action="store_true", default=None,
                      help="Force autotune off, overriding env/config.")
    auto.add_argument("--autotune-log-file", default=None,
                      help="Rank 0's CSV of the walk, a row a sample "
                           "(HVD_AUTOTUNE_LOG).")
    auto.add_argument("--autotune-warmup-samples", type=int, default=None)
    auto.add_argument("--autotune-steady-state-samples", type=int,
                      default=None)
    auto.add_argument("--autotune-bayes-opt-max-samples", type=int,
                      default=None)
    auto.add_argument("--autotune-gaussian-process-noise", type=float,
                      default=None)

    timeline = parser.add_argument_group("timeline")
    timeline.add_argument("--timeline-filename", default=None,
                          help="Chrome-tracing file of the collectives "
                               "(HVD_TIMELINE): each rank writes "
                               "<file>.rank<r>, rank 0 merges them into "
                               "<file> at shutdown.")
    timeline.add_argument("--timeline-mark-cycles", action="store_true",
                          default=None,
                          help="Mark each cycle of the eager plane in "
                               "the timeline (HVD_TIMELINE_MARK_CYCLES).")

    shard = parser.add_argument_group("sharding")
    shard.add_argument("--zero-min-size", type=int, default=None,
                       help="Parameter-count threshold below which the "
                            "sharded update falls back to the replicated "
                            "path (HVD_TPU_ZERO_MIN_SIZE, default 1024).")
    shard.add_argument("--executor", choices=["psum", "mesh"], default=None,
                       help="The eager plane's executor "
                            "(HVD_TPU_EXECUTOR): 'psum' over the world; "
                            "'mesh' over a mesh's dp axis.")
    shard.add_argument("--group-max", type=int, default=None,
                       help="Cap on live process groups per job "
                            "(HVD_TPU_GROUP_MAX, default 64).")

    fault = parser.add_argument_group("fault tolerance")
    fault.add_argument("--abort-timeout", type=float, default=None,
                       help="Bound (seconds) on 'abort initiated -> "
                            "every rank raises HvdAbortedError' "
                            "(HVD_TPU_ABORT_TIMEOUT, default 30).")
    fault.add_argument("--heartbeat-interval", type=float, default=None,
                       help="Coordinator heartbeat period in seconds "
                            "(HVD_TPU_HEARTBEAT_INTERVAL, default 2).")
    fault.add_argument("--liveness-timeout", type=float, default=None,
                       help="Missed-heartbeat window in seconds before a "
                            "silent rank is declared dead and the job "
                            "is aborted (HVD_TPU_LIVENESS_TIMEOUT, "
                            "default 15; 0 disables).")
    fault.add_argument("--connect-retry-seconds", type=float,
                       default=None,
                       help="Deadline budget in seconds for "
                            "connection-establishment retries with "
                            "backoff + jitter "
                            "(HVD_TPU_CONNECT_RETRY_SECONDS, default "
                            "30).")
    fault.add_argument("--fault-spec", default=None,
                       help="Deterministic fault injection spec "
                            "(HVD_TPU_FAULT_SPEC), e.g. "
                            "'rank1:allreduce:2:crash'; see "
                            "common/faults.py for the grammar.  python "
                            "-m horovod_tpu_torch.run.chaos generates "
                            "seeded random specs.")
    fault.add_argument("--term-grace", type=float, default=None,
                       help="Grace window in seconds between the "
                            "SIGTERM the launcher forwards to a worker "
                            "process group and the SIGKILL escalation "
                            "(HVD_TPU_TERM_GRACE, default 5).")
    fault.add_argument("--drain", action="store_true", default=None,
                       help="Workers turn SIGTERM (the preemption "
                            "notice) into a graceful drain: announce "
                            "the departure to the coordinator, "
                            "reconfigure without the rank, exit 0 "
                            "(HVD_TPU_DRAIN, default on).")
    fault.add_argument("--no-drain", action="store_true", default=None,
                       help="Force the drain handler off: SIGTERM "
                            "keeps its default kill disposition.")
    fault.add_argument("--reconnect-budget", type=float, default=None,
                       help="Reconnect window in seconds: a mid-stream "
                            "break of a rank's coordinator link is "
                            "healed in place (reconnect + session "
                            "handshake + replay of unacked frames) for "
                            "up to this long before the break escalates "
                            "to the abort path "
                            "(HVD_TPU_RECONNECT_BUDGET, default 0 = "
                            "off).")
    fault.add_argument("--replay-buffer-bytes", type=int, default=None,
                       help="Bound on the client's replay buffer of "
                            "unacknowledged session frames "
                            "(HVD_TPU_REPLAY_BUFFER_BYTES, default "
                            "64 MiB); a heal needing an evicted frame "
                            "escalates instead of resuming with a "
                            "gap.")
    fault.add_argument("--rtt-alpha", type=float, default=None,
                       help="EWMA smoothing factor of the control-plane "
                            "round trips behind the adaptive liveness "
                            "deadlines (HVD_TPU_RTT_ALPHA, default "
                            "0.25).")
    fault.add_argument("--straggler-factor", type=float, default=None,
                       help="A rank is a straggler when its reported "
                            "RTT exceeds this multiple of the median "
                            "across reporting ranks "
                            "(HVD_TPU_STRAGGLER_FACTOR, default 4). "
                            "The same factor caps the extra deadline "
                            "slack a slow rank may earn.")
    fault.add_argument("--straggler-windows", type=int, default=None,
                       help="Consecutive liveness scans a rank must "
                            "exceed the straggler threshold before the "
                            "verdict is recorded "
                            "(HVD_TPU_STRAGGLER_WINDOWS, default 3).")
    fault.add_argument("--straggler-exclude", action="store_true",
                       default=None,
                       help="Under --elastic, propose a confirmed "
                            "straggler for a drain-style exclusion "
                            "(HVD_TPU_STRAGGLER_EXCLUDE, default off: "
                            "verdicts are only logged).")
    fault.add_argument("--no-straggler-exclude", action="store_true",
                       default=None,
                       help="Force straggler exclusion off (verdicts "
                            "are only logged).")

    elastic = parser.add_argument_group("elastic membership")
    elastic.add_argument("--elastic", action="store_true", default=None,
                         help="Survive rank loss: re-form the world "
                              "around the survivors at a new membership "
                              "epoch instead of ending the job "
                              "(HVD_TPU_ELASTIC).")
    elastic.add_argument("--min-ranks", type=int, default=None,
                         help="Smallest membership the job may shrink "
                              "to; below it a rank loss is fatal "
                              "(HVD_TPU_MIN_RANKS, default 1).")
    elastic.add_argument("--max-ranks", type=int, default=None,
                         help="Cap on the membership when admitting "
                              "late joiners (HVD_TPU_MAX_RANKS; 0 = "
                              "unlimited).")
    elastic.add_argument("--reconfig-timeout", type=float, default=None,
                         help="Deadline in seconds for the survivors to "
                              "re-form the world at the new epoch "
                              "(HVD_TPU_RECONFIG_TIMEOUT, default 60).")
    elastic.add_argument("--coord-failover", action="store_true",
                         default=None,
                         help="Survive the loss of rank 0, which hosts "
                              "the coordinator: the survivors race a "
                              "CAS election at the rendezvous and "
                              "re-form under a new coordinator "
                              "(HVD_TPU_COORD_FAILOVER; needs "
                              "--elastic).")
    elastic.add_argument("--election-timeout", type=float, default=None,
                         help="Budget in seconds for one fail-over "
                              "election: the CAS race and adopting its "
                              "winner (HVD_TPU_ELECTION_TIMEOUT, "
                              "default 10).")

    ckpt = parser.add_argument_group("checkpointing")
    ckpt.add_argument("--ckpt-dir", default=None,
                      help="Durable checkpoint directory "
                           "(HVD_TPU_CKPT_DIR): elastic.run writes each "
                           "rank's shard there from the commit snapshot "
                           "on a background thread and resumes from the "
                           "newest complete manifest.  Unset: "
                           "checkpointing off.")
    ckpt.add_argument("--ckpt-interval", type=int, default=None,
                      help="Checkpoint every N committed steps "
                           "(HVD_TPU_CKPT_INTERVAL, default 10).")
    ckpt.add_argument("--ckpt-keep", type=int, default=None,
                      help="Retain the newest N checkpoints "
                           "(HVD_TPU_CKPT_KEEP, default 2; 0 keeps "
                           "everything).")

    stall = parser.add_argument_group("stall check")
    stall.add_argument("--no-stall-check", action="store_true", default=None)
    stall.add_argument("--stall-check", action="store_true", default=None,
                       help="Force the stall check on, overriding "
                            "env/config.")
    stall.add_argument("--stall-check-warning-time-seconds", type=float,
                       default=None)
    stall.add_argument("--stall-check-shutdown-time-seconds", type=float,
                       default=None,
                       help="Seconds after which a stalled tensor turns "
                            "into a coordinated abort naming the first "
                            "lagging rank (HVD_STALL_SHUTDOWN_TIME_"
                            "SECONDS; 0, the default, only warns).")

    logg = parser.add_argument_group("logging")
    logg.add_argument("--log-level", default=None,
                      choices=["trace", "debug", "info", "warning", "error",
                               "fatal"])
    logg.add_argument("--log-hide-timestamp", action="store_true",
                      default=None)

    parser.add_argument("-cb", "--check-build", action="store_true",
                        help="Print what the port depends on (torch and "
                             "its CUDA, the card, nvcc, triton, the "
                             "kernel library, NCCL and gloo), then exit "
                             "(reference: horovodrun --check-build).")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Training command to run on each rank.")
    return parser


def check_build(verbose=False):
    """The reference's ``horovodrun --check-build`` diagnostic
    (``runner.py:118``) for what this port depends on."""
    import importlib.util
    import textwrap

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops.cuda import _build

    def have(mod):
        try:
            return importlib.util.find_spec(mod) is not None
        except (ImportError, ValueError):
            return False

    def nvcc():
        try:
            return _build._nvcc()
        except RuntimeError:
            return None

    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else None)
    x = lambda v: "X" if v else " "  # noqa: E731
    out = f"""\
    horovod_tpu_torch v{__version__}:

    Framework:
        [X] PyTorch {torch.__version__} (CUDA {torch.version.cuda})

    Card:
        [{x(card)}] {card or 'no CUDA device visible'}

    Kernels (sm_90a):
        [{x(nvcc())}] nvcc {nvcc() or '(not found; set CUDA_HOME)'}
        [{x(_build.target().exists())}] kernel library built ({_build.target().name})
        [{x(have('triton'))}] triton

    Collectives (torch.distributed):
        [{x(dist.is_available() and dist.is_nccl_available())}] NCCL
        [{x(dist.is_available() and dist.is_gloo_available())}] gloo
    """
    print(textwrap.dedent(out))
    if verbose:
        import horovod_tpu_torch

        print(f"package: {os.path.dirname(horovod_tpu_torch.__file__)}")
        print(f"kernel library: {_build.target()}")
    return 0


def build_slots(args):
    if args.hostfile:
        hosts = allocate_mod.parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = allocate_mod.parse_hosts(args.hosts)
    else:
        from horovod_tpu_torch.run import lsf
        spec = lsf.host_spec() if lsf.using_lsf() else None
        if spec:
            # inside an LSF job the allocation is the host list
            # (reference: runner.py LSF auto-discovery via util/lsf.py)
            hosts = allocate_mod.parse_hosts(spec)
            if args.num_proc is None:
                args.num_proc = lsf.get_num_processes()
        else:
            hosts = [allocate_mod.HostInfo("localhost", args.num_proc)]
    return allocate_mod.allocate(hosts, args.num_proc)


def run_commandline(argv=None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)

    if args.version:
        print(__version__)
        return 0
    if args.check_build:
        return check_build(verbose=args.verbose)
    if not args.command:
        parser.error("no training command given")
    if args.num_proc is None:
        from horovod_tpu_torch.run import lsf
        if lsf.using_lsf():
            args.num_proc = lsf.get_num_processes()
        if args.num_proc is None:
            parser.error("-np is required (or run inside an LSF "
                         "allocation)")

    if args.config_file:
        config_parser.apply_config_to_args(
            args, config_parser.load_config_file(args.config_file))

    extra_env = config_parser.env_from_args(args)
    if env_util.HVD_TPU_TERM_GRACE in extra_env:
        # the grace window is read by THIS process (the launcher's
        # SIGTERM forwarding, run/launch.py), not by the workers:
        # flag/YAML values must land in the launcher's own environment
        os.environ[env_util.HVD_TPU_TERM_GRACE] = \
            extra_env[env_util.HVD_TPU_TERM_GRACE]
    slots = build_slots(args)
    if len(slots) > 1 and env_util.HVD_CONTROLLER not in extra_env:
        # the reference's process-mode controller; the port has one
        # (the eager plane) and ignores the value
        extra_env[env_util.HVD_CONTROLLER] = "tcp"
    if env_util.HVD_SECRET_KEY not in extra_env:
        import base64

        from horovod_tpu_torch.run.service import secret
        extra_env[env_util.HVD_SECRET_KEY] = base64.b64encode(
            secret.make_secret_key()).decode()

    if args.launcher != "ssh":
        return _delegate_launch(args, slots, extra_env)

    # fail fast with the full unreachable-host list before launching
    # anything (reference: runner.py:568-643 parallel cached ssh check)
    remote_hosts = sorted({s.hostname for s in slots})
    from horovod_tpu_torch.run.ssh_check import \
        check_all_hosts_ssh_successful
    check_all_hosts_ssh_successful(remote_hosts, ssh_port=args.ssh_port)

    rendezvous = RendezvousServer()
    port = rendezvous.start()
    addr = env_util.get_str(env_util.HVD_RENDEZVOUS_HOST_ADDR)
    if addr is None:
        # across hosts, the NIC every host reaches (run/driver_discovery);
        # on one host, or when discovery fails, the host name's address
        from horovod_tpu_torch.run.driver_discovery import maybe_discover
        discovered = maybe_discover(slots, ssh_port=args.ssh_port)
        if discovered is not None:
            ifaces, addr = discovered
            extra_env.setdefault(env_util.HVD_IFACE, sorted(ifaces)[0])
        else:
            addr = _routable_addr(slots)
    # Quote each token so arguments with spaces/quotes survive the shell
    # (reference: runner.py quotes the unknown args the same way).
    import shlex
    command = " ".join(shlex.quote(c) for c in args.command)
    try:
        code = launch_job(slots, command, addr, port, extra_env=extra_env,
                          ssh_port=args.ssh_port, verbose=args.verbose,
                          output_filename=args.output_filename,
                          elastic=bool(args.elastic),
                          min_ranks=args.min_ranks or 1,
                          coord_failover=bool(args.coord_failover))
    finally:
        rendezvous.stop()
    # a signal death surfaces as Popen's negative code; exit statuses
    # are unsigned, so report it in the shell's 128+signum convention
    return 128 - code if code < 0 else code


def _delegate_launch(args, slots, extra_env):
    """mpirun / jsrun placement: start the rendezvous here, export the
    constant env contract (per-rank values come from the MPI runtime,
    ``common/topology._mpi_placed``), run ONE placement command."""
    rendezvous = RendezvousServer()
    port = rendezvous.start()
    addr = env_util.get_str(env_util.HVD_RENDEZVOUS_HOST_ADDR) \
        or _routable_addr(slots)
    env = dict(os.environ)
    env.update(extra_env)
    env[env_util.HVD_SIZE] = str(len(slots))
    env[env_util.HVD_RENDEZVOUS_ADDR] = addr
    env[env_util.HVD_RENDEZVOUS_PORT] = str(port)
    hosts_spec = ",".join(
        f"{h}:{n}" for h, n in
        _slots_by_host(slots).items())
    try:
        if args.launcher == "mpirun":
            import shlex

            from horovod_tpu_torch.run import mpi_run
            extra = shlex.split(args.mpi_args) if args.mpi_args else None
            return mpi_run.mpi_run(len(slots), hosts_spec, args.command,
                                   env=env, extra_args=extra)
        from horovod_tpu_torch.run import js_run
        return js_run.js_run(len(slots), args.command, env=env)
    finally:
        rendezvous.stop()


def _slots_by_host(slots):
    out = {}
    for s in slots:
        out[s.hostname] = out.get(s.hostname, 0) + 1
    return out


def _routable_addr(slots):
    """The address remote workers use to reach the rendezvous server
    (the reference's driver NIC discovery, simplified: host name
    resolution; for all-local jobs, loopback)."""
    import socket

    if all(s.hostname in ("localhost", "127.0.0.1") for s in slots):
        return "127.0.0.1"
    return socket.gethostbyname(socket.gethostname())


def main():
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
