"""mpirun delegation for ``hvdrun-torch`` (port of
``horovod_tpu/run/mpi_run.py``; reference: ``horovod/run/mpi_run.py``):
builds a single mpirun invocation carrying the rank env contract so
sites whose job launcher is MPI can use it for process placement.

The data plane stays the port's own (NCCL and gloo through
``torch.distributed``); mpirun only *places processes* and propagates
environment.  Workers read ``OMPI_COMM_WORLD_RANK`` / ``PMI_RANK`` when
the launcher's env contract is absent (``common/topology.py``).
"""

import os
import shutil
import subprocess

from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils.logging import get_logger

OPENMPI = "OpenMPI"
SPECTRUM = "SpectrumMPI"
MPICH = "MPICH"
UNKNOWN = "Unknown"
MISSING = "Missing"

# beyond this many hosts, OpenMPI's tree spawn needs tuning off
# (reference behavior for >64-host clusters)
LARGE_CLUSTER_THRESHOLD = 64

# env prefixes the workers need replicated on every host (the
# reference's, with the torch, CUDA and NCCL variables in place of its
# JAX, XLA and TPU ones)
_PASS_PREFIXES = ("HVD_", "TORCH_", "CUDA_", "NCCL_", "PYTHON", "PATH",
                  "LD_LIBRARY_PATH", "HOROVOD_")


def detect_impl(runner=subprocess.run):
    """Identify the MPI implementation from ``mpirun --version``."""
    if shutil.which("mpirun") is None:
        return MISSING
    try:
        proc = runner(["mpirun", "--version"], capture_output=True,
                      text=True, timeout=20)
    except Exception:  # noqa: BLE001 — any probe failure means unusable
        return MISSING
    text = (proc.stdout or "") + (proc.stderr or "")
    if "Open MPI" in text or "OpenRTE" in text:
        return OPENMPI
    if "IBM Spectrum MPI" in text:
        return SPECTRUM
    if "MPICH" in text or "HYDRA" in text:
        return MPICH
    return UNKNOWN


def mpi_available(runner=subprocess.run):
    return detect_impl(runner) not in (UNKNOWN, MISSING)


def _env_args(env):
    args = []
    for key in sorted(env):
        if key.startswith(_PASS_PREFIXES):
            args += ["-x", key]
    return args


def build_mpirun_command(num_proc, hosts, command, env=None, impl=None,
                         extra_args=None):
    """argv for one mpirun invocation placing ``num_proc`` processes.

    ``hosts``: "host1:slots,host2:slots" (same syntax as
    ``hvdrun-torch -H``).
    The command is returned, not executed, so unit tests assert on it
    (reference test style: ``test_run.py`` string-level launcher tests).
    """
    env = env if env is not None else os.environ
    impl = impl or detect_impl()
    if impl in (UNKNOWN, MISSING):
        raise RuntimeError(
            "no usable MPI found (mpirun missing or unrecognized); "
            "use plain `hvdrun-torch` (ssh fan-out) instead")

    if impl == MPICH:
        # Hydra syntax: no --allow-run-as-root / -x / host:slots
        argv = ["mpirun", "-np", str(num_proc)]
        if hosts:
            argv += ["-hosts",
                     ",".join(h.split(":")[0] for h in hosts.split(","))]
        passed = [k for k in sorted(env) if k.startswith(_PASS_PREFIXES)]
        if passed:
            argv += ["-envlist", ",".join(passed)]
        argv += list(extra_args or [])
        argv += list(command)
        return argv

    argv = ["mpirun", "--allow-run-as-root", "-np", str(num_proc)]
    if hosts:
        argv += ["-H", hosts]
    if impl == OPENMPI:
        argv += ["--bind-to", "none", "--map-by", "slot"]
        n_hosts = len(hosts.split(",")) if hosts else 1
        if n_hosts >= LARGE_CLUSTER_THRESHOLD:
            argv += ["--mca", "plm_rsh_no_tree_spawn", "true",
                     "--mca", "plm_rsh_num_concurrent", str(n_hosts)]
    elif impl == SPECTRUM:
        argv += ["-tcp"]
    argv += _env_args(env)
    argv += list(extra_args or [])
    argv += list(command)
    return argv


def mpi_run(num_proc, hosts, command, env=None, extra_args=None):
    """Exec the mpirun command (blocking); returns the exit code."""
    impl = detect_impl()
    run_env = dict(env or os.environ)
    # Export the exact rank-block layout so workers derive
    # cross_rank/cross_size correctly under unequal slots per host
    # (topology._from_host_slots) — but ONLY where the command line
    # enforces that layout: OpenMPI/Spectrum honor `-H host:slots
    # --map-by slot` (block fill).  Hydra (MPICH) gets bare hostnames
    # and places by core count, so asserting a layout there would
    # override the runtime's CORRECT per-rank variables with a lie.
    # Must be in the env BEFORE argv is built: the `-x`/`-envlist`
    # forwarding flags are emitted from the keys present at build time,
    # and remote-host ranks only receive forwarded variables.
    if hosts and impl in (OPENMPI, SPECTRUM):
        run_env[env_util.HVD_HOST_SLOTS] = hosts
    argv = build_mpirun_command(num_proc, hosts, command, env=run_env,
                                impl=impl, extra_args=extra_args)
    get_logger().info("mpirun delegation: %s", " ".join(argv))
    return subprocess.call(argv, env=run_env)
