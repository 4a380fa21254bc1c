"""jsrun delegation (port of ``horovod_tpu/run/js_run.py``; reference: ``horovod/run/js_run.py`` — on LSF
systems with IBM Job Step Manager, one jsrun invocation places the
workers; an explicit rank file pins ranks to hosts)."""

import os
import shutil
import subprocess
import tempfile

from horovod_tpu_torch.run import lsf
from horovod_tpu_torch.utils.logging import get_logger


def js_available() -> bool:
    return lsf.using_lsf() and shutil.which("jsrun") is not None


def generate_rankfile(slots_per_host, path=None):
    """Explicit resource file: one rank per line, cyclic by host
    (jsrun ERF syntax: ``rank: N: { host: H }``)."""
    if path is None:
        fd, path = tempfile.mkstemp(prefix="hvd_jsrun_", suffix=".erf")
        os.close(fd)
    lines = ["overlapping_rs: allow", "cpu_index_using: logical", ""]
    rank = 0
    for host, slots in slots_per_host.items():
        for _ in range(slots):
            lines.append(f"rank: {rank}: {{ hostname: {host}; cpu: * }}")
            rank += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def build_jsrun_command(num_proc, command, rankfile=None,
                        extra_args=None):
    argv = ["jsrun"]
    if rankfile:
        argv += ["--erf_input", rankfile]
    else:
        argv += ["--nrs", str(num_proc), "--tasks_per_rs", "1",
                 "--cpu_per_rs", "ALL_CPUS"]
    argv += ["--stdio_stderr", "prepended", "--stdio_stdout", "prepended"]
    argv += list(extra_args or [])
    argv += list(command)
    return argv


def _trim_allocation(slots_per_host, num_proc):
    """First ``num_proc`` slots of the allocation, host-major — the
    rankfile must describe exactly the requested world size or the
    MPI-derived size on the workers disagrees with the driver's
    contract."""
    out = {}
    remaining = num_proc
    for host, slots in slots_per_host.items():
        if remaining <= 0:
            break
        take = min(slots, remaining)
        out[host] = take
        remaining -= take
    if remaining > 0:
        raise RuntimeError(
            f"LSF allocation has only {num_proc - remaining} slots; "
            f"{num_proc} requested")
    return out


def js_run(num_proc, command, env=None, extra_args=None):
    """Place workers with jsrun using a rank file derived from the LSF
    allocation (trimmed to ``num_proc`` ranks); returns the exit code."""
    if not js_available():
        raise RuntimeError(
            "jsrun delegation requires an LSF job (LSB_JOBID) with "
            "jsrun on PATH")
    trimmed = _trim_allocation(lsf.get_slots_per_host(), num_proc)
    rankfile = generate_rankfile(trimmed)
    argv = build_jsrun_command(num_proc, command, rankfile=rankfile,
                               extra_args=extra_args)
    get_logger().info("jsrun delegation: %s", " ".join(argv))
    run_env = dict(env or os.environ)
    # the rankfile is the authoritative rank-block layout (the trimmed
    # last host may carry fewer ranks); export it so every worker
    # derives the same cross_rank/cross_size (topology._from_host_slots)
    from horovod_tpu_torch.utils import env as env_util
    run_env[env_util.HVD_HOST_SLOTS] = ",".join(
        f"{h}:{n}" for h, n in trimmed.items())
    try:
        return subprocess.call(argv, env=run_env)
    finally:
        try:
            os.unlink(rankfile)
        except OSError:
            pass
