"""Parallel ssh reachability pre-check (port of
``horovod_tpu/run/ssh_check.py``; reference:
``horovod/run/runner.py:568-643`` — probe every remote host with a
trivial ssh command on threads, memoized on disk, and fail fast with the
full list of unreachable hosts before any worker is launched)."""

import subprocess
import threading

from horovod_tpu_torch.run.cache import Cache
from horovod_tpu_torch.run.launch import LOCAL_HOSTS  # shared local-host list
from horovod_tpu_torch.utils.logging import get_logger

SSH_TIMEOUT_S = 15


def _probe(hostname, ssh_port=None, runner=subprocess.run):
    port = ["-p", str(ssh_port)] if ssh_port else []
    cmd = ["ssh", "-o", "BatchMode=yes",
           "-o", "StrictHostKeyChecking=no",
           "-o", f"ConnectTimeout={SSH_TIMEOUT_S}",
           *port, hostname, "true"]
    try:
        return runner(cmd, capture_output=True,
                      timeout=SSH_TIMEOUT_S + 5).returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def check_all_hosts_ssh_successful(hostnames, ssh_port=None, cache=None,
                                   runner=subprocess.run):
    """Probe every remote host in parallel; raise with the complete
    unreachable list (not just the first failure).  Results are memoized
    (60 min) so back-to-back launches skip the probes.  A job on local
    hosts alone probes nothing and opens no cache."""
    remote = [h for h in dict.fromkeys(hostnames)
              if h not in LOCAL_HOSTS]
    if not remote:
        return True
    if cache is None:
        cache = Cache(parameters_hash=f"ssh_port={ssh_port}")

    results = {}
    lock = threading.Lock()

    def probe(host):
        key = f"ssh:{host}"
        ok = cache.get(key)
        if ok is None:
            ok = _probe(host, ssh_port=ssh_port, runner=runner)
            if ok:  # only cache successes; failures should re-probe
                cache.put(key, True)
        with lock:
            results[host] = bool(ok)

    threads = [threading.Thread(target=probe, args=(h,), daemon=True)
               for h in remote]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SSH_TIMEOUT_S + 10)

    unreachable = sorted(h for h in remote if not results.get(h))
    if unreachable:
        raise RuntimeError(
            "SSH was unable to reach the following hosts: "
            f"{unreachable}. Verify passwordless ssh (BatchMode) works "
            "to every host in the job.")
    get_logger().debug("ssh reachability verified for %d host(s)",
                       len(remote))
    return True
