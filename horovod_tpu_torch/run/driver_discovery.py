"""The launcher's NIC discovery (port of
``horovod_tpu/run/driver_discovery.py``; reference:
``horovod/run/driver/driver_service.py:225 get_common_interfaces``, used
by ``runner.py:568-643``): a task server on every host, each probing its
successor, and the intersection of the interface names routable between
every pair.  The first such interface gives the rendezvous its address
and the workers their ``HVD_IFACE``, which rank 0's store binds
(``common/basics.py::_my_address``)."""

import base64
import os
import shlex
import subprocess
import sys

from horovod_tpu_torch.run.service import secret
from horovod_tpu_torch.run.service.driver_service import (
    DriverService, find_common_interfaces)
from horovod_tpu_torch.run.service.network import local_interfaces
from horovod_tpu_torch.run.service.task_service import TaskClient
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils.logging import get_logger

LOCAL_HOSTS = ("localhost", "127.0.0.1")


def _task_server_command(index, driver_addrs, ssh_port=None, host=None):
    """The task server's command line.  The key is not on it (``ps``
    shows a command line on every host): ``task_main`` reads it from its
    stdin, which ssh forwards."""
    env = {
        env_util.HVD_TASK_INDEX: str(index),
        env_util.HVD_DRIVER_ADDRS: ";".join(f"{ip}:{port}"
                                     for ip, port in driver_addrs),
    }
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
    inner = (f"cd {shlex.quote(os.getcwd())} && {exports} "
             f"{shlex.quote(sys.executable)} -m "
             "horovod_tpu_torch.run.service.task_main")
    if host is None or host in LOCAL_HOSTS:
        return inner
    port = f"-p {ssh_port} " if ssh_port else ""
    return (f"ssh -o StrictHostKeyChecking=no {port}{host} "
            f"{shlex.quote(inner)}")


def discover_common_interfaces(hostnames, ssh_port=None, timeout=60):
    """One discovery round over ``hostnames``; -> ``(iface_names,
    rendezvous_ip)``.  Raises on failure (the caller falls back to the
    host name's address)."""
    key = secret.make_secret_key()
    driver = DriverService(len(hostnames), key)
    procs = []
    try:
        driver_addrs = [(ip, driver.port)
                        for ip in local_interfaces().values()]
        key_line = base64.b64encode(key) + b"\n"
        for i, host in enumerate(hostnames):
            cmd = _task_server_command(i, driver_addrs,
                                       ssh_port=ssh_port, host=host)
            proc = subprocess.Popen(cmd, shell=True,
                                    stdin=subprocess.PIPE)
            try:
                proc.stdin.write(key_line)
                proc.stdin.close()
            except BrokenPipeError:
                pass
            procs.append(proc)

        common = find_common_interfaces(driver, key, len(hostnames),
                                        timeout=timeout)
        iface = sorted(common)[0]
        ip = local_interfaces().get(iface)
        if ip is None:  # the driver's host names its NICs otherwise
            ip = next(iter(local_interfaces().values()))

        # release the task servers
        for i in range(len(hostnames)):
            try:
                TaskClient(driver.task_addresses(i), key,
                           timeout=5).shutdown_task()
            except (OSError, ConnectionError):
                pass
        return common, ip
    finally:
        driver.shutdown()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def maybe_discover(slots, ssh_port=None):
    """Discovery for a job across hosts; ``None`` for a job on this host
    only, or when discovery fails (the caller falls back)."""
    hostnames = []
    for s in slots:
        if s.hostname not in hostnames:
            hostnames.append(s.hostname)
    if all(h in LOCAL_HOSTS for h in hostnames):
        return None
    try:
        return discover_common_interfaces(hostnames, ssh_port=ssh_port)
    except Exception as exc:  # noqa: BLE001 — discovery is best-effort
        get_logger().warning(
            "NIC discovery failed (%s); falling back to hostname "
            "resolution for the rendezvous address", exc)
        return None
