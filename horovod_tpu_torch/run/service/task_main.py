"""The task server's process (port of
``horovod_tpu/run/service/task_main.py``; reference:
``horovod/run/task_fn.py``): one short-lived server a host while the
launcher discovers its NICs.  Started as

    python -m horovod_tpu_torch.run.service.task_main

with ``HVD_TASK_INDEX`` and ``HVD_DRIVER_ADDRS`` (``ip:port;ip:port``) in
its environment and the base64 job key as the first line of its stdin:
never on a command line or in an exported variable, where ``ps`` on any
host shows it (the key authenticates a service that runs commands)."""

import base64
import sys
import time

from horovod_tpu_torch.run.host_hash import host_hash
from horovod_tpu_torch.run.service.driver_service import DriverClient
from horovod_tpu_torch.run.service.task_service import TaskService
from horovod_tpu_torch.utils import env as env_util


def main():
    index = int(env_util.get_required(env_util.HVD_TASK_INDEX))
    key = base64.b64decode(sys.stdin.readline().strip())
    if not key:
        sys.stderr.write("task server: no secret on stdin\n")
        return 1
    driver_addrs = []
    for part in env_util.get_required(env_util.HVD_DRIVER_ADDRS) \
            .split(";"):
        ip, port = part.rsplit(":", 1)
        driver_addrs.append((ip, int(port)))
    timeout = env_util.get_float(env_util.HVD_TASK_TIMEOUT, 120.0)

    task = TaskService(index, key)
    try:
        client = DriverClient(driver_addrs, key)
        client.register_task(index, task.addresses(),
                             host_hash=host_hash())
        deadline = time.time() + timeout
        while not task.shutdown_requested.is_set():
            if time.time() > deadline:
                sys.stderr.write(
                    f"task server {index}: driver did not finish within "
                    f"{timeout}s\n")
                return 1
            time.sleep(0.1)
        return 0
    finally:
        task.shutdown()


if __name__ == "__main__":
    sys.exit(main())
