"""Worker-side entry for the programmatic ``run(fn)`` API (port of
``horovod_tpu/run/task_runner.py``; reference: ``horovod/run/run_task.py``
/ task exec fns): fetch the pickled function from the rendezvous KV,
check its digest with the job key, execute it, post the signed result."""

import base64
import os
import pickle
import sys
import threading
import time
import traceback

from horovod_tpu_torch.run import http_client
from horovod_tpu_torch.run.api import FN_SCOPE, RESULT_SCOPE
from horovod_tpu_torch.run.service import secret as secret_mod
from horovod_tpu_torch.utils import env as env_util

# a worker whose driver has been unreachable this long is orphaned
# (driver crashed / Ctrl-C killed it without the remote kill reaching
# us) and must exit rather than hold cards and ports forever
_DRIVER_LOST_AFTER_S = 60.0


def _driver_watchdog(addr, port):
    lost_since = None
    while True:
        time.sleep(10.0)
        try:
            # retry_for=0: the watchdog IS the retry loop — the verb's
            # built-in transport retry would stretch the driver-lost
            # window far past _DRIVER_LOST_AFTER_S
            http_client.get(addr, port, "ping", "ping", timeout=None,
                            retry_for=0)
            lost_since = None
        except KeyError:
            lost_since = None  # server answered (404): driver alive
        except Exception:  # noqa: BLE001 — unreachable
            now = time.monotonic()
            if lost_since is None:
                lost_since = now
            elif now - lost_since > _DRIVER_LOST_AFTER_S:
                sys.stderr.write(
                    "driver rendezvous unreachable for "
                    f"{int(now - lost_since)}s; exiting orphaned "
                    "worker\n")
                os._exit(1)


def main():
    addr = env_util.get_required(env_util.HVD_RENDEZVOUS_ADDR)
    port = int(env_util.get_required(env_util.HVD_RENDEZVOUS_PORT))
    rank = int(env_util.get_required(env_util.HVD_RANK))
    key = base64.b64decode(
        env_util.get_required(env_util.HVD_SECRET_KEY))

    # lifecycle: deliberately abandoned — the watchdog polls the driver
    # for the life of the worker process and os._exit()s it if the
    # driver disappears; process exit is its only end
    threading.Thread(target=_driver_watchdog, args=(addr, port),
                     daemon=True, name="hvd-driver-watchdog").start()

    try:
        blob = http_client.get(addr, port, FN_SCOPE, "fn", timeout=60)
        digest, payload = (blob[:secret_mod.DIGEST_LEN],
                           blob[secret_mod.DIGEST_LEN:])
        if not secret_mod.check(key, payload, digest):
            raise PermissionError(
                "run-function payload failed HMAC verification")
        fn, args, kwargs = pickle.loads(payload)
        result = ("ok", fn(*args, **kwargs))
    except BaseException:  # noqa: BLE001 — reported to the driver
        result = ("error", traceback.format_exc())
    payload = pickle.dumps(result)
    http_client.put(addr, port, RESULT_SCOPE, str(rank),
                    secret_mod.sign(key, payload) + payload)
    if result[0] == "error":
        sys.stderr.write(result[1])
        sys.exit(1)


if __name__ == "__main__":
    main()
