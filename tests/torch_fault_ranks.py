"""Rank processes for the control plane's end-to-end tests
(``tests/test_torch_fault_*.py``): ``spawn`` starts ``n`` workers of the
port on gloo under the launcher's env contract (the port's rendezvous KV
server, a job key of its own) WITHOUT the launcher's kill-on-first-failure
fan-out, so that survivors keep running after a sibling dies and show the
coordinated abort; each worker and the whole spawn have a time limit.

``MATRIX_WORKER`` runs one collective and prints, on a coordinated abort,
the origin rank, the seconds from its submit (from the start of its
``hvd.init()`` when the abort comes out of it) to the error and whether
every handle it holds settled (``_assert_aborted`` reads that line, as
``tests/test_fault_injection.py`` reads the JAX worker's)."""

import base64
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX tests' windows (tests/test_fault_injection.py::_FT_ENV): tight
# failure detection, an abort deadline well above it
FT_ENV = {
    "HVD_TPU_HEARTBEAT_INTERVAL": "0.25",
    "HVD_TPU_ABORT_TIMEOUT": "10",
    "HVD_STALL_CHECK_TIME_SECONDS": "1",
    "OMP_NUM_THREADS": "1",
}

MATRIX_WORKER = r"""
import os, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics

r = int(os.environ["HVD_RANK"])
op = os.environ["FT_OP"]
start = time.monotonic()
handle = None
try:
    # rank 0's process, which hosts the coordinator, can die as soon as
    # its own init returns: a peer's abort then comes out of its init
    hvd.init(device="cpu")
    t = torch.ones(int(os.environ.get("FT_SIZE", "8"))) * (r + 1)
    start = time.monotonic()
    if op == "allreduce":
        handle = hvd.allreduce_async(t, op=hvd.Sum, name="ft.tensor")
    elif op == "broadcast":
        handle = hvd.broadcast_async(t, root_rank=0, name="ft.tensor")
    else:
        handle = hvd.allgather_async(t, name="ft.tensor")
    out = hvd.synchronize(handle)
    print(f"rank {r} COMPLETED sum={float(out.sum())}", flush=True)
except hvd.HvdAbortedError as exc:
    elapsed = time.monotonic() - start
    controller = basics._get_state().controller
    settled = int(controller._in_flight == 0 and not controller._queue
                  and not controller._held)
    print(f"rank {r} ABORTED origin={exc.origin_rank} "
          f"elapsed={elapsed:.1f} settled={settled}", flush=True)
hvd.shutdown()
print(f"rank {r} DONE", flush=True)
"""


def spawn(n, script, extra_env=None, timeout=60, world_size=None):
    """Start ``n`` ranks of ``script``; -> [(returncode, stdout, stderr)]
    per rank.  ``world_size`` (default ``n``) is the ``HVD_SIZE`` every
    process is given: the processes past it are late joiners.  Every
    child is reaped on any exit path."""
    sys.path.insert(0, REPO)
    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.run.service import secret

    server = RendezvousServer()
    port = server.start()
    key = base64.b64encode(secret.make_secret_key()).decode()
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH",
                                                            "")
            for name in list(env):
                if name.startswith("HVD_"):
                    del env[name]
            env.update({
                "HVD_RANK": str(r), "HVD_SIZE": str(world_size or n),
                "HVD_LOCAL_RANK": str(r), "HVD_LOCAL_SIZE": str(n),
                "HVD_CROSS_RANK": "0", "HVD_CROSS_SIZE": "1",
                "HVD_RENDEZVOUS_ADDR": "127.0.0.1",
                "HVD_RENDEZVOUS_PORT": str(port), "HVD_SECRET_KEY": key,
            })
            env.update(extra_env or {})
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout
        results = []
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            results.append((p.returncode, out, err))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=15)
        server.stop()


def assert_aborted(out, rank, origin, deadline=10.0):
    """Rank ``rank`` raised ``HvdAbortedError`` naming ``origin`` (one
    rank or a tuple), within ``deadline`` seconds, every handle
    settled."""
    line = next((l for l in out.splitlines()
                 if l.startswith(f"rank {rank} ABORTED")), None)
    assert line is not None, out
    fields = dict(kv.split("=") for kv in line.split()[3:])
    allowed = origin if isinstance(origin, tuple) else (origin,)
    assert fields["origin"] in {str(o) for o in allowed}, line
    assert float(fields["elapsed"]) < deadline, line
    assert fields["settled"] == "1", line
