"""Programmatic ``run(fn)`` API (port of ``horovod_tpu/run/api.py``).

Reference: ``horovod/run/runner.py:648-669,742``: ship a pickled function
to every rank through the rendezvous KV store, execute it under the full
env contract, and collect per-rank return values.  Both directions are
HMAC-signed with the job key: the worker checks the function's digest
before it unpickles it (``run/task_runner.py``), and this side checks
each result's before it unpickles that.
"""

import base64
import pickle
import shlex
import sys

from horovod_tpu_torch.run import allocate as allocate_mod
from horovod_tpu_torch.run.http_server import RendezvousServer
from horovod_tpu_torch.run.launch import launch_job
from horovod_tpu_torch.run.service import secret as secret_mod
from horovod_tpu_torch.utils import env as env_util

try:
    import cloudpickle as _pickler
except ImportError:  # plain pickle handles module-level functions,
    _pickler = pickle  # which covers the API's use


FN_SCOPE = "runfunc"
RESULT_SCOPE = "results"


def run(fn, args=(), kwargs=None, np=1, hosts=None, extra_env=None,
        verbose=False, elastic=False, min_ranks=1):
    """Run ``fn(*args, **kwargs)`` on ``np`` ranks; returns the list of
    per-rank return values (rank order).  ``fn`` calls ``hvd.init()``
    itself; the ranks find each other through this call's rendezvous.
    A rank whose function raised fails the call with its traceback; a
    result whose digest does not verify raises ``PermissionError``.
    ``elastic`` sets ``HVD_TPU_ELASTIC`` in the workers and supervises
    the survivors of a lost rank (``launch_job``)."""
    kwargs = kwargs or {}

    if hosts:
        host_list = allocate_mod.parse_hosts(hosts)
    else:
        host_list = [allocate_mod.HostInfo("localhost", np)]
    slots = allocate_mod.allocate(host_list, np)

    rendezvous = RendezvousServer()
    port = rendezvous.start()
    try:
        # the KV store is an unauthenticated HTTP server bound on
        # 0.0.0.0; the pickled-fn and pickled-result channels through it
        # are HMAC-signed with the job secret so a network peer cannot
        # inject pickles into the workers or the driver
        supplied = (extra_env or {}).get(env_util.HVD_SECRET_KEY) \
            or env_util.get_str(env_util.HVD_SECRET_KEY)
        key = base64.b64decode(supplied) if supplied \
            else secret_mod.make_secret_key()

        payload = _pickler.dumps((fn, args, kwargs))
        signed = secret_mod.sign(key, payload) + payload
        with rendezvous._server.kv_lock:
            rendezvous._server.kv.setdefault(FN_SCOPE, {})["fn"] = signed

        env = dict(extra_env or {})
        # force-set: workers must hold the SAME key the driver signs with
        env[env_util.HVD_SECRET_KEY] = base64.b64encode(key).decode()
        if np > 1:
            env.setdefault(env_util.HVD_CONTROLLER, "tcp")

        # remote workers must reach the driver's KV store; honor the
        # same override the CLI path uses
        addr = env_util.get_str(env_util.HVD_RENDEZVOUS_HOST_ADDR)
        if addr is None:
            from horovod_tpu_torch.run.runner import _routable_addr

            addr = _routable_addr(slots)

        if elastic:
            env.setdefault(env_util.HVD_TPU_ELASTIC, "1")
        command = (f"{shlex.quote(sys.executable)} -m "
                   f"horovod_tpu_torch.run.task_runner")
        code = launch_job(slots, command, addr, port, extra_env=env,
                          verbose=verbose, elastic=elastic,
                          min_ranks=min_ranks)
        if code != 0:
            raise RuntimeError(
                f"hvdrun-torch job failed with exit code {code}")
        results = []
        for rank in range(np):
            blob = rendezvous.get(RESULT_SCOPE, str(rank))
            if blob is None:
                raise RuntimeError(f"rank {rank} produced no result")
            digest, payload = (blob[:secret_mod.DIGEST_LEN],
                               blob[secret_mod.DIGEST_LEN:])
            if not secret_mod.check(key, payload, digest):
                raise PermissionError(
                    f"rank {rank} result failed HMAC verification")
            status, value = pickle.loads(payload)
            if status == "error":
                raise RuntimeError(f"rank {rank} failed: {value}")
            results.append(value)
        return results
    finally:
        rendezvous.stop()
