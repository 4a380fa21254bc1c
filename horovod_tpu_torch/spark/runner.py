"""Horovod on Spark: a training function run in Spark tasks, one a rank
(port of ``horovod_tpu/spark/runner.py``; reference:
``horovod/spark/runner.py:131``).

A barrier stage with one partition a rank; the driver hosts the port's
rendezvous KV, and each task takes its rank, joins the job through the
KV as a launched worker does (``hvd.init``), runs the function and
leaves.  Needs PySpark (import-guarded).

One departure from the JAX package, whose tasks each take local rank 0
of a host of one: a torch rank drives the card ``cuda:<local_rank %
cards>`` (``common/basics.py::_card``), so tasks sharing a host would all
land on ``cuda:0``.  Each task publishes its host's hash
(``run/host_hash.py``) at the KV, waits (within ``start_timeout``) for
every task's, and takes its local rank and size from the tasks on its
host and its cross rank and size from the hosts, in task order, as
Horovod's own Spark runner places ranks by host hash.  A task that sees
one card (Spark's GPU scheduling sets ``CUDA_VISIBLE_DEVICES``) takes
that card."""

import base64
import os
import socket
import threading
import time

from horovod_tpu_torch.run import http_client
from horovod_tpu_torch.utils import env as env_util

try:
    import pyspark  # noqa: F401
    _PYSPARK_ERROR = None
except ImportError as _exc:
    pyspark = None
    _PYSPARK_ERROR = _exc

START_SCOPE = "spark-start"
HOST_SCOPE = "spark-host"
# the window in which a task tells a first attempt from a Spark retry
RETRY_PROBE_S = 15.0


def _require_pyspark():
    if pyspark is None:
        raise ImportError(
            "horovod_tpu_torch.spark requires PySpark, which is not "
            "installed in this environment. The estimator framework "
            "(Store / Backend / TorchEstimator) is available Spark-free "
            "in horovod_tpu_torch.cluster.") from _PYSPARK_ERROR


def _driver_ip():
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def placement(index, hashes):
    """Task ``index``'s ``(local_rank, local_size, cross_rank,
    cross_size)`` among tasks whose host hashes are ``hashes`` (in task
    order): its place among the tasks of its host, and its host's place
    among the hosts in order of their first task."""
    hosts = list(dict.fromkeys(hashes))
    peers = [i for i, h in enumerate(hashes) if h == hashes[index]]
    return (peers.index(index), len(peers), hosts.index(hashes[index]),
            len(hosts))


def _check_first_attempt(index, addr, port):
    """A rank already registered is a Spark retry of its task: a retried
    rank cannot join peers that are in a collective or gone, so the
    stage fails at once instead of waiting at a half-dead rendezvous."""
    deadline = time.monotonic() + RETRY_PROBE_S
    while True:
        try:
            # retry_for=0: this loop owns the budget
            http_client.get(addr, port, START_SCOPE, str(index),
                            retry_for=0)
            raise RuntimeError(
                f"task for rank {index} appears to be a Spark retry; "
                f"horovod jobs cannot retry individual ranks — fail "
                f"the whole job and resubmit")
        except KeyError:
            return  # absent: the first attempt
        except OSError:
            # a transport blip must not fail a first attempt; past the
            # budget, fail open: a dead rendezvous fails the next contact
            if time.monotonic() > deadline:
                return
            time.sleep(0.25)


def _host_placement(index, num_proc, addr, port, start_timeout):
    from horovod_tpu_torch.run.host_hash import host_hash

    http_client.put(addr, port, HOST_SCOPE, str(index),
                    host_hash().encode())
    deadline = time.monotonic() + start_timeout
    hashes = []
    for i in range(num_proc):
        try:
            hashes.append(http_client.get(
                addr, port, HOST_SCOPE, str(i),
                timeout=max(0.0, deadline - time.monotonic())).decode())
        except KeyError:
            raise RuntimeError(
                f"rank {index}: the Spark task of rank {i} published no "
                f"host within start_timeout={start_timeout}s; does the "
                f"cluster have enough task slots?") from None
    return placement(index, hashes)


def _task_fn(index, num_proc, fn, args, kwargs, rendezvous_addr,
             rendezvous_port, secret_b64, extra_env, device=None,
             start_timeout=None):
    """What one Spark task (one rank) runs."""
    from horovod_tpu_torch.common import basics

    for key, value in (extra_env or {}).items():
        os.environ[key] = value
    port = int(rendezvous_port)
    _check_first_attempt(index, rendezvous_addr, port)
    http_client.put(rendezvous_addr, port, START_SCOPE, str(index), b"1")
    if start_timeout is None:
        start_timeout = env_util.get_float(
            env_util.HVD_START_TIMEOUT,
            env_util.DEFAULT_START_TIMEOUT_SECONDS)
    local_rank, local_size, cross_rank, cross_size = _host_placement(
        index, num_proc, rendezvous_addr, port, start_timeout)
    os.environ[env_util.HVD_RANK] = str(index)
    os.environ[env_util.HVD_SIZE] = str(num_proc)
    os.environ[env_util.HVD_LOCAL_RANK] = str(local_rank)
    os.environ[env_util.HVD_LOCAL_SIZE] = str(local_size)
    os.environ[env_util.HVD_CROSS_RANK] = str(cross_rank)
    os.environ[env_util.HVD_CROSS_SIZE] = str(cross_size)
    os.environ[env_util.HVD_RENDEZVOUS_ADDR] = rendezvous_addr
    os.environ[env_util.HVD_RENDEZVOUS_PORT] = str(port)
    os.environ[env_util.HVD_SECRET_KEY] = secret_b64
    os.environ[env_util.HVD_CONTROLLER] = "tcp"

    basics.init(device=device)
    try:
        return fn(*args, **kwargs)
    finally:
        basics.shutdown()


def run(fn, args=(), kwargs=None, num_proc=None, start_timeout=None,
        use_barrier=True, verbose=False, env=None, device=None):
    """Run ``fn(*args, **kwargs)`` as a Horovod job in Spark tasks; ->
    the ranks' results in rank order (reference signature:
    ``spark/runner.py:131``; ``env`` joins each task's environment).
    ``device``: each rank's (default: its card; ``"cpu"`` for gloo)."""
    _require_pyspark()
    del verbose
    from pyspark.sql import SparkSession

    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.run.service import secret as secret_mod

    kwargs = kwargs or {}
    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is None:
        num_proc = max(int(sc.defaultParallelism), 1)

    rendezvous = RendezvousServer()
    port = rendezvous.start()
    addr = _driver_ip()
    secret_b64 = base64.b64encode(secret_mod.make_secret_key()).decode()

    def mapper(index, _iterator):
        yield _task_fn(index, num_proc, fn, args, kwargs, addr, port,
                       secret_b64, env, device, start_timeout)

    try:
        rdd = sc.parallelize(range(num_proc), num_proc)
        if use_barrier and hasattr(rdd, "barrier"):
            # barrier mode schedules every rank together (a partial gang
            # would wait forever in its first collective)
            mapped = rdd.barrier().mapPartitionsWithIndex(mapper)
        else:
            mapped = rdd.mapPartitionsWithIndex(mapper)
        if not start_timeout:
            return mapped.collect()
        # start_timeout (reference: spark/runner.py): fail when the
        # cluster cannot start the whole gang in time, e.g. with fewer
        # slots than num_proc; collect in a thread and watch the tasks'
        # starts at the KV
        box = {}

        def _collect():
            try:
                box["results"] = mapped.collect()
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                box["error"] = exc

        thread = threading.Thread(target=_collect, daemon=True)
        thread.start()
        deadline = time.monotonic() + start_timeout
        started = set()
        while thread.is_alive() and len(started) < num_proc:
            for i in range(num_proc):
                if i not in started and rendezvous.get(
                        START_SCOPE, str(i)) is not None:
                    started.add(i)
            if (len(started) < num_proc
                    and time.monotonic() > deadline):
                raise RuntimeError(
                    f"Spark could not start all {num_proc} training "
                    f"tasks within start_timeout={start_timeout}s "
                    f"({len(started)} started); does the cluster have "
                    f"enough task slots?")
            thread.join(timeout=0.5)
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["results"]
    finally:
        rendezvous.stop()
