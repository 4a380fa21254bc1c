"""The port's Spark attachment (``horovod_tpu_torch/spark``) run for real
against ``tests/_pyspark_shim`` (a local-mode PySpark stand-in with
separate executor processes, cloudpickle and barrier gang semantics; see
its docstring), the scenarios of ``tests/test_spark.py``: results in rank
order, collectives across barrier tasks, args and kwargs, the default
``num_proc``, non-barrier mode, a failed task failing the job,
``start_timeout``, a fit through ``SparkBackend`` and the import guard.

One departure from ``tests/test_spark.py``, which asserts
``local_rank() == 0`` in every task: there each task is a host of one.
A torch rank drives the card ``cuda:<local_rank % cards>``, so tasks
sharing a host must have distinct local ranks, or all would take
``cuda:0`` and NCCL would fail at its first collective.  The port's
tasks place themselves by host hash, and on this one host they are local
ranks 0..n-1 of a local size n, cross rank 0 of 1."""

import os
import signal
import subprocess
import sys

import pytest

from horovod_tpu_torch.run import allocate
from horovod_tpu_torch.run.http_server import RendezvousServer
from horovod_tpu_torch.spark import runner
from tests.conftest import pyspark_shim_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_driver(tmp_path, script, extra_env=None, timeout=300):
    """Run a driver script against the shim in a session of its own; when
    it has exited, kill what is left of that session (an executor the
    shim still holds, a task retrying a rendezvous that is gone)."""
    path = tmp_path / "driver.py"
    path.write_text(script)
    env = pyspark_shim_env({"OMP_NUM_THREADS": "1", **(extra_env or {})})
    # the executors import torch_cluster_fns, beside this file
    env["PYTHONPATH"] = os.path.join(REPO, "tests") + os.pathsep + \
        env["PYTHONPATH"]
    with open(tmp_path / "out", "w") as out, \
            open(tmp_path / "err", "w") as err:
        proc = subprocess.Popen([sys.executable, str(path)], env=env,
                                cwd=REPO, stdout=out, stderr=err,
                                start_new_session=True)
        try:
            code = proc.wait(timeout=timeout)
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    stdout = (tmp_path / "out").read_text()
    assert code == 0, \
        f"stdout:\n{stdout}\nstderr:\n{(tmp_path / 'err').read_text()}"
    return stdout


RUN_FN_DRIVER = r"""
import horovod_tpu_torch.spark as spark


def train(base, scale=1.0):
    # one Spark barrier task == one rank
    import torch
    import horovod_tpu_torch as hvd

    r, n = hvd.rank(), hvd.size()
    # one host: local ranks 0..n-1 (the port's placement by host hash)
    assert hvd.local_rank() == r and hvd.local_size() == n, \
        (r, hvd.local_rank(), hvd.local_size())
    assert hvd.cross_rank() == 0 and hvd.cross_size() == 1
    s = hvd.allreduce(torch.full((4,), float(r + 1)), op=hvd.Sum,
                      name="sp.sum")
    assert s[0].item() == sum(range(1, n + 1)), s
    g = hvd.allgather(torch.full((r + 1, 2), float(r)), name="sp.ag")
    assert tuple(g.shape) == (sum(range(1, n + 1)), 2)
    b = hvd.broadcast(torch.full((3,), float(r) + 7.0), root_rank=1,
                      name="sp.bc")
    assert b[0].item() == 8.0
    return {"rank": r, "size": n, "value": base * scale + r}


# per-rank results in rank order, args and kwargs shipped to the tasks
results = spark.run(train, args=(10.0,), kwargs={"scale": 2.0},
                    num_proc=3, device="cpu")
assert [r["rank"] for r in results] == [0, 1, 2], results
assert all(r["size"] == 3 for r in results)
assert [r["value"] for r in results] == [20.0, 21.0, 22.0], results

# the default num_proc is the session's defaultParallelism (2)
assert len(spark.run(train, args=(1.0,), device="cpu")) == 2

# non-barrier mode
results = spark.run(train, args=(5.0,), num_proc=2, use_barrier=False,
                    device="cpu")
assert [r["value"] for r in results] == [5.0, 6.0]
print("SPARK_RUN_OK", flush=True)
"""


def test_spark_run_collectives_and_placement(tmp_path):
    assert "SPARK_RUN_OK" in _run_driver(tmp_path, RUN_FN_DRIVER)


FAILURE_DRIVER = r"""
import horovod_tpu_torch.spark as spark


def boom(x):
    import horovod_tpu_torch as hvd
    if hvd.rank() == 1:
        raise RuntimeError("task exploded")
    return x


try:
    spark.run(boom, args=(1,), num_proc=2, device="cpu")
    raise SystemExit("expected the job to fail")
except RuntimeError as exc:
    assert "task" in str(exc) and "fail" in str(exc), exc


# the driver survives: its rendezvous was torn down, and the next job runs
def ok(x):
    import torch
    import horovod_tpu_torch as hvd
    return hvd.allreduce(torch.ones(2), op=hvd.Sum, name="ok")[0].item()


assert spark.run(ok, args=(0,), num_proc=2, device="cpu") == [2.0, 2.0]
print("SPARK_FAILURE_OK", flush=True)
"""


def test_spark_task_failure_fails_job_and_driver_recovers(tmp_path):
    # one stage attempt: a retried task fails at once anyway (it finds its
    # rank registered), so the shim's retries show nothing more
    assert "SPARK_FAILURE_OK" in _run_driver(
        tmp_path, FAILURE_DRIVER,
        extra_env={"SPARK_SHIM_STAGE_ATTEMPTS": "1"})


START_TIMEOUT_DRIVER = r"""
import horovod_tpu_torch.spark as spark


def train(x):
    return x


# one slot frees only after 30 s (SPARK_SHIM_HOLD_TASK): the gang cannot
# start within start_timeout
try:
    spark.run(train, args=(0,), num_proc=2, start_timeout=4, device="cpu")
    raise SystemExit("expected start_timeout failure")
except RuntimeError as exc:
    assert "start_timeout" in str(exc), exc
    assert "task slots" in str(exc), exc
print("SPARK_START_TIMEOUT_OK", flush=True)
"""


def test_spark_start_timeout_gang_failure(tmp_path):
    out = _run_driver(tmp_path, START_TIMEOUT_DRIVER,
                      extra_env={"SPARK_SHIM_HOLD_TASK": "1",
                                 "SPARK_SHIM_HOLD_SECS": "30",
                                 "SPARK_SHIM_STAGE_ATTEMPTS": "1"})
    assert "SPARK_START_TIMEOUT_OK" in out


ESTIMATOR_DRIVER = r"""
import numpy as np

import torch_cluster_fns as fns
from horovod_tpu_torch.cluster import LocalStore, ParquetStore
from horovod_tpu_torch.spark import SparkBackend
from horovod_tpu_torch.spark.torch import TorchEstimator

x, y = fns.linear_data(n=64)
baseline = float(np.mean(y ** 2))
for store, streaming in ((LocalStore({store!r}), False),
                         (ParquetStore({pq!r}), True)):
    est = TorchEstimator(fns.mlp_factory, epochs=8, batch_size=8,
                         learning_rate=0.05, store=store,
                         streaming=streaming, device="cpu",
                         backend=SparkBackend(num_proc=2, device="cpu"))
    model, metrics = est.fit(x, y)
    assert len(metrics) == 2 and metrics[0] == metrics[1], metrics
    assert model.evaluate(x, y) < 0.5 * baseline, \
        (model.evaluate(x, y), baseline)
print("SPARK_ESTIMATOR_OK", flush=True)
"""


def test_estimator_fit_through_spark_backend(tmp_path):
    pytest.importorskip("pyarrow")
    script = ESTIMATOR_DRIVER.format(store=str(tmp_path / "npz"),
                                     pq=str(tmp_path / "pq"))
    assert "SPARK_ESTIMATOR_OK" in _run_driver(tmp_path, script)


def test_import_guard_without_pyspark(tmp_path):
    """Without pyspark the attachment raises the documented ImportError,
    and the Spark-free estimators stay importable."""
    script = (
        "import horovod_tpu_torch.spark as spark\n"
        "try:\n"
        "    spark.run(lambda: None)\n"
        "    raise SystemExit('expected ImportError')\n"
        "except ImportError as exc:\n"
        "    assert 'PySpark' in str(exc), exc\n"
        "assert spark.TorchEstimator is not None\n"
        "print('GUARD_OK')\n")
    path = tmp_path / "guard.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO   # no shim
    out = subprocess.run([sys.executable, str(path)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "GUARD_OK" in out.stdout


# ------------------------------------------------------------- placement --
@pytest.mark.parametrize("spec,np_total", [("a:1", 1), ("a:4", 4),
                                           ("a:2,b:2", 4), ("a:3,b:1", 4),
                                           ("a:1,b:2,c:3", 6)])
def test_placement_is_the_launchers(spec, np_total):
    """Tasks in host blocks get the launcher's local and cross ranks."""
    slots = allocate.allocate(allocate.parse_hosts(spec), np_total)
    hashes = [s.hostname for s in slots]
    for i, s in enumerate(slots):
        assert runner.placement(i, hashes) == (
            s.local_rank, s.local_size, s.cross_rank, s.cross_size)


def test_placement_of_interleaved_tasks():
    """Spark's task order need not follow hosts: a host's local ranks
    follow its tasks' order, hosts their first task's."""
    hashes = ["b", "a", "b", "c", "a", "b"]
    assert [runner.placement(i, hashes) for i in range(6)] == [
        (0, 3, 0, 3), (0, 2, 1, 3), (1, 3, 0, 3), (0, 1, 2, 3),
        (1, 2, 1, 3), (2, 3, 0, 3)]


@pytest.fixture
def rendezvous():
    server = RendezvousServer()
    port = server.start()
    try:
        yield server, port
    finally:
        server.stop()


def test_a_retried_task_fails_fast(rendezvous):
    server, port = rendezvous
    runner._check_first_attempt(0, "127.0.0.1", port)   # first attempt
    from horovod_tpu_torch.run import http_client

    http_client.put("127.0.0.1", port, runner.START_SCOPE, "0", b"1")
    with pytest.raises(RuntimeError, match="Spark retry"):
        runner._check_first_attempt(0, "127.0.0.1", port)


def test_placement_waits_for_every_task_within_start_timeout(rendezvous):
    _, port = rendezvous
    with pytest.raises(RuntimeError, match="rank 1 published no host"):
        runner._host_placement(0, 2, "127.0.0.1", port, 0.5)
    # with the other task's host there, one host of two tasks
    from horovod_tpu_torch.run import http_client
    from horovod_tpu_torch.run.host_hash import host_hash

    http_client.put("127.0.0.1", port, runner.HOST_SCOPE, "1",
                    host_hash().encode())
    assert runner._host_placement(0, 2, "127.0.0.1", port, 5.0) == \
        (0, 2, 0, 1)
