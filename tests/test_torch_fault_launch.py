"""Transport blips and the launcher, on the port's control plane:
refused connects are retried and the collective completes exactly; the
launcher names the rank that failed first, and the rank a crash spec
armed; the two communicators driven in different orders (ROADMAP C.7)
end in a typed abort under the stall shutdown instead of a hang (what
``tests/test_fault_injection.py:431-520`` asserts of the JAX
package)."""

import os
import subprocess
import sys

import pytest

from torch_fault_ranks import (FT_ENV, MATRIX_WORKER, REPO, assert_aborted,
                               spawn)


@pytest.mark.parametrize("op", ["allreduce", "broadcast", "allgather"])
def test_injected_connect_refusals_are_retried(op):
    """Both ranks' first two connection attempts are refused: the
    backoff retry carries the control plane through and the collective
    completes exactly."""
    results = spawn(2, MATRIX_WORKER, {
        **FT_ENV, "FT_OP": op, "FT_SIZE": "70000",
        "HVD_TPU_LIVENESS_TIMEOUT": "30",
        "HVD_TPU_FAULT_SPEC": "*:connect:1:refuse,*:connect:2:refuse",
        "HVD_TPU_CONNECT_RETRY_SECONDS": "20"})
    want = {"allreduce": 3 * 70000, "broadcast": 70000,
            "allgather": 3 * 70000}[op]
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank}: {out}\n{err}"
        assert f"rank {rank} COMPLETED sum={float(want)}" in out, \
            f"{out}\n{err}"


def _launch(tmp_path, script, *flags):
    path = tmp_path / "worker.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--term-grace", "2", *flags, sys.executable, str(path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)


def test_launcher_names_culprit_rank(tmp_path):
    """A rank that dies on its own is named as the culprit: the
    SIGTERMed victims cannot steal the blame with their -15."""
    result = _launch(tmp_path, "import os, sys, time\n"
                     "if os.environ['HVD_RANK'] == '1':\n"
                     "    time.sleep(0.5)\n"
                     "    sys.exit(7)\n"
                     "time.sleep(30)\n")
    assert result.returncode == 7, result.stderr
    assert "rank 1 failed first (exit code 7)" in result.stderr, \
        result.stderr


CRASH_WORKER = r"""
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
try:
    hvd.allreduce(torch.ones(4), op=hvd.Sum, name="culprit")
except hvd.HvdAbortedError as exc:
    print(f"rank {hvd.rank()} ABORTED origin={exc.origin_rank}",
          flush=True)
    raise SystemExit(3)
"""


def test_launcher_blames_the_rank_a_crash_spec_armed(tmp_path):
    """``--fault-spec rank1:allreduce:1:crash``: the launcher exits
    non-zero naming rank 1 (``fault_crash_ranks``), whichever rank it
    reaps first."""
    result = _launch(tmp_path, CRASH_WORKER, "--fault-spec",
                     "rank1:allreduce:1:crash", "--liveness-timeout", "2",
                     "--heartbeat-interval", "0.25")
    assert result.returncode != 0, result.stderr
    assert "rank 1 failed first (exit code 1)" in result.stderr, \
        result.stderr
    assert "[hvd-fault] crashing at allreduce" in result.stderr


CROSS_ORDER_WORKER = r"""
import time
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
torch.manual_seed(0)
model = torch.nn.Linear(16, 16)
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
start = time.monotonic()
try:
    if r == 0:
        # a plane op first, then the optimizer's collective: its drain
        # waits for a plane op the others submit only after their step
        handle = hvd.allreduce_async(torch.ones(4), name="c7.plane")
        model(torch.ones(2, 16)).sum().backward()
        opt.step()
        hvd.synchronize(handle)
    else:
        model(torch.ones(2, 16)).sum().backward()
        opt.step()
        hvd.allreduce(torch.ones(4), name="c7.plane")
    print(f"rank {r} COMPLETED", flush=True)
except hvd.HvdAbortedError as exc:
    print(f"rank {r} ABORTED origin={exc.origin_rank} "
          f"elapsed={time.monotonic() - start:.1f} settled=1", flush=True)
hvd.shutdown()
"""


def test_cross_order_ends_in_a_typed_abort_under_stall_shutdown():
    """ROADMAP C.7 on gloo: rank 0 submits a plane op and then steps;
    rank 1 steps first.  Rank 0 blocks in the optimizer's drain, rank 1
    in its bucket's allreduce; the stall shutdown names rank 1 (the
    plane op's lagging rank), and both raise the typed error."""
    results = spawn(2, CROSS_ORDER_WORKER, {
        **FT_ENV, "HVD_TPU_LIVENESS_TIMEOUT": "30",
        "HVD_STALL_SHUTDOWN_TIME_SECONDS": "2"})
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank}: {out}\n{err}"
        assert_aborted(out, rank=rank, origin=1, deadline=30.0)
