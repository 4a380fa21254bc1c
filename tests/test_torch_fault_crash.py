"""A rank that dies, on the port's control plane: every survivor raises
``HvdAbortedError`` naming the dead rank within the abort deadline, with
every handle settled, and exits cleanly (what
``tests/test_fault_injection.py:338-389`` asserts of the JAX package).
Two gloo ranks under the launcher's env contract, the JAX tests'
windows (``torch_fault_ranks.FT_ENV``)."""

import pytest

from torch_fault_ranks import FT_ENV, MATRIX_WORKER, assert_aborted, spawn


@pytest.mark.parametrize("op", ["allreduce", "broadcast", "allgather"])
def test_injected_crash_aborts_survivor(op):
    """Rank 1 hard-exits at its first <op> submit, before negotiation:
    liveness notices the silence and rank 0 raises
    HvdAbortedError(origin=1)."""
    results = spawn(2, MATRIX_WORKER, {
        **FT_ENV, "FT_OP": op, "HVD_TPU_LIVENESS_TIMEOUT": "2",
        "HVD_STALL_SHUTDOWN_TIME_SECONDS": "20",
        "HVD_TPU_FAULT_SPEC": f"rank1:{op}:1:crash"})
    code0, out0, err0 = results[0]
    code1, out1, err1 = results[1]
    assert code1 == 1, f"crashed rank: {out1}\n{err1}"
    assert code0 == 0, f"survivor: {out0}\n{err0}"
    assert_aborted(out0, rank=0, origin=1)


def test_injected_crash_mid_collective():
    """Rank 1 dies at ``ring``, after the negotiation's go-ahead, with
    rank 0 already inside the gloo allreduce: rank 0's collective breaks,
    it waits for the coordinator's verdict and names rank 1, not
    itself."""
    results = spawn(2, MATRIX_WORKER, {
        **FT_ENV, "FT_OP": "allreduce", "FT_SIZE": "70000",
        "HVD_TPU_LIVENESS_TIMEOUT": "2",
        "HVD_STALL_SHUTDOWN_TIME_SECONDS": "30",
        "HVD_TPU_FAULT_SPEC": "rank1:ring:1:crash"})
    code0, out0, err0 = results[0]
    code1, out1, _ = results[1]
    assert code1 == 1, f"crashed rank: {out1}"
    assert "[hvd-fault] crashing at ring" in results[1][2]
    assert code0 == 0, f"survivor: {out0}\n{err0}"
    assert_aborted(out0, rank=0, origin=1)


def test_dead_coordinator_aborts_the_survivor_naming_rank_0():
    """Rank 0, whose process hosts the coordinator, dies: rank 1 loses
    the control plane and aborts itself naming rank 0, well inside the
    abort deadline."""
    results = spawn(2, MATRIX_WORKER, {
        **FT_ENV, "FT_OP": "allreduce", "HVD_TPU_LIVENESS_TIMEOUT": "2",
        "HVD_STALL_SHUTDOWN_TIME_SECONDS": "20",
        "HVD_TPU_FAULT_SPEC": "rank0:allreduce:1:crash"})
    assert results[0][0] == 1, results[0]
    code1, out1, err1 = results[1]
    assert code1 == 0, f"survivor: {out1}\n{err1}"
    assert_aborted(out1, rank=1, origin=0)
    assert "coordinator unreachable" in err1


OPTIMIZER_WORKER = r"""
import os, time
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
torch.manual_seed(0)
model = torch.nn.Linear(64, 64)
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
state = hvd.elastic.State(params=model.state_dict(), optimizer_state=opt)
x = torch.randn(8, 64) * (r + 1)
start = time.monotonic()
try:
    for step in range(3):
        start = time.monotonic()
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()
        print(f"rank {r} STEP {step}", flush=True)
        state.step = step + 1
        state.commit()
        print(f"rank {r} COMMIT {state.step}", flush=True)
    print(f"rank {r} COMPLETED", flush=True)
except hvd.HvdAbortedError as exc:
    print(f"rank {r} ABORTED origin={exc.origin_rank} "
          f"elapsed={time.monotonic() - start:.1f} settled=1", flush=True)
    # the training loop's next commit is refused; the last one stays
    state.step += 1
    try:
        state.commit()
        print(f"rank {r} COMMIT {state.step}", flush=True)
    except hvd.HvdAbortedError as exc:
        print(f"rank {r} COMMIT-REFUSED origin={exc.origin_rank}",
              flush=True)
    print(f"rank {r} LAST-COMMIT {state._committed[2]}", flush=True)
hvd.shutdown()
print(f"rank {r} DONE", flush=True)
"""


def test_crash_in_an_optimizer_bucket_is_a_typed_abort():
    """Rank 1 dies at its second ``DistributedOptimizer`` bucket start:
    rank 0's bucket allreduce breaks, and ``step()`` raises the typed
    error naming rank 1 instead of gloo's own; an ``elastic.State``
    commit after it is refused, and the commit of step 1 stays the
    last."""
    results = spawn(2, OPTIMIZER_WORKER, {
        **FT_ENV, "HVD_TPU_LIVENESS_TIMEOUT": "2",
        "HVD_TPU_FAULT_SPEC": "rank1:allreduce:2:crash"})
    assert results[1][0] == 1, results[1]
    assert "rank 1 STEP 0" in results[1][1]
    code0, out0, err0 = results[0]
    assert code0 == 0, f"survivor: {out0}\n{err0}"
    assert "rank 0 STEP 0" in out0 and "rank 0 STEP 1" not in out0
    assert_aborted(out0, rank=0, origin=1)
    assert "rank 0 COMMIT 1" in out0 and "rank 0 COMMIT 2" not in out0
    assert "rank 0 COMMIT-REFUSED origin=1" in out0
    assert "rank 0 LAST-COMMIT 1" in out0


DTYPE_WORKER = r"""
import time
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
start = time.monotonic()
try:
    # gloo reduces no uint16: the backend refuses it on this rank
    hvd.allreduce_gradients([torch.ones(8, dtype=torch.uint16)])
    print(f"rank {r} NO-ERROR", flush=True)
except hvd.HvdAbortedError as exc:
    print(f"rank {r} ABORTED origin={exc.origin_rank}", flush=True)
except RuntimeError as exc:
    print(f"rank {r} RAISED elapsed={time.monotonic() - start:.2f} "
          f"{exc}", flush=True)
out = hvd.allreduce_gradients([torch.full((8,), float(r + 1))],
                              op=hvd.Sum)
print(f"rank {r} SUM {float(out[0][0])}", flush=True)
hvd.shutdown()
"""


def test_a_callers_error_in_a_collective_raises_at_once():
    """A dtype the backend refuses is the caller's error, not a broken
    communication: it is raised at once, without the wait for the
    coordinator's verdict (about 21 s at the default liveness window),
    and the job goes on."""
    results = spawn(2, DTYPE_WORKER, {"HVD_TPU_HEARTBEAT_INTERVAL": "0.25",
                                      "OMP_NUM_THREADS": "1"})
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank}: {out}\n{err}"
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"rank {rank} RAISED")]
        assert line, out
        assert float(line[0].split("elapsed=")[1].split()[0]) < 5.0, line
        assert f"rank {rank} SUM 3.0" in out
