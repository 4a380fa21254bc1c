"""A rank that lives but does not take part, on the port's control
plane: the stall shutdown turns a stalled tensor into a coordinated
abort naming the first lagging rank (a group's lagging member), and
``hvd.abort()`` reaches a blocked peer; every rank raises the typed
error (what ``tests/test_fault_injection.py:390-490`` and
``tests/test_stall.py:106-175`` assert of the JAX package)."""

import pytest

from torch_fault_ranks import FT_ENV, MATRIX_WORKER, assert_aborted, spawn


@pytest.mark.parametrize("op", ["allreduce", "broadcast", "allgather"])
def test_injected_drop_promotes_stall_into_abort(op):
    """Rank 1 silently drops its contribution (alive and heartbeating:
    liveness cannot see it): the stall shutdown names rank 1, and both
    ranks, the dropper included, raise the same typed error."""
    results = spawn(2, MATRIX_WORKER, {
        **FT_ENV, "FT_OP": op, "HVD_TPU_LIVENESS_TIMEOUT": "30",
        "HVD_STALL_SHUTDOWN_TIME_SECONDS": "2",
        "HVD_TPU_FAULT_SPEC": f"rank1:{op}:1:drop"})
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank}: {out}\n{err}"
        assert_aborted(out, rank=rank, origin=1)
    assert "stalled tensor 'ft.tensor' exceeded shutdown threshold of " \
           "2.0s (waiting on ranks [1])" in results[0][2]


STALL_WORKER = r"""
import time
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
if r == 0:
    # never submits; stays alive (heartbeats keep going) past the 2s
    # stall shutdown and the abort's delivery
    time.sleep(4.5)
    print("rank 0 SKIPPED", flush=True)
else:
    try:
        hvd.allreduce(torch.ones(2), name="stall.tensor", op=hvd.Sum)
        print("rank 1 NO-ERROR", flush=True)
    except hvd.HvdAbortedError as exc:
        print(f"rank 1 ABORTED origin={exc.origin_rank}", flush=True)
hvd.shutdown()
"""


def test_stall_shutdown_names_the_rank_that_never_submitted():
    results = spawn(2, STALL_WORKER, {
        **FT_ENV, "HVD_STALL_SHUTDOWN_TIME_SECONDS": "2",
        "HVD_TPU_LIVENESS_TIMEOUT": "30"})
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank}: {out}\n{err}"
    assert "rank 0 SKIPPED" in results[0][1]
    assert "rank 1 ABORTED origin=0" in results[1][1], results[1]


GROUP_WORKER = r"""
import time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics

hvd.init(device="cpu")
r = hvd.rank()
lo = hvd.new_group([0, 1], name="ft.lo")
hi = hvd.new_group([2, 3], name="ft.hi")
mine = lo if r < 2 else hi
start = time.monotonic()
try:
    hvd.allreduce(torch.ones(8) * (r + 1), op=hvd.Sum, name="ft.group",
                  group=mine)
    # the healthy group reaches the world barrier and must ALSO die; it
    # waits first, so that the stalled group entry is the older one
    time.sleep(0.5)
    hvd.barrier()
    print(f"rank {r} COMPLETED", flush=True)
except hvd.HvdAbortedError as exc:
    controller = basics._get_state().controller
    settled = int(controller._in_flight == 0 and not controller._held)
    print(f"rank {r} ABORTED origin={exc.origin_rank} "
          f"elapsed={time.monotonic() - start:.1f} settled={settled}",
          flush=True)
hvd.shutdown()
"""


def test_stalled_subgroup_entry_names_its_lagging_member():
    """Rank 1 drops its group's allreduce: the stall shutdown names the
    lagging member of that group, and the abort fails the whole job,
    the other group's members (waiting at the world's barrier)
    included."""
    results = spawn(4, GROUP_WORKER, {
        **FT_ENV, "HVD_TPU_LIVENESS_TIMEOUT": "30",
        "HVD_STALL_SHUTDOWN_TIME_SECONDS": "2",
        "HVD_TPU_FAULT_SPEC": "rank1:allreduce:1:drop"}, timeout=90)
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank}: {out}\n{err}"
        assert_aborted(out, rank=rank, origin=1)


USER_ABORT_WORKER = r"""
import time
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
start = time.monotonic()
try:
    if r == 1:
        time.sleep(1.0)  # let rank 0 block in negotiation first
        hvd.abort("operator says no")
        # the sticky abort fails this rank's own next submit too
        try:
            hvd.allreduce(torch.ones(4), op=hvd.Sum, name="after")
            print(f"rank {r} UNEXPECTED-OK", flush=True)
        except hvd.HvdAbortedError as exc:
            print(f"rank {r} STICKY-OK {exc}", flush=True)
    else:
        hvd.allreduce(torch.ones(4), op=hvd.Sum, name="ua.tensor")
        print(f"rank {r} COMPLETED", flush=True)
except hvd.HvdAbortedError as exc:
    print(f"rank {r} ABORTED origin={exc.origin_rank} "
          f"elapsed={time.monotonic() - start:.1f} settled=1", flush=True)
hvd.shutdown()
"""


def test_user_abort_reaches_blocked_peer():
    """``hvd.abort()`` on rank 1 fails rank 0, blocked in negotiation,
    with the typed error naming rank 1; rank 1's next submit fails the
    same way."""
    results = spawn(2, USER_ABORT_WORKER, {
        **FT_ENV, "HVD_TPU_LIVENESS_TIMEOUT": "30",
        "HVD_STALL_SHUTDOWN_TIME_SECONDS": "30"})
    for rank, (code, out, err) in enumerate(results):
        assert code == 0, f"rank {rank}: {out}\n{err}"
    assert_aborted(results[0][1], rank=0, origin=1)
    assert ("rank 1 STICKY-OK collective runtime aborted (origin rank 1): "
            "operator says no") in results[1][1]
