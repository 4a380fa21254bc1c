"""The port's timeline (``horovod_tpu_torch/utils/timeline.py``, the eager
plane's spans in ``ops/controller.py``, ``DistributedOptimizer``'s bucket
spans) against the JAX package's (``horovod_tpu/utils/timeline.py``,
``tests/test_timeline.py``).

- The same calls on both ``Timeline`` classes write the same records,
  timestamps and the wall-clock epoch aside; the port's deferred span
  (``span_after``) writes the records of a ``begin`` and an ``end``.
- ``merge_timeline_contents`` of both packages writes the same file for
  the same per-rank contents, a truncated trace among them.
- ``tests/test_timeline.py``'s scenarios on the port's plane at 2 gloo
  ranks through the port's launcher (one job with ``HVD_TIMELINE`` and
  ``HVD_TIMELINE_MARK_CYCLES``, one without): ``NEGOTIATE_ALLREDUCE``,
  ``ALLREDUCE``, ``NEGOTIATE_ALLGATHER``, ``ALLGATHER`` and ``CYCLE``
  present; every rank's tick; ``B``/``E`` balanced on every row;
  ``ts >= 0``; rank 0's merged file holds every rank's rows; no file
  without ``HVD_TIMELINE``; two ``DistributedOptimizer`` steps write one
  balanced ``ALLREDUCE`` span a bucket a step.
- An elastic reconfiguration (3 gloo ranks, rank 2 crashes) closes each
  survivor's trace and opens the next epoch's; the merge at shutdown
  holds the survivors' rows, and no timeline thread outlives it.
"""

import json
import os
import subprocess
import sys

import pytest

from horovod_tpu.utils import timeline as jtl

from horovod_tpu_torch.utils import timeline as ttl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _calls(tl, deferred):
    tl.begin("grad.a", "NEGOTIATE_ALLREDUCE")
    tl.instant("grad.a", "0")
    tl.instant("grad.a", "1")
    tl.end("grad.a")
    tl.mark_cycle()
    if deferred:
        tl.span_after("grad.a", "ALLREDUCE", tl.now(), None, {"bytes": 64})
        tl.close()   # the completion thread's records first
    else:
        tl.begin("grad.a", "ALLREDUCE")
        tl.end("grad.a", {"bytes": 64})
    tl.begin("gather", "NEGOTIATE_ALLGATHER")
    tl.end("gather")
    tl.close()


def _records(path):
    out = []
    for e in json.loads(path.read_text()):
        e = {k: v for k, v in e.items() if k != "ts"}
        if e.get("name") == "hvd_epoch":
            e["args"] = {}
        out.append(e)
    return out


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["begin-end", "span_after"])
def test_records_match_jax(tmp_path, deferred):
    got = ttl.Timeline(str(tmp_path / "port.json"), mark_cycles=True)
    _calls(got, deferred)
    want = jtl.Timeline(str(tmp_path / "jax.json"), mark_cycles=True)
    _calls(want, False)
    if deferred:
        # closed before the last span: the later calls write nothing
        jax_records = _records(tmp_path / "jax.json")
        cut = [i for i, e in enumerate(jax_records)
               if e.get("args") == {"name": "gather"}][0]
        assert _records(tmp_path / "port.json") == jax_records[:cut]
    else:
        assert _records(tmp_path / "port.json") == \
            _records(tmp_path / "jax.json")
    assert not ttl.Timeline(None).enabled


def test_merge_matches_jax(tmp_path):
    contents = {}
    for r in range(3):
        tl = jtl.Timeline(str(tmp_path / f"t.rank{r}"), mark_cycles=True)
        _calls(tl, False)
        contents[r] = (tmp_path / f"t.rank{r}").read_text()
    contents[3] = contents[2][:-20]   # a truncated flush: left out
    jtl.merge_timeline_contents(contents, str(tmp_path / "jax.json"))
    ttl.merge_timeline_contents(contents, str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


WORKER = r"""
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
for _ in range(2):
    hvd.allreduce(torch.ones(4) * r, name="timeline.tensor", op=hvd.Sum)
    hvd.allgather(torch.ones(2, 2), name="timeline.gather")
torch.manual_seed(0)
model = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Linear(64, 4))
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1),
    named_parameters=model.named_parameters())
print("BUCKETS", len(opt._buckets), flush=True)
for _ in range(2):
    opt.zero_grad()
    model(torch.randn(3, 64)).sum().backward()
    opt.step()
hvd.shutdown()
"""


def _job(tmp_path, name, env):
    run_dir = tmp_path / name
    run_dir.mkdir()
    script = run_dir / "worker.py"
    script.write_text(WORKER)
    env = dict(env, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               HVD_FUSION_THRESHOLD="8192")
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(run_dir))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both jobs at once: with the timeline, and without it."""
    tmp = tmp_path_factory.mktemp("torch_timeline")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("HVD_TIMELINE")}
    on = _job(tmp, "on", dict(base, HVD_TIMELINE=str(tmp / "on" / "tl.json"),
                              HVD_TIMELINE_MARK_CYCLES="1"))
    off = _job(tmp, "off", base)
    outs = {}
    try:
        for name, proc in (("on", on), ("off", off)):
            outs[name] = proc.communicate(timeout=120)[0]
            assert proc.returncode == 0, outs[name][-4000:]
    finally:
        for proc in (on, off):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    buckets = int(outs["on"].split("BUCKETS ", 1)[1].split()[0])
    return tmp, json.loads((tmp / "on" / "tl.json").read_text()), buckets


def _rows(events):
    return {e["pid"]: e["args"]["name"] for e in events
            if e.get("name") == "process_name"}


def test_plane_spans_and_ticks(jobs):
    _, events, _ = jobs
    names = {e.get("name") for e in events}
    for phase in ("NEGOTIATE_ALLREDUCE", "ALLREDUCE", "NEGOTIATE_ALLGATHER",
                  "ALLGATHER", "CYCLE"):
        assert phase in names, phase
    rows = _rows(events)
    ticks = {(rows[e["pid"]], e["name"]) for e in events
             if e.get("ph") == "i" and e["name"] != "CYCLE"}
    for rank in range(2):
        for tensor in ("timeline.tensor", "timeline.gather"):
            # every rank's tick, on every rank's row
            assert {(f"rank {rank}: {tensor}", "0"),
                    (f"rank {rank}: {tensor}", "1")} <= ticks
    assert all(e["ts"] >= 0 for e in events if "ts" in e)
    ends = [e for e in events if e.get("ph") == "E"
            and rows[e["pid"]].endswith("timeline.tensor")
            and "args" in e]
    assert ends and all(e["args"] == {"bytes": 16} for e in ends)


def test_balanced_rows_and_merged_ranks(jobs):
    tmp, events, _ = jobs
    depth = {}
    for e in events:
        if e.get("ph") == "B":
            depth[e["pid"]] = depth.get(e["pid"], 0) + 1
        elif e.get("ph") == "E":
            depth[e["pid"]] = depth.get(e["pid"], 0) - 1
            assert depth[e["pid"]] >= 0, "E without a matching B"
    assert depth and all(d == 0 for d in depth.values()), depth
    rows = set(_rows(events).values())
    for rank in range(2):
        assert f"rank {rank}: timeline.tensor" in rows
        assert f"rank {rank}: CYCLE" in rows
    assert sorted(p.name for p in (tmp / "on").iterdir()) == [
        "tl.json", "tl.json.rank0", "tl.json.rank1", "worker.py"]


def test_no_file_without_the_variable(jobs):
    tmp, _, _ = jobs
    assert [p.name for p in (tmp / "off").iterdir()] == ["worker.py"]


def test_optimizer_buckets_write_one_span_a_step(jobs):
    _, events, buckets = jobs
    rows = _rows(events)
    assert buckets >= 2
    for rank in range(2):
        for b in range(buckets):
            row = f"rank {rank}: DistributedOptimizer.bucket.{b}"
            pids = [p for p, n in rows.items() if n == row]
            assert len(pids) == 1, row
            # in the order written (the completion thread writes a span's
            # B and E together; its E may be stamped after the next B's
            # time)
            mine = [e for e in events if e.get("pid") == pids[0]
                    and e.get("ph") in "BE"]
            assert [e["ph"] for e in mine] == ["B", "E", "B", "E"], row
            assert all(e["name"] == "ALLREDUCE" for e in mine[::2])
            for b_ev, e_ev in zip(mine[::2], mine[1::2]):
                assert e_ev["ts"] >= b_ev["ts"]
                assert e_ev["args"]["bytes"] > 0


ELASTIC_WORKER = r"""
import os, threading
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics

wid = int(os.environ["HVD_RANK"])
torch.set_num_threads(1)
hvd.init(device="cpu")
w = torch.zeros(8)
state = hvd.elastic.State(params={"w": w}, step=0)


def train(state):
    while state.step < 6:
        w.sub_(hvd.allreduce(torch.ones(8), op=hvd.Average,
                             name=f"tl.elastic.{state.step}"))
        state.step += 1
        state.commit()


hvd.elastic.run(train, state)
epoch = basics._get_state().epoch
hvd.shutdown()
alive = [t.name for t in threading.enumerate()
         if t.name.startswith("hvd-torch-timeline")]
print(f"wid {wid} DONE epoch={epoch} threads={len(alive)}", flush=True)
"""


def test_reconfiguration_closes_and_reopens_the_trace(tmp_path):
    """Rank 2 of 3 crashes under ``HVD_TPU_ELASTIC``: each survivor's
    epoch-0 trace is closed (valid JSON) at the reconfiguration, epoch 1
    writes ``<path>.rank<worker>.e1``, rank 0 merges the survivors' at
    shutdown, and no timeline thread outlives ``shutdown``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_fault_ranks

    path = tmp_path / "tl.json"
    env = {**torch_fault_ranks.FT_ENV, "HVD_TPU_LIVENESS_TIMEOUT": "2",
           "HVD_TPU_RECONFIG_TIMEOUT": "60", "HVD_TPU_ELASTIC": "1",
           "HVD_STALL_SHUTDOWN_TIME_SECONDS": "30",
           "HVD_TPU_FAULT_SPEC": "rank2:allreduce:3:crash",
           "HVD_TIMELINE": str(path)}
    res = torch_fault_ranks.spawn(3, ELASTIC_WORKER, extra_env=env,
                                  timeout=90)
    assert res[2][0] == 1, f"injected crash: {res[2][1]}{res[2][2]}"
    for wid in (0, 1):
        code, out, err = res[wid]
        assert code == 0 and f"wid {wid} DONE epoch=1 threads=0" in out, \
            f"{out}\n{err}"
        for name in (f"tl.json.rank{wid}", f"tl.json.rank{wid}.e1"):
            events = json.loads((tmp_path / name).read_text())
            assert any(e.get("name") == "NEGOTIATE_ALLREDUCE"
                       for e in events), name
    rows = set(_rows(json.loads(path.read_text())).values())
    assert {"rank 0: tl.elastic.5", "rank 1: tl.elastic.5"} <= rows
