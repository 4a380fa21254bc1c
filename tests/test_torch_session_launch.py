"""The session layer in launched jobs (``python -m horovod_tpu_torch.run``,
two gloo ranks on the CPU): a blip of the last rank's coordinator link
shorter than ``--reconnect-budget`` heals, and the job ends bitwise equal
to the same job without it; a reset that outlasts the budget ends in the
typed abort on every rank, the launcher naming the rank whose link broke
and leaving no worker alive.  Windows as in
``tests/test_torch_fault_launch.py`` (heartbeat 0.25 s, liveness 2 s)."""

import json
import os
import re
import subprocess
import sys
import time

from torch_fault_ranks import REPO

WORKER = r"""
import hashlib, json, os, signal, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.run.service import network

# the launcher's kill fan-out must not beat the job's own abort
signal.signal(signal.SIGTERM, signal.SIG_IGN)
print(f"PID {os.getpid()}", flush=True)
hvd.init(device="cpu")
r = hvd.rank()
torch.manual_seed(0)
model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Tanh(),
                            torch.nn.Linear(64, 8))
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
gen = torch.Generator().manual_seed(100 + r)
steps = []
try:
    for step in range(1, int(os.environ["P17_STEPS"]) + 1):
        t0 = time.monotonic()
        x = torch.randn(16, 32, generator=gen)
        opt.zero_grad()
        loss = model(x).pow(2).mean()
        loss.backward()
        opt.step()
        # every rank's loss through the plane: step K's blip lands here
        losses = hvd.allgather(loss.detach().view(1), name="p17.loss")
        steps.append(time.monotonic() - t0)
except hvd.HvdAbortedError as exc:
    print(f"rank {r} ABORTED origin={exc.origin_rank} "
          f"at={time.time():.3f}", flush=True)
    raise SystemExit(3)
digest = hashlib.sha256(b"".join(
    p.detach().numpy().tobytes() for p in model.parameters())).hexdigest()
print("RESULT " + json.dumps({"rank": r, "digest": digest,
                              "losses": [float(v) for v in losses],
                              "steps": steps,
                              "stats": network.session_stats()}),
      flush=True)
hvd.shutdown()
"""

FLAGS = ("--heartbeat-interval", "0.25", "--liveness-timeout", "2",
         "--abort-timeout", "10", "--term-grace", "20")


def _launch(tmp_path, name, steps, *flags):
    path = tmp_path / "worker.py"
    path.write_text(WORKER)
    logs = tmp_path / name
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               P17_STEPS=str(steps))
    for var in list(env):
        if var.startswith("HVD_"):
            del env[var]
    result = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--output-filename", str(logs), *FLAGS, *flags, sys.executable,
         str(path)], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=150)
    outs = [(logs / f"rank.{r}" / "stdout").read_text() for r in range(2)]
    errs = [(logs / f"rank.{r}" / "stderr").read_text() for r in range(2)]
    return result, outs, errs


def _result(out):
    line = next(l for l in out.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _pids(outs):
    return [int(m) for out in outs for m in re.findall(r"^PID (\d+)$", out,
                                                       re.M)]


def _alive(pid):
    """Running and not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_blip_inside_the_budget_heals_bitwise(tmp_path):
    """``rank1:allgather:3:blip:500`` under ``--reconnect-budget 5``:
    the last rank's link to the coordinator is cut mid-frame in step 3
    and refuses connects for 0.5 s; the session heals, the job finishes,
    and every parameter is bitwise the unfaulted job's."""
    clean, clean_outs, _ = _launch(tmp_path, "clean", 6,
                                   "--reconnect-budget", "5")
    assert clean.returncode == 0, clean.stderr
    blip, outs, errs = _launch(tmp_path, "blip", 6, "--reconnect-budget",
                               "5", "--fault-spec",
                               "rank1:allgather:3:blip:500")
    assert blip.returncode == 0, blip.stderr + "".join(errs)
    want = [_result(o) for o in clean_outs]
    got = [_result(o) for o in outs]
    for g, w in zip(got, want):
        assert g["digest"] == w["digest"]
        assert g["losses"] == w["losses"]
    assert got[0]["digest"] == got[1]["digest"]
    assert got[1]["stats"]["reconnects_healed"] >= 1, errs[1]
    assert got[1]["stats"]["reconnects_failed"] == 0
    assert "[hvd-session] reconnect healed toward peer 0" in errs[1]
    # the step the blip spanned waited for the heal
    assert got[1]["steps"][2] >= 0.4


def test_reset_past_the_budget_aborts_every_rank(tmp_path):
    """``rank1:allgather:3:reset:1.0:4`` under ``--reconnect-budget 1``:
    every frame the last rank writes for 4 s is cut, so its heal runs
    out: it raises the typed abort naming the coordinator, rank 0 raises
    it naming rank 1 (silent past the liveness window), the launcher
    exits non-zero naming rank 1 as the rank that failed first, and no
    worker is left."""
    start = time.monotonic()
    result, outs, errs = _launch(
        tmp_path, "reset", 6, "--reconnect-budget", "1", "--fault-spec",
        "rank1:allgather:3:reset:1.0:4")
    assert result.returncode != 0
    assert "rank 1 failed first (exit code 3)" in result.stderr, \
        result.stderr
    assert re.search(r"rank 1 ABORTED origin=0 ", outs[1]), outs[1] + errs[1]
    assert re.search(r"rank 0 ABORTED origin=1 ", outs[0]), outs[0] + errs[0]
    assert "mid-stream connection reset" in errs[1]
    assert time.monotonic() - start < 60
    pids = _pids(outs)
    assert len(pids) == 2
    assert not [p for p in pids if _alive(p)]
