"""Four-card diagnostic of the NCCL communicator abort under elastic
membership (ROADMAP C.14): does aborting every communicator of a rank
return while a dead rank's gradient allreduce hangs on the card?

Each variant is a ``python -m horovod_tpu_torch.run -np 4 --elastic``
job (heartbeat 0.25 s, liveness 2 s) of a small model (four
``Linear(4096, 4096)``, ``DistributedOptimizer(AdamW)``, an
``elastic.State`` commit every step, with or without an integer
allreduce on the eager plane a step); rank 3 crashes in step 4's first
gradient bucket.  The abort listener is replaced by one that aborts in
the variant's order and prints how long each abort took:

- ``torch_order``: ``torch.distributed``'s ``_abort_process_group()``,
  which aborts the groups in reverse order of creation (the default
  group last);
- ``default_first``: the default group's communicator first, then the
  others (what ``common/basics.py::_abort_communicators`` does).

A variant whose abort never returns is ended by its 170 s time limit.
Run from the repository's root on four cards: ``python
chip_abort_diag.py``; logs in ``chiprun_out/diag/<variant>/``.
"""

import os
import subprocess
import sys
import threading
import time

STEPS, CRASH_STEP, BUCKETS = 8, 4, 8   # the model's DO buckets a step
VARIANTS = (("torch_order", True), ("default_first", True),
            ("torch_order", False))


def _log(wid, *a):
    print(f"[{time.time():.3f}] wid {wid} "
          f"{threading.current_thread().name}:", *a, flush=True)


def rank(mode, eager):
    """One rank of a variant's job."""
    import faulthandler
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    faulthandler.dump_traceback_later(40, exit=False)
    wid = int(os.environ["HVD_RANK"])

    def abort(origin, reason):
        _log(wid, "abort listener start", mode)
        if not dist.is_initialized():
            return
        c10d = dist.distributed_c10d
        if mode == "default_first":
            d = c10d._get_default_group()
            t = time.time()
            d.abort()
            _log(wid, "default pg abort", round(time.time() - t, 3))
            for pg in sorted(c10d._world.pg_names, reverse=True,
                             key=lambda x: c10d._world.pg_names[x]):
                if pg is not d:
                    t = time.time()
                    c10d._abort_process_group(pg)
                    _log(wid, "abort", round(time.time() - t, 3))
        t = time.time()
        c10d._abort_process_group()
        _log(wid, "world abort", round(time.time() - t, 3))

    basics._abort_communicators = abort
    hvd.init(timeout=timedelta(seconds=90))
    torch.manual_seed(0)
    model = torch.nn.Sequential(*[torch.nn.Linear(4096, 4096)
                                  for _ in range(4)]).to(hvd.device())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4),
        named_parameters=model.named_parameters())
    x = torch.randn(8192, 4096, device=hvd.device())
    w = torch.zeros(1000, device=hvd.device())
    state = hvd.elastic.State(params={"int.w": w, **model.state_dict()},
                              optimizer_state=opt)

    def train(state):
        while state.step < STEPS:
            s = state.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if eager:
                w.sub_(hvd.allreduce(torch.full_like(w, float(s + 1)),
                                     op=hvd.Average, name=f"d.{s}"))
            opt.zero_grad(set_to_none=True)
            loss = model(x).square().mean()
            loss.backward()
            opt.step()
            value = loss.item()
            torch.cuda.synchronize()
            _log(wid, "step", basics._get_state().epoch, s,
                 round(time.perf_counter() - t0, 4), value)
            state.step = s + 1
            state.commit()

    try:
        hvd.elastic.run(train, state)
        _log(wid, "done", hvd.rank(), hvd.size(),
             basics._get_state().epoch, float(w[0]),
             hvd.elastic.last_reconfig)
    except hvd.HvdAbortedError as exc:
        _log(wid, "ABORTED", exc.origin_rank, exc.reason[:200])
    hvd.shutdown()
    _log(wid, "shutdown done")


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    for mode, eager in VARIANTS:
        name = f"{mode}_{int(eager)}"
        logs = os.path.join(root, "chiprun_out", "diag", name)
        hit = CRASH_STEP * (BUCKETS + eager) + 1 + eager
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "4",
               "--elastic", "--heartbeat-interval", "0.25",
               "--liveness-timeout", "2", "--abort-timeout", "10",
               "--term-grace", "5", "--fault-spec",
               f"rank3:allreduce:{hit}:crash", "--output-filename", logs,
               sys.executable, os.path.abspath(__file__), "--rank", mode,
               str(int(eager))]
        print(f"=== {mode}, eager plane {'used' if eager else 'idle'}",
              flush=True)
        try:
            code = subprocess.run(cmd, cwd=root, timeout=170,
                                  capture_output=True).returncode
        except subprocess.TimeoutExpired:
            code = "timed out (170 s)"
        print(f"launcher: {code}", flush=True)
        for r in range(4):
            path = os.path.join(logs, f"rank.{r}", "stdout")
            if os.path.exists(path):
                for line in open(path):
                    if "abort" in line or "done" in line \
                            or "ABORTED" in line:
                        print(line.rstrip()[:200], flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank(sys.argv[2], sys.argv[3] == "1")
    else:
        main()
