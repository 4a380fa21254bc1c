"""Phase 6 of ``chip_smoke.py`` (the eager plane at ``min(cards, 4)``
ranks) on this checkout and on another one (e.g. its parent commit,
unpacked with ``git archive``), side by side in one run.

The runs go in the order other, this, other's ranks under this
checkout's launcher, this, other.  Each checkout's own run is its
``chip_smoke.eager_phase`` in a process of its own, the checkout first
on ``sys.path`` and its kernel library built.  The middle run starts
the other checkout's phase-6 ranks with this checkout's
``run/launch.py::launch_job`` and its rendezvous KV server, so that a
change of the negotiation time can be put down either to the ranks'
code or to the way they are started.  Prints one line a run and rank (negotiation
median, and where the checkout reports them its 10th-90th percentiles
and the control plane's heartbeats; cycles, HMAC, eager and direct
allreduce, the step with the plane running and stopped) beside the
card's name and power limit, and writes every result to
``chiprun_out/negotiation_ab.json``.  The other checkout may negotiate
another way (a parent before the coordinated control plane exchanges
over a gloo group): each run is that checkout's own phase 6.

    python3 chip_negotiation_ab.py OTHER_DIR
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

OWN_RUN = """
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke
from horovod_tpu_torch.ops.cuda import _build
_build.build()
_build.lib()
results = chip_smoke.eager_phase(chip_smoke.nvidia_smi(), chip_smoke.LAYERS)
print("AB_RESULT " + json.dumps(results), flush=True)
"""


def own_run(tree):
    """``tree``'s phase 6 as that checkout runs it."""
    out = subprocess.run([sys.executable, "-c", OWN_RUN.format(tree=tree)],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"phase 6 of {tree} exited {out.returncode}:\n"
                             f"{out.stdout[-4000:]}\n{out.stderr[-8000:]}")
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("AB_RESULT ")][-1]
    return json.loads(line.split(" ", 1)[1])


def launched_run(tree, world, logs):
    """``tree``'s phase-6 ranks started by this checkout's launcher, with
    its rendezvous KV server, where the ranks read rank 0's store
    address."""
    import chip_smoke
    from horovod_tpu_torch.run import allocate
    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.run.launch import launch_job

    slots = allocate.allocate([allocate.HostInfo("localhost", world)],
                              world)
    server = RendezvousServer()
    port = server.start()
    command = (f"{sys.executable} {os.path.join(tree, 'chip_smoke.py')} "
               f"--rank-of eager {chip_smoke.LAYERS}")
    try:
        code = launch_job(slots, command, "127.0.0.1", port,
                          output_filename=logs)
    finally:
        server.stop()
    return chip_smoke._rank_results("eager", logs, world, code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout's root")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)

    import torch

    if not torch.cuda.is_available():
        print("chip_negotiation_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    smi = chip_smoke.nvidia_smi()
    world = min(torch.cuda.device_count(), 4)
    logs = os.path.join(chip_smoke._out_dir(), "ranks", "negotiation_ab")
    plan = [("other", lambda: own_run(other)),
            ("this", lambda: own_run(HERE)),
            ("other under this launcher",
             lambda: launched_run(other, world, logs)),
            ("this", lambda: own_run(HERE)),
            ("other", lambda: own_run(other))]
    runs = []
    for i, (label, fn) in enumerate(plan):
        results = fn()
        runs.append({"run": i, "label": label, "results": results})
        for res in results:
            hmac = res.get("hmac_ms_median")
            # a checkout before the coordinated control plane reports
            # neither the spread nor heartbeats
            spread = res.get("negotiation_ms_p10_p90")
            beats = res.get("heartbeat_ms_median")
            print(f"run {i} ({label}) rank {res['rank']} of {res['world']}: "
                  f"negotiation median {res['negotiation_ms_median']:.4f} "
                  + (f"(10th-90th percentile {spread[0]:.4f}-"
                     f"{spread[1]:.4f}) " if spread else "")
                  + f"ms over {res['cycles']} cycles, HMAC "
                  + (f"{hmac * 1e3:.2f} us" if hmac is not None else "none")
                  + (f", heartbeat round trip {beats:.4f} ms, "
                     f"{100 * res['heartbeat_share']:.4f}% of the phase"
                     if beats is not None else "")
                  + f"; grouped_allreduce {res['eager_ms']:.3f} ms, "
                  f"allreduce_gradients {res['direct_ms']:.3f} ms; step "
                  f"{res['step_ms_plane_on']:.2f} ms with the plane "
                  f"running ({res['plane_cycles_per_s']:.1f} cycles/s), "
                  f"{res['step_ms_plane_off']:.2f} ms stopped; {smi}",
                  flush=True)
    with open(os.path.join(chip_smoke._out_dir(), "negotiation_ab.json"),
              "w") as f:
        json.dump({"card": smi, "other": other, "runs": runs}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
