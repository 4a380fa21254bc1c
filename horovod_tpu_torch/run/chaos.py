"""Seeded chaos-spec generation, and the chaos launcher (port of
``horovod_tpu/run/chaos.py`` and ``bin/hvd-chaos``).

``generate_spec`` is the reference's, draw for draw: the same seed gives
the same ``HVD_TPU_FAULT_SPEC`` byte for byte (grammar:
``common/faults.py``), so a failing soak run is replayed exactly, and a
seed's spec is the same under both packages.

    python -m horovod_tpu_torch.run.chaos --seed 7 -- -np 4 python train.py
    python -m horovod_tpu_torch.run.chaos --spec 'rank1:ring:3:crash' \
        -- -np 4 python train.py

prints the spec, then launches ``hvdrun-torch`` with it (everything
after ``--`` goes to the launcher verbatim).  ``--elastic`` adds the
drain's ``preempt`` cells and runs the job under ``--elastic``;
``--coord-failover`` (which implies it) adds a rank-0 cell and arms the
fail-over, as the reference's ``bin/hvd-chaos`` does.
"""

import random

# the knobs a chaos spec draws from; "connect" exercises the transport
# retry path, the op/ring points exercise coordinated abort + liveness
_POINTS = ("allreduce", "broadcast", "allgather", "ring", "send",
           "connect")
_ACTIONS = ("crash", "drop", "refuse", "preempt")

# degraded-network cells (docs/fault_tolerance.md "degraded networks"):
# all injected at the link point, duration-scoped.  Parameter menus are
# coarse on purpose — the rig wants qualitatively distinct regimes
# (mild / nasty), not a smooth sweep that no single soak could cover.
# ``partition`` is deliberately NOT in the random pool: a random rank
# range can isolate the coordinator, turning a soak whose success
# criterion is "no false-positive abort" into a guaranteed real abort.
# Partitions are injected explicitly (tests, bin/hvd-soak's scripted
# legs) where the expected outcome is pinned.
_DEGRADE_ACTIONS = ("delay", "jitter", "throttle", "flaky")
_DELAY_MS = (5, 20, 50)
_THROTTLE_MBPS = (4, 16, 64)
_FLAKY_P = (0.05, 0.2)

# mid-stream connection-break cells (--blips; docs/fault_tolerance.md
# "connection blips vs dead peers"): a probabilistic RST storm or a
# one-shot link flap, both absorbed by the session layer when
# HVD_TPU_RECONNECT_BUDGET grants a window.  Rank 0 stays out of the
# pool — cutting the coordinator's links turns a heal soak into a
# liveness test.
_MIDSTREAM_ACTIONS = ("reset", "blip")
_RESET_P = (0.1, 0.3)
_BLIP_MS = (200, 1000, 3000)


def generate_spec(seed, num_ranks, num_faults, elastic=False,
                  degrade=0, coord_failover=False, groups=False,
                  blips=0):
    rng = random.Random(seed)
    specs = []
    for _ in range(num_faults):
        point = rng.choice(_POINTS)
        # refuse only makes sense at the transport; crash/drop at the
        # collective layer.  preempt (SIGTERM-to-self -> graceful drain,
        # docs/checkpoint.md) only joins the pool for elastic soaks:
        # without elastic the drain is refused and the cell degenerates
        # into a crash with extra steps.  NOTE: adding the elastic-only
        # draw AFTER the common ones keeps non-elastic specs identical
        # for a given seed across versions (the replay contract).
        if point == "connect":
            action = "refuse"
        else:
            action = rng.choice(("crash", "drop"))
            if elastic and rng.random() < 0.5:
                action = "preempt"
        rank = rng.randrange(num_ranks)
        step = rng.randint(1, 5)
        specs.append(f"rank{rank}:{point}:{step}:{action}")
    # degraded-network cells draw AFTER every binary-fault draw (same
    # cross-version contract as the elastic cell above): a seed's
    # binary cells are byte-identical whether or not --degrade is used
    for _ in range(degrade):
        action = rng.choice(_DEGRADE_ACTIONS)
        rank = rng.randrange(num_ranks)
        step = rng.randint(1, 5)
        if action in ("delay", "jitter"):
            param = str(rng.choice(_DELAY_MS))
        elif action == "throttle":
            param = str(rng.choice(_THROTTLE_MBPS))
        else:
            param = str(rng.choice(_FLAKY_P))
        duration = rng.randint(2, 8)
        specs.append(f"rank{rank}:link:{step}:{action}:{param}:"
                     f"{duration}")
    # coordinator-kill cell (--coord-failover): rank 0 joins the
    # crash/preempt pool via ONE dedicated cell whose draws come
    # strictly AFTER every pre-existing draw — the same cross-version
    # replay contract as the elastic and degrade cells, so a seed's
    # spec without the flag is byte-identical to every older tree.
    # The survivors are expected to elect a new coordinator
    # (docs/elastic.md#coordinator-fail-over), so this cell only makes
    # sense with fail-over armed in the job under test.
    if coord_failover:
        point = rng.choice(("allreduce", "broadcast", "allgather",
                            "ring"))
        action = rng.choice(("crash", "preempt"))
        step = rng.randint(2, 5)   # after warmup: epoch-0 world forms
        specs.append(f"rank0:{point}:{step}:{action}")
    # group-collective cell (--groups): one fault landing inside a
    # sub-group collective of a job that runs process groups
    # (docs/groups.md) — sub-group collectives flow through the same
    # instrumented points (the submit path and the group's own ring
    # plane), so the grammar is unchanged; what the cell tests is the
    # group-scoped abort/purge path.  Its draws come strictly AFTER
    # every pre-existing draw (binary, degrade, coord-failover), the
    # same cross-version replay contract: a seed's spec without
    # --groups is byte-identical to every older tree.  Rank 0 stays
    # out of the pool for the same reason as the degrade cells —
    # killing the coordinator turns the cell into a different test.
    if groups:
        point = rng.choice(("allreduce", "ring"))
        action = rng.choice(("crash", "drop"))
        rank = rng.randrange(1, num_ranks) if num_ranks > 1 else 0
        step = rng.randint(2, 5)   # after warmup: groups have formed
        specs.append(f"rank{rank}:{point}:{step}:{action}")
    # mid-stream break cells (--blips): reset/blip at the link point.
    # Their draws come strictly AFTER every pre-existing draw (binary,
    # degrade, coord-failover, groups) — the same cross-version replay
    # contract: a seed's spec without --blips is byte-identical to
    # every older tree.
    for _ in range(blips):
        action = rng.choice(_MIDSTREAM_ACTIONS)
        rank = rng.randrange(1, num_ranks) if num_ranks > 1 else 0
        step = rng.randint(1, 5)
        if action == "reset":
            param = str(rng.choice(_RESET_P))
            duration = rng.randint(2, 8)
            specs.append(f"rank{rank}:link:{step}:reset:{param}:"
                         f"{duration}")
        else:
            param = str(rng.choice(_BLIP_MS))
            specs.append(f"rank{rank}:link:{step}:blip:{param}")
    return ",".join(specs)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run.chaos",
        description="Launch hvdrun-torch with a seeded random fault spec.")
    parser.add_argument("--seed", type=int, default=0,
                        help="RNG seed; same seed -> same fault spec.")
    parser.add_argument("--faults", type=int, default=1,
                        help="Number of faults to inject (default 1).")
    parser.add_argument("--degrade", type=int, default=0,
                        help="Number of degraded-network cells (delay/"
                             "jitter/throttle/flaky at the link point) "
                             "to add after the binary faults (default "
                             "0).  Old seeds keep producing "
                             "byte-identical specs when this is 0.")
    parser.add_argument("--spec", default=None,
                        help="Explicit fault spec (skips generation); "
                             "use to replay a failure verbatim.")
    parser.add_argument("--elastic", action="store_true",
                        help="Run the job under --elastic: the "
                             "survivors re-form instead of every rank "
                             "raising the typed abort; adds the "
                             "drain's preempt cells.")
    parser.add_argument("--coord-failover", action="store_true",
                        help="Admit rank 0 into the crash draws and arm "
                             "--coord-failover (implies --elastic).")
    parser.add_argument("--blips", type=int, default=0,
                        help="Number of mid-stream connection-break "
                             "cells (reset/blip at the link point), "
                             "drawn after every other cell (default 0).")
    parser.add_argument("--groups", action="store_true",
                        help="Add one group-collective cell (a crash or "
                             "drop inside a sub-group collective), "
                             "drawn after every other binary cell.")
    parser.add_argument("hvdrun_args", nargs=argparse.REMAINDER,
                        help="Arguments for hvdrun-torch (prefix with "
                             "--).")
    args = parser.parse_args(argv)

    hvdrun_args = args.hvdrun_args
    if hvdrun_args and hvdrun_args[0] == "--":
        hvdrun_args = hvdrun_args[1:]
    if not hvdrun_args:
        parser.error("no hvdrun-torch arguments given (append "
                     "'-- -np N ...')")

    num_ranks = 2
    for i, a in enumerate(hvdrun_args):
        if a in ("-np", "--num-proc") and i + 1 < len(hvdrun_args):
            num_ranks = int(hvdrun_args[i + 1])

    if args.coord_failover:
        args.elastic = True   # fail-over rides the elastic machinery
    spec = args.spec or generate_spec(args.seed, num_ranks, args.faults,
                                      elastic=args.elastic,
                                      degrade=args.degrade,
                                      coord_failover=args.coord_failover,
                                      groups=args.groups, blips=args.blips)
    print(f"hvd-chaos: seed={args.seed} HVD_TPU_FAULT_SPEC={spec!r}"
          f"{' (elastic)' if args.elastic else ''}"
          f"{' (coord-failover)' if args.coord_failover else ''}",
          flush=True)
    for flag, on in (("--elastic", args.elastic),
                     ("--coord-failover", args.coord_failover)):
        if on and flag not in hvdrun_args:
            hvdrun_args = [flag] + hvdrun_args
    # as a flag: the launcher's culprit attribution reads the job's own
    # crash ranks from it (run/launch.py::fault_crash_ranks)
    from horovod_tpu_torch.run.runner import run_commandline
    return run_commandline(["--fault-spec", spec] + hvdrun_args)


if __name__ == "__main__":
    import sys

    sys.exit(main())
