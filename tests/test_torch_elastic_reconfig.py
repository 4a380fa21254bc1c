"""Elastic reconfiguration of the port (``horovod_tpu_torch``) end to
end, on gloo ranks started as the launcher starts them
(``tests/torch_fault_ranks.py::spawn``: the port's rendezvous KV, a job
key, no kill fan-out), with the JAX tests' windows (heartbeat 0.25 s,
liveness 2 s, abort deadline 10 s).  The port of
``tests/test_elastic.py:285-568`` and ``tests/test_coord_failover.py:
392-479``:

- a 4-rank job loses rank 2 inside its third collective under
  ``HVD_TPU_ELASTIC=1``; the survivors re-form at 3 ranks, roll back to
  the last commit and finish with parameters bitwise equal to each
  other, to an uninterrupted 3-rank run of the port and to the JAX
  eager plane's result of the same integer schedule over 3 ranks; on the
  eager plane (the JAX test's schedule) and under
  ``DistributedOptimizer``;
- the same loss with a live ``[0, 1]`` group and a doomed ``[2, 3]``
  group: the first lives on at its workers' new ranks, the second
  raises the typed ``GroupUnsatisfiableError``;
- a late joiner (``elastic.wait_for_membership``) admitted at the
  reconfiguration converges to the incumbents' parameters;
- a drain (the ``preempt`` action's SIGTERM): that rank's ``run``
  returns ``DRAINED`` and it exits 0, the others re-form at 3 with no
  abort anywhere;
- rank 0's loss under ``HVD_TPU_COORD_FAILOVER``: the survivors elect,
  one proposal wins the CAS, and worker 1 becomes rank 0 and hosts the
  coordinator and the store;
- what stays a typed ``HvdAbortedError`` everywhere: rank 0's loss
  without fail-over, any loss with elastic off, a loss below
  ``--min-ranks``;
- ZeRO (``ZeroDistributedOptimizer``, Adam, 1000 parameters, sharded at
  ``min_size`` 1): the survivors reshard the committed full state at 3
  (blocks 334/333/333) and finish bitwise as the port's uninterrupted
  3-rank run (the JAX package's counterpart,
  ``test_elastic_zero_reshards_optimizer_state_and_converges_bitwise``,
  fails on its own tree, so the port is held to itself).
"""

import hashlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_fault_ranks  # noqa: E402

EL_ENV = {**torch_fault_ranks.FT_ENV,
          "HVD_TPU_LIVENESS_TIMEOUT": "2",
          "HVD_TPU_RECONFIG_TIMEOUT": "60",
          "HVD_STALL_SHUTDOWN_TIME_SECONDS": "30"}
ELASTIC = {**EL_ENV, "HVD_TPU_ELASTIC": "1"}
STEPS, N = 6, 1000

WORKER = r"""
import hashlib, os
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import groups

wid = int(os.environ["HVD_RANK"])
steps = int(os.environ.get("EL_STEPS", "6"))
torch.set_num_threads(1)
if wid >= int(os.environ["HVD_SIZE"]):
    # started outside the initial gang: a late joiner
    hvd.elastic.wait_for_membership(timeout=60, device="cpu")
else:
    hvd.init(device="cpu")


def eager():
    w = torch.zeros(1000)
    state = hvd.elastic.State(params={"w": w}, step=0)

    def train(state):
        while state.step < steps:
            # integer-valued and the same on every rank: the average is
            # exact at any world size, so the result does not depend on
            # the membership's history
            grad = torch.full((1000,), float(state.step + 1))
            avg = hvd.allreduce(grad, op=hvd.Average,
                                name=f"elastic.grad.{state.step}")
            w.sub_(avg)
            state.step += 1
            state.commit()
    return state, train, [w]


def do():
    w = torch.nn.Parameter(torch.zeros(1000))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   named_parameters=[("w", w)])
    state = hvd.elastic.State(params={"w": w}, optimizer_state=opt, step=0)

    def train(state):
        while state.step < steps:
            opt.zero_grad()
            (w * float(state.step + 1)).sum().backward()
            opt.step()
            state.step += 1
            state.commit()
    return state, train, [w.detach()]


def group():
    # made once, before any failure: the registry records worker ids,
    # so the reconfiguration re-forms them, or fails them typed
    g01 = hvd.new_group([0, 1], name="el.g01")
    g_dead = hvd.new_group([2, 3], name="el.gdead") \
        if hvd.size() >= 4 else None
    w, v = torch.zeros(1000), torch.zeros(500)
    state = hvd.elastic.State(params={"w": w, "v": v}, step=0)
    checked = []

    def train(state):
        while state.step < steps:
            if g_dead is not None and hvd.size() == 3 and not checked:
                assert g01.ranks == [0, 1], g01.ranks
                try:
                    g_dead.ranks
                    raise SystemExit("g_dead must be unsatisfiable")
                except hvd.GroupUnsatisfiableError:
                    pass
                checked.append(1)
                print(f"wid {wid} GROUPS_REFORMED_OK", flush=True)
            avg = hvd.allreduce(torch.full((1000,), float(state.step + 1)),
                                op=hvd.Average,
                                name=f"elastic.grad.{state.step}")
            # the group computes, the world consumes: rank 0, a member
            # at every epoch, broadcasts the group's result
            if hvd.rank() in g01:
                gavg = hvd.allreduce(
                    torch.full((500,), float(state.step + 2)),
                    op=hvd.Average, name=f"elastic.g.{state.step}",
                    group=g01)
            else:
                gavg = torch.zeros(500)
            gavg = hvd.broadcast(gavg, root_rank=0,
                                 name=f"elastic.gb.{state.step}")
            w.sub_(avg)
            v.sub_(gavg)
            state.step += 1
            state.commit()
    return state, train, [w, v]


def zero():
    w = torch.nn.Parameter(torch.zeros(1000))
    opt = hvd.ZeroDistributedOptimizer(torch.optim.Adam([w], lr=0.1),
                                       min_size=1)
    state = hvd.elastic.State(params={"w": w}, optimizer_state=opt,
                              step=0, zero_n_params=1000)

    def train(state):
        while state.step < steps:
            # integer-valued, rank-identical gradients: the reduce-scatter
            # average is exact and Adam is elementwise, so the result
            # does not depend on which rank owned which block
            w.grad = torch.full((1000,), float(state.step + 1))
            opt.step()
            state.step += 1
            state.commit()
    return state, train, [w.detach()]


for mode in os.environ["EL_MODES"].split(","):
    state, train, outs = globals()[mode]()
    try:
        result = hvd.elastic.run(train, state)
    except hvd.HvdAbortedError as exc:
        print(f"wid {wid} ABORTED origin={exc.origin_rank} "
              f"type={type(exc).__name__}", flush=True)
        raise SystemExit(0)
    if result is hvd.elastic.DRAINED:
        print(f"wid {wid} DRAINED", flush=True)
        raise SystemExit(0)
    digest = hashlib.sha1(b"".join(
        t.numpy().tobytes() for t in outs)).hexdigest()
    extra = ""
    if mode == "zero":
        extra = f" shard={state.optimizer_state.shard.numel()}"
    print(f"mode {mode} rank {hvd.rank()} wid {wid} DIGEST={digest} "
          f"size={hvd.size()} steps={state.step} "
          f"epoch={hvd.elastic.basics._get_state().epoch}{extra}",
          flush=True)
hvd.shutdown()
print(f"wid {wid} DONE", flush=True)
"""


def _run(n, env, modes, world_size=None, timeout=90):
    return torch_fault_ranks.spawn(
        n, WORKER, extra_env={**env, "EL_MODES": ",".join(modes)},
        timeout=timeout, world_size=world_size)


def _fields(line):
    return dict(kv.split("=", 1) for kv in line.split() if "=" in kv)


def _digests(results, ranks, mode):
    out = {}
    for r in ranks:
        code, stdout, stderr = results[r]
        assert code == 0, f"rank {r}: {stdout}\n{stderr}"
        line = next((ln for ln in stdout.splitlines()
                     if ln.startswith(f"mode {mode} ")), None)
        assert line is not None, f"rank {r}: {stdout}\n{stderr}"
        out[r] = {**_fields(line), "rank": line.split()[3]}
    return out


@pytest.fixture(scope="module")
def uninterrupted():
    """The port's uninterrupted 3-rank run of every schedule, one job."""
    modes = ("eager", "do", "group", "zero")
    res = _run(3, EL_ENV, modes)
    return {m: _digests(res, range(3), m) for m in modes}


def _jax_integer_schedule(world=3):
    """The JAX eager plane's result of the workers' integer schedule over
    ``world`` of its device ranks (a group of them)."""
    import jax.numpy as jnp

    import horovod_tpu as jhvd
    from horovod_tpu.common import basics as jbasics

    if not jhvd.is_initialized():
        jhvd.init()
    g = jhvd.new_group(list(range(world)), name="torch_elastic.int")

    def rank_fn(r):
        if r >= world:
            return None
        w = jnp.zeros((N,), jnp.float32)
        for step in range(STEPS):
            avg = jhvd.allreduce(jnp.full((N,), float(step + 1),
                                          jnp.float32),
                                 op=jhvd.Average, group=g,
                                 name=f"torch_elastic.int.{step}")
            w = w - avg
        return np.asarray(w)

    return jbasics.run_parallel(rank_fn)[:world]


@pytest.mark.parametrize("mode", ["eager", "do"])
def test_rank_loss_reforms_and_converges_bitwise(mode, uninterrupted):
    res = _run(4, {**ELASTIC,
                   "HVD_TPU_FAULT_SPEC": "rank2:allreduce:3:crash"}, [mode])
    assert res[2][0] == 1, f"injected crash: {res[2][1]}{res[2][2]}"
    got = _digests(res, (0, 1, 3), mode)
    for r, f in got.items():
        assert (f["size"], f["steps"], f["epoch"]) == ("3", "6", "1"), f
    assert len({f["DIGEST"] for f in got.values()}) == 1, got
    assert got[0]["DIGEST"] == uninterrupted[mode][0]["DIGEST"]
    for w in _jax_integer_schedule():
        assert hashlib.sha1(w.astype(np.float32).tobytes()).hexdigest() \
            == got[0]["DIGEST"]


def test_rank_loss_reforms_groups_and_fails_the_doomed_one(uninterrupted):
    res = _run(4, {**ELASTIC,
                   "HVD_TPU_FAULT_SPEC": "rank2:allreduce:3:crash"},
               ["group"])
    assert res[2][0] == 1
    got = _digests(res, (0, 1, 3), "group")
    for r, f in got.items():
        assert (f["size"], f["steps"]) == ("3", "6"), f
        assert "GROUPS_REFORMED_OK" in res[r][1], res[r][1]
    assert len({f["DIGEST"] for f in got.values()}) == 1, got
    assert got[0]["DIGEST"] == uninterrupted["group"][0]["DIGEST"]


def test_late_joiner_is_admitted_and_converges(uninterrupted):
    res = _run(5, {**ELASTIC,
                   "HVD_TPU_FAULT_SPEC": "rank2:allreduce:3:crash"},
               ["eager"], world_size=4)
    assert res[2][0] == 1
    got = _digests(res, (0, 1, 3, 4), "eager")
    for r, f in got.items():
        assert (f["size"], f["steps"], f["epoch"]) == ("4", "6", "1"), f
    # the joiner is worker 4 at rank 3 of [0, 1, 3, 4]
    assert got[4]["rank"] == "3"
    assert len({f["DIGEST"] for f in got.values()}) == 1, got
    assert got[0]["DIGEST"] == uninterrupted["eager"][0]["DIGEST"]


def test_drain_returns_drained_and_nobody_aborts(uninterrupted):
    res = _run(4, {**ELASTIC,
                   "HVD_TPU_FAULT_SPEC": "rank2:allreduce:3:preempt"},
               ["eager"])
    code, out, err = res[2]
    assert code == 0 and "wid 2 DRAINED" in out, f"{out}\n{err}"
    for r in range(4):
        assert "ABORTED" not in res[r][1], res[r][1]
        assert "HvdAbortedError" not in res[r][2], res[r][2]
    got = _digests(res, (0, 1, 3), "eager")
    for f in got.values():
        assert (f["size"], f["steps"]) == ("3", "6"), f
    assert got[0]["DIGEST"] == uninterrupted["eager"][0]["DIGEST"]


def test_rank0_loss_elects_a_new_coordinator(uninterrupted):
    res = _run(4, {**ELASTIC, "HVD_TPU_COORD_FAILOVER": "1",
                   "HVD_TPU_FAULT_SPEC": "rank0:allreduce:3:crash"},
               ["eager"])
    assert res[0][0] == 1
    got = _digests(res, (1, 2, 3), "eager")
    # worker 1 is rank 0: it hosts the coordinator and the store
    assert [got[w]["rank"] for w in (1, 2, 3)] == ["0", "1", "2"]
    for f in got.values():
        assert (f["size"], f["steps"], f["epoch"]) == ("3", "6", "1"), f
    assert got[1]["DIGEST"] == uninterrupted["eager"][0]["DIGEST"]
    # one survivor won the CAS, the others adopted its directive
    evidence = "".join(res[r][2] for r in (1, 2, 3))
    assert evidence.count("won the epoch-0 election") == 1, evidence
    assert evidence.count("adopted the epoch-0 election result") == 2


@pytest.mark.parametrize("case,env,dead", [
    ("rank0_unarmed", {**ELASTIC, "HVD_TPU_FAULT_SPEC":
                       "rank0:allreduce:3:crash"}, 0),
    ("elastic_off", {**EL_ENV, "HVD_TPU_FAULT_SPEC":
                     "rank2:allreduce:3:crash"}, 2),
    ("below_min_ranks", {**ELASTIC, "HVD_TPU_MIN_RANKS": "4",
                         "HVD_TPU_FAULT_SPEC": "rank2:allreduce:3:crash"},
     2)])
def test_unsurvivable_loss_stays_a_typed_abort(case, env, dead):
    res = _run(4, env, ["eager"])
    assert res[dead][0] == 1
    for r in set(range(4)) - {dead}:
        code, out, err = res[r]
        assert code == 0, f"rank {r}: {out}\n{err}"
        assert f"wid {r} ABORTED origin={dead} type=HvdAbortedError" \
            in out, f"rank {r}: {out}\n{err}"
        assert "DIGEST=" not in out and "fail-over" not in err


def test_zero_reshards_at_the_new_size_and_converges(uninterrupted):
    res = _run(4, {**ELASTIC,
                   "HVD_TPU_FAULT_SPEC": "rank2:reduce_scatter:3:crash"},
               ["zero"])
    assert res[2][0] == 1
    got = _digests(res, (0, 1, 3), "zero")
    assert [got[w]["shard"] for w in (0, 1, 3)] == ["334", "333", "333"]
    for f in got.values():
        assert (f["size"], f["steps"]) == ("3", "6"), f
    assert len({f["DIGEST"] for f in got.values()}) == 1, got
    assert got[0]["DIGEST"] == uninterrupted["zero"][0]["DIGEST"]
