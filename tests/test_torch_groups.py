"""The port's process groups (``horovod_tpu_torch/groups``, ``group=`` on
the eager plane and on ZeRO) against the JAX package's
(``horovod_tpu/groups``, its eager plane and ``sharding/zero.py``).

4 and 8 gloo ranks run in subprocesses (rendezvous through a
``FileStore``, each world size launched once, ``WORKER``); the JAX side
runs the same calls in its device-rank mode (8 ranks,
``basics.run_parallel``; initialised as the session ``hvd`` fixture
does, see ``jax_hvd``), group creation in a fresh thread so that its
per-thread auto-name counters start at 0 as the port's do.

- The handle API (ranks, size, rank, membership, repr, the deterministic
  id), the auto-names, the cap on live groups and the error texts equal
  the JAX ones; ``reform`` to a rotated membership maps the groups'
  worker ids to their new ranks (and turns a grid whose shape no longer
  fits typed-unsatisfiable) as the JAX ``reform`` does, and back.
- ``hvd.grid(dp=2, tp=2, pp=2)`` at 8 ranks: axes, coords, every group's
  name, id and ranks, and the error texts, equal the JAX grid's.
- ``group=`` on allreduce, broadcast, allgather, grouped_allgather,
  alltoall, reduce_scatter and barrier at 4 ranks over ``[0, 2]`` equal
  the JAX eager plane's results over the same group (members' inputs
  depend on their rank only); two disjoint groups and the world reduce
  the same name three times each, and ``max_concurrent_groups >= 2``; a
  non-member's call raises the JAX text; the group id is part of the
  fusion bucket key.
- ``ZeroDistributedOptimizer(group=dp)`` on ``hvd.grid(dp=2, tp=2)``,
  three AdamW steps, against the JAX ``ZeroDistributedOptimizer`` on the
  same dp groups, 1e-6 absolute (``tests/test_torch_sharding.py``).
- The port of ``tests/test_groups.py::test_zero_dp_tp_pp_transformer_blocks_train``
  at 8 ranks, ZeRO over dp, tp partial sums and pp hand-offs from one
  ``hvd.grid(dp=2, tp=2, pp=2)``, against that test's replicated numpy
  oracle (rtol 1e-5, atol 1e-6), dp replicas bitwise equal.
"""

import os
import pickle
import re
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from horovod_tpu.common import basics as jax_basics
from horovod_tpu.ops.python_controller import PythonController
from horovod_tpu.sharding import zero as jz

from horovod_tpu_torch.ops.controller import Signature, allreduce_bucket_key
from horovod_tpu_torch.common.ops_enum import RequestType

from test_groups import _batch, _block_params, _oracle_3d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD, STEPS = 1e-3, 1e-4, 3
ZERO_SHAPES = {"b": (5, 3), "w": (36,)}     # 51: no dp size divides it

# calls made on both sides: ``hvd`` is the package, ``T`` its tensors
CASES = textwrap.dedent('''
    import numpy as np


    def data(shape, seed):
        return np.asarray(np.random.RandomState(seed).randn(*shape),
                          dtype=np.float32)


    def err(fn):
        try:
            fn()
        except Exception as exc:
            return type(exc).__name__, str(exc)
        return None


    def collectives(hvd, r, T, ga):
        """Rank r's results over ``ga`` = ranks [0, 2]."""
        i = ga.rank(r)
        out = {}
        out["avg"] = T.np(hvd.allreduce(T.arr(data((4,), r)),
                                        name="g.avg", group=ga))
        out["sum"] = T.np(hvd.allreduce(T.arr(data((3, 2), 10 + r)),
                                        op=hvd.Sum, name="g.sum", group=ga))
        out["bc"] = T.np(hvd.broadcast(T.arr(data((3,), 20 + r)),
                                       root_rank=2, name="g.bc", group=ga))
        out["ag"] = T.np(hvd.allgather(T.arr(data((i + 1, 2), 30 + r)),
                                       name="g.ag", group=ga))
        out["gag"] = [T.np(t) for t in hvd.grouped_allgather(
            [T.arr(data((2,), 40 + r)), T.arr(data((1, 3), 50 + r))],
            name="g.gag", group=ga)]
        out["a2a"] = T.np(hvd.alltoall(T.arr(data((4, 2), 60 + r)),
                                       name="g.a2a", group=ga))
        out["rs"] = T.np(hvd.reduce_scatter(T.arr(data((5, 2), 70 + r)),
                                            op=hvd.Sum, name="g.rs",
                                            group=ga))
        hvd.barrier(group=ga, name="g.bar")
        return out
''')

WORKER = CASES + textwrap.dedent('''
    import os
    import pickle
    import sys

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import groups


    class T:
        @staticmethod
        def arr(x):
            return torch.from_numpy(np.array(x))

        @staticmethod
        def np(x):
            return x.detach().numpy()


    data_path, store, out_path = sys.argv[1:4]
    inputs = np.load(data_path, allow_pickle=True)
    torch.set_num_threads(1)
    hvd.init(device="cpu", store_path=store)
    r, n = hvd.rank(), hvd.size()
    out = {}

    def grid_table(grd):
        return {"axes": grd.axes, "mesh_axes": grd.mesh_axes(),
                "coords": [grd.coords(q) for q in range(n)],
                "groups": [{a: (grd.group(a, q).name, grd.group(a, q).gid,
                                grd.group(a, q).ranks) for a in grd.axes}
                           for q in range(n)]}

    if n == 4:
        g = hvd.new_group([1, 3], name="odd")
        out["api"] = {"ranks": g.ranks, "size": g.size, "rank3": g.rank(3),
                      "rank0": g.rank(0), "in": (3 in g, 0 in g),
                      "repr": repr(g), "gid": g.gid,
                      "auto": [hvd.new_group([0, 1]).name for _ in range(2)]}
        out["errors"] = {
            "empty": err(lambda: hvd.new_group([])),
            "range": err(lambda: hvd.new_group([0, n])),
            "resolve": err(lambda: groups.resolve("not-a-group"))}
        # every rank re-forms, in the same order: a rotated membership,
        # then the identity again (the torch groups are made anew each
        # time)
        groups.reform([1, 2, 3, 0])
        out["reform"] = {"odd": g.ranks, "auto": hvd.new_group(
            [0, 1], name="group.0-1.0").ranks}
        groups.reform([1, 2, 3])
        out["reform"]["three"] = err(lambda: g.ranks)
        groups.reform([0, 1, 2, 3])
        out["reform"]["back"] = g.ranks
        os.environ["HVD_TPU_GROUP_MAX"] = str(len(groups._live))
        out["cap_same"] = hvd.new_group([1, 3], name="odd").size
        out["errors"]["cap"] = err(lambda: hvd.new_group([0, 1],
                                                          name="cap"))
        del os.environ["HVD_TPU_GROUP_MAX"]

        lo = hvd.new_group([0, 1], name="iso.lo")
        hi = hvd.new_group([2, 3], name="iso.hi")
        mine = lo if r < 2 else hi
        rounds = []
        for round_ in range(3):
            hs = [hvd.allreduce_async(torch.full((5,), float(r + 1)),
                                      op=hvd.Sum, name=f"iso.{round_}",
                                      group=mine),
                  hvd.allreduce_async(torch.full((5,), float(r + 1)),
                                      op=hvd.Sum, name=f"iso.{round_}")]
            rounds.append([hvd.synchronize(h).numpy() for h in hs])
        out["iso"] = rounds
        out["stats"] = groups.stats()

        ga = hvd.new_group([0, 2], name="even")
        if r % 2 == 0:
            out["coll"] = collectives(hvd, r, T, ga)
        else:
            out["nonmember"] = err(lambda: hvd.allreduce(
                torch.ones(2), name="g.bad", group=ga))

        grd = hvd.grid(dp=2, tp=2)
        dp_g = grd.group("dp")
        zp = inputs["zero_params"].item()
        params = [torch.nn.Parameter(torch.from_numpy(np.array(zp[k])))
                  for k in sorted(zp)]
        opt = hvd.ZeroDistributedOptimizer(
            torch.optim.AdamW(params, lr=float(inputs["lr"]),
                              weight_decay=float(inputs["wd"])),
            min_size=1, group=dp_g)
        steps = []
        for grads in inputs["zero_grads"][r]:
            for p, k in zip(params, sorted(zp)):
                p.grad = torch.from_numpy(np.array(grads[k]))
            opt.step()
            steps.append([p.detach().numpy().copy() for p in params])
        out["zero"] = {"steps": steps, "state": opt.state[
            next(iter(opt.state))]["exp_avg"].numel(),
            "dp_ranks": dp_g.ranks}
    else:
        out["grid"] = grid_table(hvd.grid(dp=2, tp=2, pp=2))
        out["grid_errors"] = [err(lambda: hvd.grid(dp=3, tp=2)),
                              err(lambda: hvd.grid())]

        # tests/test_groups.py::test_zero_dp_tp_pp_transformer_blocks_train
        lr = float(inputs["lr3d"])
        blocks, batches = inputs["blocks"].item(), inputs["batches"].item()
        grd = hvd.grid(dp=2, tp=2, pp=2)
        dp, tp, pp = grd.coords(r)
        dp_g, tp_g, pp_g = grd.group("dp"), grd.group("tp"), grd.group("pp")
        assert (dp_g.rank(), tp_g.rank(), pp_g.rank()) == (dp, tp, pp)
        peer = {m for m in pp_g.ranks if m != r}.pop()
        A, B = (torch.nn.Parameter(torch.from_numpy(
            np.array(blocks[(pp, tp)][k]))) for k in ("A", "B"))
        opt = hvd.ZeroDistributedOptimizer(torch.optim.SGD([A, B], lr=lr),
                                           min_size=1, group=dp_g)
        losses = []
        width = A.shape[0]
        for step in range(int(inputs["steps3d"])):
            x, target = (torch.from_numpy(np.array(a))
                         for a in batches[(dp, step)])
            tag = f"p3d.{step}"
            with torch.no_grad():
                if pp == 0:
                    x_in = x
                    h = torch.tanh(x_in @ A)
                    y0 = hvd.allreduce(h @ B, op=hvd.Sum, name=f"{tag}.fwd",
                                       group=tp_g)
                    hvd.broadcast(y0, root_rank=r, name=f"{tag}.act",
                                  group=pp_g)
                    dy = hvd.broadcast(torch.zeros(x.shape[0], width),
                                       root_rank=peer, name=f"{tag}.gact",
                                       group=pp_g)
                else:
                    x_in = hvd.broadcast(torch.zeros(x.shape[0], width),
                                         root_rank=peer, name=f"{tag}.act",
                                         group=pp_g)
                    h = torch.tanh(x_in @ A)
                    y1 = hvd.allreduce(h @ B, op=hvd.Sum, name=f"{tag}.fwd",
                                       group=tp_g)
                    losses.append(float(((y1 - target) ** 2).mean()))
                    dy = 2.0 * (y1 - target) / y1.numel()
                gB = h.T @ dy
                dpre = (dy @ B.T) * (1 - h ** 2)
                gA = x_in.T @ dpre
                if pp == 1:
                    dx = hvd.allreduce(dpre @ A.T, op=hvd.Sum,
                                       name=f"{tag}.bwd", group=tp_g)
                    hvd.broadcast(dx, root_rank=r, name=f"{tag}.gact",
                                  group=pp_g)
            A.grad, B.grad = gA, gB
            opt.step()
        out["3d"] = {"dp": dp, "tp": tp, "pp": pp, "losses": losses,
                     "A": A.detach().numpy(), "B": B.detach().numpy(),
                     "stats": groups.stats()}
    hvd.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
''')


class JaxT:
    @staticmethod
    def arr(x):
        return jnp.asarray(x)

    @staticmethod
    def np(x):
        return np.asarray(x)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _room_for_groups(monkeypatch):
    """The JAX session's registry keeps the groups of every test file run
    before in this process: lift its cap for the groups made here."""
    monkeypatch.setenv("HVD_TPU_GROUP_MAX", "100000")


@pytest.fixture(scope="session")
def jax_hvd():
    """The JAX package initialised as the session ``hvd`` fixture does (8
    device ranks), without setting that fixture up (see
    ``tests/test_torch_eager.py``)."""
    import horovod_tpu

    owned = not horovod_tpu.is_initialized()
    if owned:
        horovod_tpu.init()
    yield horovod_tpu
    if owned:
        horovod_tpu.shutdown()


def _in_fresh_thread(fn):
    """``fn()`` in a new thread: the JAX registry's auto-name counters are
    per thread, and a fresh one starts at 0, as a fresh port rank does."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as exc:  # noqa: BLE001 — handed to the caller
            box["err"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join(60)
    assert not t.is_alive()
    if "err" in box:
        raise box["err"]
    return box["out"]


def _err(fn):
    try:
        fn()
    except Exception as exc:
        return type(exc).__name__, str(exc)
    return None


def _zero_inputs():
    rng = np.random.RandomState(11)
    params = {k: rng.randn(*s).astype(np.float32)
              for k, s in sorted(ZERO_SHAPES.items())}
    grads = [[{k: np.random.RandomState(100 * r + s).randn(*v.shape)
               .astype(np.float32) for k, v in params.items()}
              for s in range(STEPS)] for r in range(4)]
    return params, grads


def _launch(tmp, n):
    zp, zg = _zero_inputs()
    blocks = {(s, t): {k: np.asarray(v) for k, v in
                       _block_params(s, t).items()}
              for s in range(2) for t in range(2)}
    batches = {(d, s): _batch(d, s) for d in range(2) for s in range(3)}
    np.savez(tmp / "data.npz", zero_params=np.array(zp, dtype=object),
             zero_grads=np.array(zg, dtype=object), lr=LR, wd=WD,
             blocks=np.array(blocks, dtype=object),
             batches=np.array(batches, dtype=object), lr3d=0.1, steps3d=3)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(n),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp / "data.npz"),
                 str(tmp / "store"), str(tmp / f"out{r}.pkl")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for r in range(n):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return {n: _launch(tmp_path_factory.mktemp(f"groups{n}"), n)
            for n in (4, 8)}


# ---------------------------------------------------------------- API
def test_group_handle_api_matches_jax(port_runs, jax_hvd):
    from horovod_tpu import groups as jg

    def make():
        g = jax_hvd.new_group([1, 3], name="odd")
        return {"ranks": g.ranks, "size": g.size, "rank3": g.rank(3),
                "rank0": g.rank(0), "in": (3 in g, 0 in g),
                "repr": repr(g), "gid": g.gid,
                "auto": [jax_hvd.new_group([0, 1]).name for _ in range(2)]}

    want = _in_fresh_thread(make)
    for res in port_runs[4]:
        assert res["api"] == want
        assert res["cap_same"] == 2
    errors = port_runs[4][0]["errors"]
    assert errors["empty"] == _err(lambda: jax_hvd.new_group([]))
    assert errors["resolve"] == _err(lambda: jg.resolve("not-a-group"))
    # the JAX world has 8 ranks, the port's 4
    want_range = _err(lambda: jax_hvd.new_group([0, 8]))
    assert errors["range"] == (want_range[0], want_range[1].replace(
        "[0, 8]", "[0, 4]").replace("world size 8", "world size 4"))
    kind, text = errors["cap"]
    assert kind == "HvdError" and "HVD_TPU_GROUP_MAX" in text
    # reform: the JAX groups of the same specs under the same
    # memberships (the JAX world has 8 ranks: the port's 4 then 4 more)
    def reformed():
        odd = jax_hvd.new_group([1, 3], name="odd")
        pair = jax_hvd.new_group([0, 1], name="group.0-1.0")
        jg.reform([1, 2, 3, 0, 4, 5, 6, 7])
        try:
            want = {"odd": odd.ranks, "auto": pair.ranks}
            jg.reform([1, 2, 3, 4, 5, 6, 7])
            want["three"] = odd.ranks
        finally:
            jg.reform(list(range(8)))
        want["back"] = odd.ranks
        return want

    want = _in_fresh_thread(reformed)
    for res in port_runs[4]:
        got = res["reform"]
        assert got["odd"] == want["odd"] == [0, 2]
        assert got["auto"] == want["auto"] == [0, 3]
        # worker 0 departed: the explicit group [1, 3] keeps its workers
        assert got["three"] is None and want["three"] == [0, 2]
        assert got["back"] == want["back"] == [1, 3]


def test_group_cap_text_matches_jax(port_runs, jax_hvd, monkeypatch):
    from horovod_tpu import groups as jg
    from horovod_tpu.utils import env as jax_env

    monkeypatch.setenv(jax_env.HVD_TPU_GROUP_MAX, str(len(jg._specs)))
    want = _err(lambda: jax_hvd.new_group([0, 1], name="cap.torch"))
    got = port_runs[4][0]["errors"]["cap"]
    assert got[0] == want[0]
    assert re.sub(r"\d+", "N", got[1]) == re.sub(r"\d+", "N", want[1])


def test_grid_planning_matches_jax(port_runs, jax_hvd):
    def table():
        grd = jax_hvd.grid(dp=2, tp=2, pp=2)
        return {"axes": grd.axes, "mesh_axes": grd.mesh_axes(),
                "coords": [grd.coords(q) for q in range(8)],
                "groups": [{a: (grd.group(a, q).name, grd.group(a, q).gid,
                                grd.group(a, q).ranks) for a in grd.axes}
                           for q in range(8)]}

    want = _in_fresh_thread(table)
    for res in port_runs[8]:
        assert res["grid"] == want
        assert res["grid_errors"] == [
            _err(lambda: jax_hvd.grid(dp=3, tp=2)),
            _err(lambda: jax_hvd.grid())]


# ------------------------------------------------------- eager group=
@pytest.fixture(scope="module")
def jax_collectives(jax_hvd):
    ns = {}
    exec(CASES, ns)
    ga = jax_hvd.new_group([0, 2], name="torch.even")

    def fn(r):
        if r not in (0, 2):
            return {"nonmember": _err(lambda: jax_hvd.allreduce(
                jnp.ones(2), name="g.bad", group=ga))} if r == 1 else None
        return {"coll": ns["collectives"](jax_hvd, r, JaxT, ga)}

    return jax_basics.run_parallel(fn)


@pytest.mark.parametrize("op", ["avg", "sum", "bc", "ag", "gag", "a2a",
                                "rs"])
def test_group_collectives_match_jax_eager(port_runs, jax_collectives, op):
    for r in (0, 2):
        got, want = port_runs[4][r]["coll"][op], jax_collectives[r]["coll"][op]
        if op == "gag":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            assert got.shape == want.shape, op
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_non_member_text_matches_jax(port_runs, jax_collectives):
    got = port_runs[4][1]["nonmember"]
    want = jax_collectives[1]["nonmember"]
    assert got[0] == want[0] == "ValueError"
    # the JAX group's name is "torch.even", the port's "even"
    assert got[1] == want[1].replace("'torch.even'", "'even'")


def test_disjoint_groups_isolated_and_concurrently_in_flight(port_runs):
    for r, res in enumerate(port_runs[4]):
        base = 0 if r < 2 else 2
        for g, w in res["iso"]:
            np.testing.assert_array_equal(
                g, np.full(5, float(base + 1 + base + 2), np.float32))
            np.testing.assert_array_equal(w, np.full(5, 10.0, np.float32))
        assert res["stats"]["max_concurrent_groups"] >= 2


def test_group_joins_fusion_bucket_key():
    sig = Signature(req_type=RequestType.ALLREDUCE, dtype="float32",
                    shape=(4,))
    keys = {allreduce_bucket_key(sig._replace(group=g))
            for g in ("", "aaaa", "bbbb")}
    assert len(keys) == 3
    base = dict(dtype="float32", op=1, prescale=1.0, postscale=1.0)
    assert len({PythonController.allreduce_bucket_key(**base, group=g)
                for g in ("", "aaaa", "bbbb")}) == 3


# --------------------------------------------------------------- ZeRO
def test_zero_over_the_dp_group_matches_jax(port_runs, jax_hvd):
    """``grid(dp=2, tp=2)``'s dp groups are ranks {0, 2} and {1, 3}: the
    JAX side runs its ZeRO over new groups of the same ranks."""
    params, grads = _zero_inputs()
    dp_groups = {0: jax_hvd.new_group([0, 2], name="torch.zero.dp0"),
                 1: jax_hvd.new_group([1, 3], name="torch.zero.dp1")}

    def fn(r):
        if r >= 4:
            return None
        opt = jz.ZeroDistributedOptimizer(
            optax.adamw(LR, weight_decay=WD), min_size=1,
            group=dp_groups[r % 2])
        p = jax.tree.map(jnp.asarray, params)
        st = opt.init(p)
        out = []
        for s in range(STEPS):
            u, st = opt.update(jax.tree.map(jnp.asarray, grads[r][s]), st, p)
            p = optax.apply_updates(p, u)
            out.append([np.asarray(p[k]) for k in sorted(params)])
        return out

    want = jax_basics.run_parallel(fn)
    for r, res in enumerate(port_runs[4]):
        assert res["zero"]["dp_ranks"] == [r % 2, r % 2 + 2]
        assert res["zero"]["state"] in (25, 26)   # 51 over 2 ranks
        for got_step, want_step in zip(res["zero"]["steps"], want[r]):
            for g, w in zip(got_step, want_step):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_zero_dp_tp_pp_transformer_blocks_train(port_runs):
    """``tests/test_groups.py``'s acceptance scenario on the port: each
    rank one stage's one tensor shard, tp partial sums allreduced in the
    tp group, activations and their gradients handed over by pp-group
    broadcasts, ZeRO over the dp group; against the replicated oracle."""
    oracle, oracle_losses = _oracle_3d()
    results = [res["3d"] for res in port_runs[8]]
    for out in results:
        s, t = out["pp"], out["tp"]
        np.testing.assert_allclose(
            out["A"], oracle[s]["A"][:, t * 4:(t + 1) * 4],
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            out["B"], oracle[s]["B"][t * 4:(t + 1) * 4, :],
            rtol=1e-5, atol=1e-6)
        if out["pp"] == 1:
            np.testing.assert_allclose(
                out["losses"], [ls[out["dp"]] for ls in oracle_losses],
                rtol=1e-5)
        assert out["stats"]["max_concurrent_groups"] >= 2
    by_cell = {}
    for out in results:
        by_cell.setdefault((out["tp"], out["pp"]), []).append(out)
    for cell, outs in by_cell.items():
        assert len(outs) == 2
        assert outs[0]["A"].tobytes() == outs[1]["A"].tobytes(), cell
        assert outs[0]["B"].tobytes() == outs[1]["B"].tobytes(), cell
