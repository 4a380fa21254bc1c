"""The port's ZeRO-1 (``horovod_tpu_torch/sharding/zero.py``) against the
JAX package's (``horovod_tpu/sharding/zero.py``).

- The layouts (``shard_chunk_size``, ``zero_shard_layout``,
  ``flat_shard``) equal the JAX ones over a grid of sizes and world sizes.
- On 2 and 4 gloo ranks (subprocesses, rendezvous through a
  ``FileStore``, each world size launched once for all its cases), three
  AdamW steps on per-rank gradients made with numpy from seeds:
  ``ShardedDistributedOptimizer`` is held to the JAX one under
  ``shard_map`` on as many CPU devices, ``ZeroDistributedOptimizer`` to
  the JAX one on the JAX eager plane (8 device ranks, the first 2 or 4
  of them in a process group, as ``tests/test_groups.py`` runs it), at
  51 parameters (which neither world size divides) and at 677 with int8.
  Tolerance: 1e-6 absolute, that of ``tests/test_sharding.py`` against
  the replicated update; the replicated update (``optax.adamw`` on the
  mean gradient) is held to it too.
- The ``min_size`` fallback keeps full-size state; at one rank the
  update is the replicated one.
- ``gather_zero_state`` then ``reshard_zero_state`` give each rank's
  state back bitwise; the state gathered at 2 ranks, resharded at 4,
  takes a fourth step that matches the replicated update.
- Adasum, and a ``group=`` that is no ``ProcessGroup``, are refused with
  the reference's words, as are parameter groups with different
  hyperparameters; a negative
  ``HVD_TPU_ZERO_MIN_SIZE`` raises in ``hvd.init``.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.common import basics as jax_basics
from horovod_tpu.parallel import make_mesh
from horovod_tpu.parallel._compat import shard_map_unchecked
from horovod_tpu.sharding import zero as jz

import horovod_tpu_torch as hvd
from horovod_tpu_torch.sharding import zero as tz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD, STEPS = 1e-3, 1e-4, 3
# leaves in ravel_pytree's (sorted) order, so the flat vectors agree
SHAPES = {"small": {"b": (5, 3), "w": (36,)},      # 51: no world divides
          "big": {"b": (7, 11), "w": (600,)}}      # 677, int8
# case -> (parameters, wrapper, keyword arguments)
CASES = {"sharded": ("small", "sharded", {}),
         "sharded_int8": ("big", "sharded", {"compression": "int8"}),
         "zero": ("small", "zero", {"min_size": 1}),
         "zero_int8": ("big", "zero", {"min_size": 1,
                                       "compression": "int8"}),
         "zero_fallback": ("small", "zero", {"min_size": 10_000})}
MAX_RANKS = 4


def _params(kind):
    rng = np.random.RandomState(len(kind))
    return {k: rng.randn(*s).astype(np.float32)
            for k, s in SHAPES[kind].items()}


def _grads(kind, n_steps=STEPS, seed=0):
    """[rank][step] -> {leaf: gradient}."""
    return [[{k: np.random.RandomState(seed + 100 * r + 10 * s + i)
              .randn(*shape).astype(np.float32)
              for i, (k, shape) in enumerate(SHAPES[kind].items())}
             for s in range(n_steps)] for r in range(MAX_RANKS)]


WORKER = textwrap.dedent('''
    import pickle
    import sys

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.compression import Compression

    data_path, store_path, out_path = sys.argv[1:4]
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    torch.set_num_threads(1)
    hvd.init(device="cpu", store_path=store_path)
    r, n = hvd.rank(), hvd.size()

    def make(kind, params):
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
              for v in params[kind].values()]
        return ps, torch.optim.AdamW(ps, lr=data["lr"],
                                     weight_decay=data["wd"])

    def wrap(how, base, kw):
        if how == "sharded":
            comp = Compression.int8 if kw.get("compression") else \\
                Compression.none
            return hvd.ShardedDistributedOptimizer(base, compression=comp)
        return hvd.ZeroDistributedOptimizer(base, **kw)

    def take(opt, ps, grads):
        for p, g in zip(ps, grads.values()):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        return [p.detach().numpy().copy() for p in ps]

    out = {}
    for case, (kind, how, kw) in data["cases"].items():
        ps, base = make(kind, data["params"])
        opt = wrap(how, base, kw)
        steps = [take(opt, ps, data["grads"][kind][r][s])
                 for s in range(data["steps"])]
        state = opt.state_dict()
        lens = sorted(int(v.numel()) for v in state["state"][0].values()
                      if v.dim() == 1)
        res = {"steps": steps, "lens": lens}
        if how == "zero":
            full = hvd.gather_zero_state(state, opt.n_params)
            back = hvd.reshard_zero_state(full, opt.n_params)
            res["roundtrip"] = all(
                torch.equal(a, b) for a, b in zip(
                    state["state"][0].values(), back["state"][0].values()))
            res["full"] = full
        out[case] = res

    if n == 4:
        # resume at 4 ranks from the state gathered at 2
        saved = data["resume"]
        ps, base = make("small", {"small": saved["params"]})
        opt = hvd.ZeroDistributedOptimizer(base, min_size=1)
        state = hvd.reshard_zero_state(saved["full"], opt.n_params)
        opt.load_state_dict(state)
        out["resume"] = {
            "blocks": [v.numpy().copy() for v in state["state"][0].values()
                       if v.dim() == 1],
            "params": take(opt, ps, data["grads"]["resume"][r][0])}
    hvd.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
''')


def _launch(tmp, n, resume=None):
    data = {"lr": LR, "wd": WD, "steps": STEPS, "cases": CASES,
            "params": {k: _params(k) for k in SHAPES},
            "grads": {"small": _grads("small"), "big": _grads("big"),
                      "resume": _grads("small", 1, seed=7)},
            "resume": resume}
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(n),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp / "data.pkl"),
                 str(tmp / "store"), str(tmp / f"out{r}.pkl")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            log, _ = p.communicate(timeout=120)
            assert p.returncode == 0, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = []
    for r in range(n):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    two = _launch(tmp_path_factory.mktemp("zero2"), 2)
    resume = {"full": two[0]["zero"]["full"],
              "params": dict(zip(SHAPES["small"],
                                 two[0]["zero"]["steps"][-1]))}
    four = _launch(tmp_path_factory.mktemp("zero4"), 4, resume)
    return {2: two, 4: four}


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


def _adamw():
    return optax.adamw(LR, weight_decay=WD)


def _jax_sharded(kind, n, compression):
    mesh = make_mesh({"hvd": n}, devices=jax.devices()[:n])
    comp = getattr(jz.Compression, compression or "none")
    opt = jz.ShardedDistributedOptimizer(_adamw(), axis_name="hvd",
                                         compression=comp)
    params = jax.tree.map(jnp.asarray, _params(kind))
    grads = _grads(kind)[:n]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *[
        jax.tree.map(lambda *s: jnp.stack(s), *steps) for steps in grads])

    def run(p, g):
        g = jax.tree.map(lambda a: a[0], g)
        st = opt.init(p)
        out = []
        for s in range(STEPS):
            u, st = opt.update(jax.tree.map(lambda a: a[s], g), st, p)
            p = optax.apply_updates(p, u)
            out.append(p)
        return out

    fn = jax.jit(shard_map_unchecked(run, mesh=mesh, in_specs=(P(), P("hvd")),
                                     out_specs=P()))
    return [[np.asarray(p[k]) for k in SHAPES[kind]]
            for p in fn(params, stacked)]


def _jax_zero(jax_hvd, kind, n, kw):
    group = jax_hvd.new_group(list(range(n)), name=f"torch_zero.{n}")
    params = jax.tree.map(jnp.asarray, _params(kind))
    grads = _grads(kind)

    def fn(r):
        if r >= n:
            return None
        opt = jz.ZeroDistributedOptimizer(_adamw(), group=group, **kw)
        st = opt.init(params)
        p, out = params, []
        for s in range(STEPS):
            u, st = opt.update(jax.tree.map(jnp.asarray, grads[r][s]), st, p)
            p = optax.apply_updates(p, u)
            out.append([np.asarray(p[k]) for k in SHAPES[kind]])
        return out

    return jax_basics.run_parallel(fn)[:n]


def _replicated(kind, n, steps=None, params=None, state=None):
    """``optax.adamw`` on the mean of the ranks' gradients."""
    opt = _adamw()
    p = jax.tree.map(jnp.asarray, params or _params(kind))
    st = opt.init(p) if state is None else state
    out = []
    for step_grads in steps or [[_grads(kind)[r][s] for r in range(n)]
                                for s in range(STEPS)]:
        g = jax.tree.map(lambda *a: sum(a) / len(a),
                         *[jax.tree.map(jnp.asarray, x) for x in step_grads])
        u, st = opt.update(g, st, p)
        p = optax.apply_updates(p, u)
        out.append([np.asarray(p[k]) for k in SHAPES[kind]])
    return out, p, st


def _close(got, want, where):
    for s, (g_step, w_step) in enumerate(zip(got, want)):
        for g, w, name in zip(g_step, w_step, SHAPES["small"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=f"{where} step {s} {name}")


# ----------------------------------------------------------------- layouts
@pytest.mark.parametrize("n_params", [0, 1, 3, 8, 13, 51, 677, 1000, 4096])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_layouts_match_jax(n_params, world):
    assert tz.shard_chunk_size(n_params, world) == \
        jz.shard_chunk_size(n_params, world)
    flat = np.arange(n_params, dtype=np.float32)
    for rank in range(world):
        assert tz.zero_shard_layout(n_params, world, rank) == \
            jz.zero_shard_layout(n_params, world, rank)
        np.testing.assert_array_equal(
            tz.flat_shard(torch.from_numpy(flat), world, rank).numpy(),
            jz.flat_shard(flat, world, rank))


# --------------------------------------------------------- the optimizers
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["sharded", "sharded_int8"])
def test_sharded_optimizer_matches_jax_shard_map(port_runs, case, n):
    kind, _, kw = CASES[case]
    want = _jax_sharded(kind, n, kw.get("compression"))
    for r, rank in enumerate(port_runs[n]):
        _close(rank[case]["steps"], want, f"{case} rank {r}")
        chunk = jz.shard_chunk_size(sum(np.prod(s) for s in
                                        SHAPES[kind].values()), n)
        if kw.get("compression"):
            chunk = -(-chunk // 256) * 256
        assert rank[case]["lens"] == [chunk, chunk]
    if not kw:
        _close(port_runs[n][0][case]["steps"], _replicated(kind, n)[0],
               f"{case} against the replicated update")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["zero", "zero_int8", "zero_fallback"])
def test_zero_optimizer_matches_jax_eager(port_runs, jax_hvd, case, n):
    kind, _, kw = CASES[case]
    want = _jax_zero(jax_hvd, kind, n, kw)
    n_params = sum(int(np.prod(s)) for s in SHAPES[kind].values())
    counts = jz.zero_shard_layout(n_params, n, 0)[0]
    for r, rank in enumerate(port_runs[n]):
        _close(rank[case]["steps"], want[r], f"{case} rank {r}")
        block = n_params if case == "zero_fallback" else counts[r]
        assert rank[case]["lens"] == [block, block]
        # the fallback's state is full-size already: gathering leaves it
        # be (resharding would cut it, as the reference's would)
        assert rank[case]["roundtrip"] or case == "zero_fallback"
        full = rank[case]["full"]["state"][0]
        assert sorted(int(v.numel()) for v in full.values()
                      if v.dim() == 1) == [n_params, n_params]
    if "compression" not in kw:
        _close(port_runs[n][0][case]["steps"], _replicated(kind, n)[0],
               f"{case} against the replicated update")


def test_state_gathered_at_two_ranks_reshards_at_four(port_runs):
    two, four = port_runs[2], port_runs[4]
    full = two[0]["zero"]["full"]["state"][0]
    assert all(torch.equal(a, b) for a, b in zip(
        full.values(), two[1]["zero"]["full"]["state"][0].values()))
    moments = [v.numpy() for v in full.values() if v.dim() == 1]
    for r, rank in enumerate(four):
        for got, whole in zip(rank["resume"]["blocks"], moments):
            np.testing.assert_array_equal(got, jz.flat_shard(whole, 4, r))
    # the replicated update: 3 steps on the 2 ranks' gradients, then one
    # on the 4 ranks'
    _, p, st = _replicated("small", 2)
    step4 = [[_grads("small", 1, seed=7)[r][0] for r in range(4)]]
    want, _, _ = _replicated("small", 4, steps=step4, params=p, state=st)
    for r, rank in enumerate(four):
        _close([rank["resume"]["params"]], want, f"resumed rank {r}")


# ------------------------------------------------------ one rank, errors
@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("how", ["sharded", "zero"])
def test_one_rank_is_the_replicated_update(one_rank, how):
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
          for v in _params("small").values()]
    base = torch.optim.AdamW(ps, lr=LR, weight_decay=WD)
    opt = hvd.ShardedDistributedOptimizer(base) if how == "sharded" \
        else hvd.ZeroDistributedOptimizer(base, min_size=1)
    got = []
    for s in range(STEPS):
        for p, g in zip(ps, _grads("small")[0][s].values()):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        got.append([p.detach().numpy().copy() for p in ps])
    want = _replicated("small", 1)[0]
    _close(got, want, how)
    assert opt.state_dict()["state"][0]["exp_avg"].numel() == 51


def test_adasum_and_groups_are_refused_as_the_reference_does(one_rank):
    ps = [torch.nn.Parameter(torch.zeros(4))]
    for name, make in (("ShardedDistributedOptimizer",
                        hvd.ShardedDistributedOptimizer),
                       ("ZeroDistributedOptimizer",
                        hvd.ZeroDistributedOptimizer)):
        with pytest.raises(ValueError) as got:
            make(torch.optim.AdamW(ps), op=hvd.Adasum)
        with pytest.raises(ValueError) as want:
            getattr(jz, name)(optax.adam(1e-3), op=jz.Adasum)
        assert str(got.value) == str(want.value)
    # group= is ported (ROADMAP A.10): anything but a ProcessGroup is
    # refused with the reference's groups.resolve error
    from horovod_tpu.groups import resolve as jax_resolve
    with pytest.raises(Exception) as want:
        jax_resolve(object())
    with pytest.raises(hvd.HvdError) as got:
        hvd.ZeroDistributedOptimizer(torch.optim.AdamW(ps), group=object())
    assert str(got.value) == str(want.value)
    for fn in (hvd.gather_zero_state, hvd.reshard_zero_state):
        with pytest.raises(hvd.HvdError) as got:
            fn({}, 4, group=object())
        assert str(got.value) == str(want.value)
    two = torch.optim.AdamW([{"params": ps}, {
        "params": [torch.nn.Parameter(torch.zeros(2))], "lr": 0.5}])
    with pytest.raises(ValueError, match="hyperparameters"):
        hvd.ZeroDistributedOptimizer(two)


def test_zero_min_size_env_is_read_in_init(monkeypatch):
    monkeypatch.setenv("HVD_TPU_ZERO_MIN_SIZE", "-1")
    with pytest.raises(ValueError, match="HVD_TPU_ZERO_MIN_SIZE"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    monkeypatch.setenv("HVD_TPU_ZERO_MIN_SIZE", "40")
    hvd.init(device="cpu")
    try:
        from horovod_tpu_torch.common import basics

        assert basics._get_state().zero_min_size == 40
        ps = [torch.nn.Parameter(torch.zeros(51))]
        opt = hvd.ZeroDistributedOptimizer(torch.optim.AdamW(ps))
        assert opt.min_size == 40
    finally:
        hvd.shutdown()
    monkeypatch.delenv("HVD_TPU_ZERO_MIN_SIZE")
    hvd.init(device="cpu")
    try:
        assert hvd.ZeroDistributedOptimizer(torch.optim.AdamW(
            [torch.nn.Parameter(torch.zeros(3))])).min_size == 1024
    finally:
        hvd.shutdown()
