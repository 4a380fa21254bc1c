"""The port's elastic state and ``run`` (``horovod_tpu_torch/elastic``)
against the JAX package's ``horovod_tpu.elastic.State`` behaviour
(``tests/test_elastic.py``'s single-epoch cases), on gloo ranks.

- In this process: commit and restore as ``test_state_commit_restore_
  roundtrip`` does them, next to the JAX ``State`` on the same values;
  a module and an optimizer rolled back in place.
- Two ranks: ``sync`` replays rank 0's parameters, optimizer state and
  counters bitwise; ``restore`` after a step rolls back bitwise; ZeRO
  (``ZeroDistributedOptimizer``, sharded) commits the gathered full
  state and restores and syncs each rank's block; the replicated
  fallback below ``min_size`` is cut to the rank's block on restore, as
  the JAX ``reshard_zero_state`` (which the JAX ``State`` calls) cuts it
  (ROADMAP C.8); ``elastic.run`` with ``HVD_TPU_CKPT_DIR`` resumes a
  fresh model and optimizer from the newest checkpoint to the
  parameters of an uninterrupted run, bitwise; ``resume_step`` gives
  rank 0's view; ``callbacks.metric_average`` and
  ``broadcast_global_variables``.
- Four ranks write a ZeRO checkpoint through ``elastic.run``; two ranks
  resume it: parameters bitwise, each rank's optimizer block the block
  of the four ranks' full state at two.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ one process
@pytest.mark.parametrize("how", ["in_place", "rebound"])
def test_state_commit_restore_roundtrip_matches_jax(how):
    from horovod_tpu.elastic.state import State as JState

    from horovod_tpu_torch.elastic import State

    s = State(params={"w": torch.arange(4.0)}, step=3, epoch=1)
    j = JState(params={"w": np.arange(4.0)}, step=3, epoch=1)
    for st in (s, j):
        if how == "in_place":
            st.params["w"] += 100.0
        else:
            st.params["w"] = st.params["w"] + 100.0
        st.step = 9
        st.restore()
    assert (s.step, s.epoch) == (j.step, j.epoch) == (3, 1)
    np.testing.assert_array_equal(s.params["w"].numpy(), j.params["w"])
    for st in (s, j):
        st.params["w"] += 1.0
        st.commit()
        st.params["w"] += 5.0
        st.restore()
    np.testing.assert_array_equal(s.params["w"].numpy(), j.params["w"])
    np.testing.assert_array_equal(s.params["w"].numpy(), np.arange(4.0) + 1)


def test_state_rolls_a_module_and_its_optimizer_back_in_place():
    from horovod_tpu_torch.elastic import State

    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)

    def step():
        opt.zero_grad()
        model(torch.ones(4, 3)).sum().backward()
        opt.step()

    step()
    state = State(params=model, optimizer_state=opt, step=1)
    weight = model.weight.detach().clone()
    moment = opt.state[model.weight]["exp_avg"].clone()
    step()
    state.step = 2
    assert not torch.equal(model.weight, weight)
    state.restore()
    assert state.step == 1
    assert torch.equal(model.weight, weight)
    assert torch.equal(opt.state[model.weight]["exp_avg"], moment)
    assert "set" in repr(state)


# -------------------------------------------------------------- gloo ranks
WORKER = textwrap.dedent('''
    import os
    import pickle
    import sys

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks
    from horovod_tpu_torch.sharding.zero import gather_zero_state
    from horovod_tpu_torch.utils import checkpoint as ckpt


    def make_model(seed):
        model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                                    torch.nn.Linear(5, 2))
        rng = np.random.RandomState(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(
                    rng.randn(*p.shape).astype(np.float32) * 0.5))
        return model


    def train_step(model, opt, r, s):
        rng = np.random.RandomState(100 * r + s)
        x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
        opt.zero_grad()
        model(x).pow(2).mean().backward()
        opt.step()


    def params(model):
        return [p.detach().clone().numpy() for p in model.parameters()]


    def opt_tensors(state_dict):
        return {f"{pid}.{k}": v.clone().numpy()
                for pid, e in sorted(state_dict["state"].items())
                for k, v in sorted(e.items())}


    def zero_opt(model, min_size):
        return hvd.ZeroDistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.05), min_size=min_size)


    def world2(r, n, tmp):
        out = {}
        # sync: every rank starts from its own model, state and counters
        model = make_model(r)
        opt = torch.optim.AdamW(model.parameters(), lr=0.05)
        state = hvd.elastic.State(params=model, optimizer_state=opt,
                                  step=10 * r + 1, epoch=r)
        train_step(model, opt, r, 1)   # this rank's own optimizer state
        out["before"] = (params(model), opt_tensors(opt.state_dict()),
                         state.step, state.epoch)
        state.sync()
        out["sync"] = (params(model), opt_tensors(opt.state_dict()),
                       state.step, state.epoch)
        # restore after a step: back to the sync's commit
        train_step(model, opt, r, 2)
        state.restore()
        out["restore"] = (params(model), opt_tensors(opt.state_dict()),
                          state.step)

        # ZeRO: the full state committed, each rank's block restored
        model = make_model(0)
        n_params = sum(p.numel() for p in model.parameters())
        zopt = zero_opt(model, 0)
        for s in range(2):
            train_step(model, zopt, r, s)
        state = hvd.elastic.State(params=model, optimizer_state=zopt,
                                  zero_n_params=n_params)
        state.commit()
        shard = opt_tensors(zopt.state_dict())
        full = opt_tensors(state._committed[1])
        train_step(model, zopt, r, 2)
        state.restore()
        out["zero"] = (n_params, shard, full,
                       opt_tensors(zopt.state_dict()))
        train_step(model, zopt, r, 3)
        state.sync()
        out["zero_sync"] = opt_tensors(zopt.state_dict())

        # the replicated fallback (C.8): full-size state, cut on restore
        model = make_model(0)
        zopt = zero_opt(model, 10 ** 9)
        train_step(model, zopt, r, 0)
        state = hvd.elastic.State(params=model, optimizer_state=zopt,
                                  zero_n_params=n_params)
        state.commit()
        committed = opt_tensors(state._committed[1])
        state.restore()
        out["fallback"] = (committed, opt_tensors(zopt.state_dict()))

        # elastic.run through HVD_TPU_CKPT_DIR: 5 steps, then a fresh run
        # resumes from step 4 and goes on to 6
        os.environ["HVD_TPU_CKPT_DIR"] = os.path.join(tmp, "run")
        os.environ["HVD_TPU_CKPT_INTERVAL"] = "2"

        def run_to(seed, last):
            model = make_model(seed)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=0.05),
                named_parameters=model.named_parameters())
            state = hvd.elastic.State(params=model, optimizer_state=opt)

            def fn(state):
                resumed = state.step
                while state.step < last:
                    train_step(model, opt, r, state.step)
                    state.step += 1
                    state.commit()
                return resumed
            return fn, state, model

        fn, state, _ = run_to(0, 5)
        hvd.elastic.run(fn, state)
        fn, state, resumed_model = run_to(7, 6)
        resumed_from = hvd.elastic.run(fn, state)
        del os.environ["HVD_TPU_CKPT_DIR"]
        fn, state, plain = run_to(0, 6)
        hvd.elastic.run(fn, state)
        out["run"] = (resumed_from, params(resumed_model), params(plain))

        # rank 0's view of the latest step, whatever this rank sees
        mine = os.path.join(tmp, f"view{r}")
        ckpt.save_checkpoint(mine, {"w": torch.ones(1)}, step=42 if r == 0
                             else 7, rank=0)
        out["resume_step"] = (ckpt.resume_step(mine),
                              ckpt.resume_step(os.path.join(tmp, "none")))
        out["metric"] = callbacks.metric_average(float(r), "loss")
        out["bcast"] = callbacks.broadcast_global_variables(
            {"w": torch.full((3,), float(r))}, root_rank=1)["w"].numpy()
        return out


    def zero_run(r, n, tmp, steps):
        """``elastic.run`` of ZeRO AdamW with checkpoints every commit;
        at ``steps`` 0 it only resumes."""
        os.environ["HVD_TPU_CKPT_DIR"] = os.path.join(tmp, "zero")
        os.environ["HVD_TPU_CKPT_INTERVAL"] = "1"
        model = make_model(0 if steps else 5)
        n_params = sum(p.numel() for p in model.parameters())
        zopt = zero_opt(model, 0)
        state = hvd.elastic.State(params=model, optimizer_state=zopt,
                                  zero_n_params=n_params)

        def fn(state):
            for _ in range(steps):
                train_step(model, zopt, r, state.step)
                state.step += 1
                state.commit()
            return state.step

        last = hvd.elastic.run(fn, state)
        full = opt_tensors(gather_zero_state(zopt.state_dict(), n_params))
        return {"step": last, "params": params(model), "full": full,
                "block": opt_tensors(zopt.state_dict())}


    torch.set_num_threads(1)
    store, out_path, tmp, case = sys.argv[1:5]
    hvd.init(device="cpu", store_path=store)
    try:
        r, n = hvd.rank(), hvd.size()
        res = (world2(r, n, tmp) if case == "world2"
               else zero_run(r, n, tmp, 3 if case == "write4" else 0))
    finally:
        hvd.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
''')


def _launch(tmp, shared, n, case):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(n),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            for k in ("HVD_TPU_CKPT_DIR", "HVD_TPU_CKPT_INTERVAL",
                      "HVD_TPU_CKPT_KEEP"):
                env.pop(k, None)
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp / "store"),
                 str(tmp / f"out{r}.pkl"), str(shared), case], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r in range(n):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    shared = tmp_path_factory.mktemp("elastic_shared")
    return _launch(tmp_path_factory.mktemp("elastic2"), shared, 2, "world2")


@pytest.fixture(scope="module")
def four_to_two(tmp_path_factory):
    shared = tmp_path_factory.mktemp("zero_shared")
    four = _launch(tmp_path_factory.mktemp("zero4"), shared, 4, "write4")
    two = _launch(tmp_path_factory.mktemp("zero2"), shared, 2, "resume2")
    return four, two, shared


def _equal(a, b, where=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), where
        for k in b:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def test_sync_replays_rank_0s_state_bitwise(world2):
    root = world2[0]["before"]
    assert not all(np.array_equal(a, b) for a, b in
                   zip(world2[1]["before"][0], root[0]))
    for r, res in enumerate(world2):
        _equal(res["sync"], root, f"rank {r}")


def test_restore_after_a_step_rolls_back_bitwise(world2):
    for r, res in enumerate(world2):
        _equal(res["restore"], res["sync"][:3], f"rank {r}")


def test_zero_commits_the_full_state_and_restores_the_block(world2):
    from horovod_tpu_torch.sharding.zero import zero_shard_layout

    n_params = world2[0]["zero"][0]
    for r, res in enumerate(world2):
        _, shard, full, restored = res["zero"]
        _equal(restored, shard, f"rank {r}")
        _, off, cnt = zero_shard_layout(n_params, 2, r)
        for k, v in full.items():
            if v.ndim == 1 and v.shape[0] == n_params:
                np.testing.assert_array_equal(v[off:off + cnt], shard[k])
            else:
                np.testing.assert_array_equal(v, shard[k])
        _equal(full, world2[0]["zero"][2])   # the same on every rank


def test_zero_sync_gives_each_rank_its_block_of_rank_0s_state(world2):
    from horovod_tpu_torch.sharding.zero import zero_shard_layout

    n_params, _, full, _ = world2[0]["zero"]
    for r, res in enumerate(world2):
        _, off, cnt = zero_shard_layout(n_params, 2, r)
        for k, v in res["zero_sync"].items():
            want = full[k][off:off + cnt] if full[k].ndim == 1 \
                and full[k].shape[0] == n_params else full[k]
            np.testing.assert_array_equal(v, want, err_msg=f"{r} {k}")


def test_zero_fallback_state_is_cut_as_the_jax_state_cuts_it(world2,
                                                             monkeypatch):
    """ROADMAP C.8: the replicated fallback's full-size state goes
    through ``reshard_zero_state`` on restore and comes back cut to the
    rank's block, in the port as in the JAX package."""
    import jax.numpy as jnp

    from horovod_tpu.sharding import zero as jzero

    n_params = world2[0]["zero"][0]
    for r, res in enumerate(world2):
        committed, restored = res["fallback"]
        monkeypatch.setattr(jzero, "_topology_of",
                            lambda basics, group=None, r=r: (r, 2))
        want = jzero.reshard_zero_state(
            {k: jnp.asarray(v) for k, v in committed.items()}, n_params)
        assert any(v.shape[0] == n_params for v in committed.values()
                   if v.ndim == 1)
        for k, v in restored.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]),
                                          err_msg=f"{r} {k}")


def test_run_resumes_from_the_newest_checkpoint_bitwise(world2):
    for r, res in enumerate(world2):
        resumed_from, resumed, plain = res["run"]
        assert resumed_from == 4
        _equal(resumed, plain, f"rank {r}")
    _equal(world2[1]["run"][1], world2[0]["run"][1])


def test_resume_step_is_rank_0s_view(world2):
    for res in world2:
        assert res["resume_step"] == (42, None)


def test_metric_average_and_broadcast_global_variables(world2):
    for res in world2:
        assert res["metric"] == pytest.approx(0.5)
        np.testing.assert_array_equal(res["bcast"], np.full(3, 1.0))


def test_checkpoint_written_at_four_ranks_resumes_at_two(four_to_two):
    from horovod_tpu_torch.checkpoint import store
    from horovod_tpu_torch.sharding.zero import zero_shard_layout

    four, two, shared = four_to_two
    assert store.list_manifests(str(shared / "zero"))[0] == (3, 0, 4)
    manifest = store.read_manifest(str(shared / "zero"), 3, 0, 4)
    assert manifest["opt_kind"] == "full"
    n_params = manifest["n_params"]
    for r, res in enumerate(two):
        assert res["step"] == 3
        _equal(res["params"], four[0]["params"], f"rank {r} params")
        _equal(res["full"], four[0]["full"], f"rank {r} full state")
        _, off, cnt = zero_shard_layout(n_params, 2, r)
        for k, v in res["block"].items():
            want = four[0]["full"][k]
            if want.ndim == 1 and want.shape[0] == n_params:
                want = want[off:off + cnt]
            np.testing.assert_array_equal(v, want, err_msg=f"{r} {k}")
