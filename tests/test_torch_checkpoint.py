"""The port's durable checkpoints (``horovod_tpu_torch/checkpoint/
{store,manager}.py``) and checkpoint conventions
(``horovod_tpu_torch/utils/checkpoint.py``) against the JAX package's.

- The store: the port's shards are read and digest-verified by the JAX
  ``read_shard``; the JAX store's pickle-codec shards (its ``_codec``
  patched in the test, not edited) by the port's; a flax msgpack shard
  is refused with the codec named; corrupt, truncated and missing pieces
  raise ``CorruptShardError`` on both sides; both list one directory's
  manifests in the same order.
- The manager, at one rank, mirrors ``tests/test_durable_checkpoint.py``:
  interval and pruning, a round trip of parameters and optimizer state
  into a fresh model and optimizer, the fall-back past a corrupt or an
  incomplete checkpoint, a checkpoint that does not fit the model,
  ``manager_from_env``.  (Writing at 4 ranks and resuming at 2:
  ``tests/test_torch_elastic.py``.)
- ``utils/checkpoint`` mirrors ``tests/test_checkpoint.py``, each result
  held to the JAX function's on the same tree.
"""

import glob
import os

import numpy as np
import pytest
import torch

from horovod_tpu.checkpoint import store as jstore
from horovod_tpu.utils import checkpoint as jckpt

from horovod_tpu_torch.checkpoint import CheckpointManager, manager_from_env
from horovod_tpu_torch.checkpoint import store
from horovod_tpu_torch.elastic import State
from horovod_tpu_torch.utils import checkpoint as ckpt


def _payload():
    return {"params": np.arange(16, dtype=np.float32),
            "opt_sharded": {"0": np.ones(4, np.float32)},
            "opt_rest": {"1": np.float32(3.0)}}


def _equal_trees(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _equal_trees(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ store
def test_port_shard_is_read_by_the_jax_store(tmp_path):
    store.write_shard(str(tmp_path), 7, 1, 2, 0, _payload())
    _equal_trees(jstore.read_shard(str(tmp_path), 7, 1, 2, 0), _payload())
    assert not glob.glob(str(tmp_path / "*.tmp.*"))
    assert sorted(os.listdir(tmp_path)) == [
        jstore.shard_name(7, 1, 2, 0), jstore.shard_name(7, 1, 2, 0)
        + ".meta.json"]


def test_jax_pickle_shard_is_read_by_the_port(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "_codec", lambda: "pickle")
    jstore.write_shard(str(tmp_path), 3, 0, 4, 2, _payload())
    _equal_trees(store.read_shard(str(tmp_path), 3, 0, 4, 2), _payload())


def test_msgpack_shard_is_refused_with_its_codec_named(tmp_path):
    pytest.importorskip("flax")
    jstore.write_shard(str(tmp_path), 3, 0, 1, 0, _payload())
    with pytest.raises(store.CorruptShardError, match="'msgpack'"):
        store.read_shard(str(tmp_path), 3, 0, 1, 0)


@pytest.mark.parametrize("damage", ["flip", "truncate", "no_meta",
                                    "never_written", "meta_not_object"])
def test_damaged_shard_raises_on_both_sides(tmp_path, damage):
    store.write_shard(str(tmp_path), 3, 0, 1, 0,
                      {"params": np.arange(8, dtype=np.float32)})
    path = tmp_path / store.shard_name(3, 0, 1, 0)
    blob = bytearray(path.read_bytes())
    step = 3
    if damage == "flip":
        blob[len(blob) // 2] ^= 0xFF
        path.write_bytes(bytes(blob))
    elif damage == "truncate":
        path.write_bytes(bytes(blob[:-4]))
    elif damage == "no_meta":
        os.remove(f"{path}.meta.json")
    elif damage == "meta_not_object":
        (tmp_path / f"{path.name}.meta.json").write_text('"sha"')
    else:
        step = 99
    for side in (store, jstore):
        with pytest.raises(side.CorruptShardError):
            side.read_shard(str(tmp_path), step, 0, 1, 0)


def test_manifests_list_newest_first_on_both_sides(tmp_path):
    for step, epoch, world in [(5, 0, 4), (10, 0, 3), (10, 1, 3)]:
        store.write_manifest(str(tmp_path), step, epoch, world)
    want = [(10, 1, 3), (10, 0, 3), (5, 0, 4)]
    assert store.list_manifests(str(tmp_path)) == want
    assert jstore.list_manifests(str(tmp_path)) == want
    assert jstore.read_manifest(str(tmp_path), 10, 1, 3) == \
        store.read_manifest(str(tmp_path), 10, 1, 3)
    assert store.list_manifests(str(tmp_path / "missing")) == []


# ---------------------------------------------------------------- manager
def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                               torch.nn.Linear(3, 2))


def _train_state(model, steps, seed=0):
    """An AdamW optimizer after ``steps`` steps on fixed batches."""
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    for s in range(steps):
        x = torch.from_numpy(np.random.RandomState(seed + s).randn(5, 4)
                             .astype(np.float32))
        opt.zero_grad()
        model(x).pow(2).mean().backward()
        opt.step()
    return opt


def _commit_steps(state, manager, steps):
    """Commits one at a time, the writer drained between them."""
    for _ in range(steps):
        with torch.no_grad():
            for t in state.params.values():
                t.add_(1.0)
        state.step += 1
        state.commit()
        assert manager.wait(timeout=30)


def test_interval_gates_and_keep_prunes(tmp_path):
    state = State(params={"w": torch.zeros(8)})
    m = CheckpointManager(str(tmp_path), interval_steps=3, keep=0)
    state.attach_checkpoint(m)
    try:
        _commit_steps(state, m, 7)
    finally:
        m.close()
    assert store.list_manifests(str(tmp_path)) == [(6, 0, 1), (3, 0, 1)]
    assert [w[0] for w in m.writes] == [3, 6] and m.errors == 0

    pruned = tmp_path / "pruned"
    state2 = State(params={"w": torch.zeros(8)})
    m2 = CheckpointManager(str(pruned), interval_steps=1, keep=1)
    state2.attach_checkpoint(m2)
    try:
        _commit_steps(state2, m2, 3)
    finally:
        m2.close()
    assert store.list_manifests(str(pruned)) == [(3, 0, 1)]
    assert store.list_own_shards(str(pruned), 0) == [(3, 0, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_round_trips_params_and_optimizer(tmp_path, dtype):
    model = _model(0).to(getattr(torch, dtype))
    opt = _train_state(model, 3) if dtype == "float32" else \
        torch.optim.SGD(model.parameters(), lr=0.1)
    state = State(params=model, optimizer_state=opt, step=3, epoch=2)
    m = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    state.attach_checkpoint(m)
    try:
        state.commit()
        assert m.wait(timeout=30)
    finally:
        m.close()
    manifest = store.read_manifest(str(tmp_path), 3, 2, 1)
    assert manifest["opt_kind"] == "replicated"

    fresh_model = _model(1).to(getattr(torch, dtype))
    fresh_opt = (torch.optim.AdamW(fresh_model.parameters(), lr=1e-2)
                 if dtype == "float32" else
                 torch.optim.SGD(fresh_model.parameters(), lr=0.1))
    fresh = State(params=fresh_model, optimizer_state=fresh_opt)
    m2 = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    try:
        assert m2.restore_latest(fresh) == (3, 2)
    finally:
        m2.close()
    assert (fresh.step, fresh.epoch) == (3, 2)
    for (k, a), b in zip(model.state_dict().items(),
                         fresh_model.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    _equal_trees(fresh_opt.state_dict()["state"],
                 {k: {n: v.float() for n, v in e.items()}
                  for k, e in opt.state_dict()["state"].items()})
    # the restored state is the committed rollback point
    with torch.no_grad():
        fresh_model[0].weight.add_(99.0)
    fresh.restore()
    assert torch.equal(fresh_model[0].weight, model[0].weight)


def test_latest_wins_under_a_burst_of_commits(tmp_path):
    """The training thread hands snapshots to the writer faster than it
    writes (switch interval shortened): the writer skips stale ones,
    never writes one twice or out of order, and the flush at close
    leaves the newest step as the newest complete checkpoint."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        state = State(params={"w": torch.zeros(4096)})
        m = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
        state.attach_checkpoint(m)
        try:
            for _ in range(60):
                with torch.no_grad():
                    state.params["w"].add_(1.0)
                state.step += 1
                state.commit()
        finally:
            m.close(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not m._thread.is_alive() and m.errors == 0
    steps = [w[0] for w in m.writes]
    assert steps == sorted(set(steps)) and steps[-1] == 60
    assert store.list_manifests(str(tmp_path))[0] == (60, 0, 1)
    fresh = State(params={"w": torch.zeros(4096)})
    m2 = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    try:
        assert m2.restore_latest(fresh) == (60, 0)
    finally:
        m2.close()
    assert torch.equal(fresh.params["w"], torch.full((4096,), 60.0))


def test_corrupt_newest_falls_back_to_previous_complete(tmp_path):
    state = State(params={"w": torch.zeros(8)})
    m = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    state.attach_checkpoint(m)
    try:
        _commit_steps(state, m, 2)
    finally:
        m.close()
    shard = tmp_path / store.shard_name(2, 0, 1, 0)
    blob = bytearray(shard.read_bytes())
    blob[0] ^= 0xFF
    shard.write_bytes(bytes(blob))
    fresh = State(params={"w": torch.zeros(8)})
    m2 = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    try:
        assert m2.restore_latest(fresh) == (1, 0)
    finally:
        m2.close()
    assert torch.equal(fresh.params["w"], torch.full((8,), 1.0))


def test_incomplete_manifest_missing_world_shard_is_skipped(tmp_path):
    state = State(params={"w": torch.zeros(8)})
    m = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    state.attach_checkpoint(m)
    try:
        _commit_steps(state, m, 3)
    finally:
        m.close()
    # a newer world-2 checkpoint with rank 0's shard alone on disk
    m2 = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    try:
        m2._write({"params": {"w": torch.full((8,), 9.0)}, "opt": None,
                   "opt_full": False, "step": 5, "epoch": 0, "rank": 0,
                   "world": 2})
    finally:
        m2.close()
    assert store.list_manifests(str(tmp_path))[0] == (5, 0, 2)
    fresh = State(params={"w": torch.zeros(8)})
    m3 = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    try:
        assert m3.restore_latest(fresh) == (3, 0)
    finally:
        m3.close()
    assert torch.equal(fresh.params["w"], torch.full((8,), 3.0))


@pytest.mark.parametrize("change", ["grown", "other_optimizer"])
def test_checkpoint_that_does_not_fit_is_not_resumed(tmp_path, change):
    model = _model(0)
    state = State(params=model, optimizer_state=_train_state(model, 2),
                  step=1)
    m = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    state.attach_checkpoint(m)
    try:
        state.commit()
        assert m.wait(timeout=30)
    finally:
        m.close()
    if change == "grown":
        other = torch.nn.Linear(4, 5)
        opt = torch.optim.AdamW(other.parameters())
    else:
        other = _model(3)
        # one parameter group of two: AdamW's layout does not load
        opt = torch.optim.SGD([{"params": list(other.parameters())[:2]},
                               {"params": list(other.parameters())[2:]}],
                              lr=0.1)
    before = {k: v.clone() for k, v in other.state_dict().items()}
    fresh = State(params=other, optimizer_state=opt)
    m2 = CheckpointManager(str(tmp_path), interval_steps=1, keep=0)
    try:
        assert m2.restore_latest(fresh) is None
    finally:
        m2.close()
    for k, v in other.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert fresh.step == 0


def test_manager_from_env_reads_env_contract(tmp_path, monkeypatch):
    monkeypatch.delenv("HVD_TPU_CKPT_DIR", raising=False)
    assert manager_from_env() is None
    monkeypatch.setenv("HVD_TPU_CKPT_DIR", str(tmp_path / "ck"))
    monkeypatch.setenv("HVD_TPU_CKPT_INTERVAL", "7")
    monkeypatch.setenv("HVD_TPU_CKPT_KEEP", "3")
    m = manager_from_env()
    try:
        assert (m._dir, m._interval, m._keep) == (str(tmp_path / "ck"), 7,
                                                  3)
    finally:
        m.close()
    monkeypatch.delenv("HVD_TPU_CKPT_INTERVAL")
    monkeypatch.delenv("HVD_TPU_CKPT_KEEP")
    m = manager_from_env()
    try:
        assert (m._interval, m._keep) == (10, 2)
    finally:
        m.close()


# ------------------------------------------------------- utils/checkpoint
def _tree(value):
    return {"params": {"w": np.full((3, 2), value, np.float32)},
            "step_count": np.asarray(value, np.int32)}


def _torch_tree(value):
    return {"params": {"w": torch.full((3, 2), value)},
            "step_count": torch.tensor(int(value), dtype=torch.int32)}


def test_save_restore_roundtrip_matches_jax(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path / "t"), _torch_tree(7.0),
                                step=10, rank=0)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), _tree(7.0), step=10,
                                  rank=0)
    assert os.path.basename(path) == "ckpt_10.pt"
    assert os.path.basename(jpath) == "ckpt_10.msgpack"
    got, step = ckpt.restore_checkpoint(str(tmp_path / "t"),
                                        _torch_tree(0.0))
    want, jstep = jckpt.restore_checkpoint(str(tmp_path / "j"), _tree(0.0))
    assert step == jstep == 10
    _equal_trees({k: v if not isinstance(v, dict) else
                  {kk: vv.numpy() for kk, vv in v.items()}
                  for k, v in got.items()}, want)
    assert got["step_count"].dtype == torch.int32


def test_latest_and_pruning_match_jax(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(str(tmp_path / "t"), _torch_tree(float(s)),
                             step=s, keep=2, rank=0)
        jckpt.save_checkpoint(str(tmp_path / "j"), _tree(float(s)), step=s,
                              keep=2, rank=0)
    assert ckpt.latest_step(str(tmp_path / "t")) == \
        jckpt.latest_step(str(tmp_path / "j")) == 5
    assert [n.split(".")[0] for n in sorted(os.listdir(tmp_path / "t"))] \
        == [n.split(".")[0] for n in sorted(os.listdir(tmp_path / "j"))]
    got, step = ckpt.restore_checkpoint(str(tmp_path / "t"), None, step=4)
    assert step == 4 and torch.equal(got["params"]["w"],
                                     torch.full((3, 2), 4.0))
    for keep in (0, None):
        d = tmp_path / f"keep{keep}"
        for s in (1, 2):
            ckpt.save_checkpoint(str(d), _torch_tree(1.0), step=s,
                                 keep=keep, rank=0)
        assert len(os.listdir(d)) == (1 if keep == 0 else 2)


def test_non_zero_rank_does_not_write_and_empty_dir_returns_target(
        tmp_path):
    assert ckpt.save_checkpoint(str(tmp_path), _torch_tree(1.0), step=1,
                                rank=3) is None
    assert jckpt.save_checkpoint(str(tmp_path), _tree(1.0), step=1,
                                 rank=3) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    tree = _torch_tree(2.0)
    restored, step = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert step is None and restored is tree


def test_weights_only_load_refuses_other_objects(tmp_path):
    from fractions import Fraction

    ckpt.save_checkpoint(str(tmp_path), {"x": Fraction(1, 3)}, step=1,
                         rank=0)
    with pytest.raises(Exception, match="weights_only"):
        ckpt.restore_checkpoint(str(tmp_path), None)


def test_async_checkpoint_manager_roundtrip(tmp_path):
    target = {"w": torch.arange(8, dtype=torch.float32),
              "b": {"inner": torch.ones((2, 3))}}
    with ckpt.AsyncCheckpointManager(str(tmp_path / "ckpts"), keep=2,
                                     rank=0) as mgr:
        for step in (1, 2, 3):
            scaled = {"w": target["w"] * step,
                      "b": {"inner": target["b"]["inner"] * step}}
            assert mgr.save(step, scaled)
            scaled["w"].add_(1000.0)   # the save took a copy
        mgr.wait()
        assert mgr.latest_step() == 3
        restored, step = mgr.restore(target)
        assert step == 3
        assert torch.equal(restored["w"], torch.arange(8.0) * 3)
        restored2, s2 = mgr.restore(target, step=2)
        assert s2 == 2
        assert torch.equal(restored2["b"]["inner"], torch.ones(2, 3) * 2)
        with pytest.raises(FileNotFoundError):
            mgr.restore(target, step=1)   # keep=2: pruned


def test_async_checkpoint_manager_non_writer_noop(tmp_path):
    mgr = ckpt.AsyncCheckpointManager(str(tmp_path / "c2"), rank=1)
    assert mgr.save(1, {"x": torch.ones(1)}) is False
    assert mgr.latest_step() is None
    mgr.close()
