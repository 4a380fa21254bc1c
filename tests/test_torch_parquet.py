"""The port's Parquet store and streaming (``cluster/parquet_store.py``,
``utils/data.py``'s ``ParquetShardIterator`` and ``lockstep_*``) against
the JAX package's: a dataset either package writes reads identically in
the other, bf16 included; the streamed batches, the shuffle, the
lockstep plan and the errors for an empty shard and a shard smaller than
a batch are the JAX package's; and a streaming fit at two ranks equals
the JAX package's ``TorchEstimator``'s."""

import os
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

pytest.importorskip("pyarrow")

import torch_cluster_fns as fns  # noqa: E402
from horovod_tpu.cluster import backend as jax_backend  # noqa: E402
from horovod_tpu.cluster import parquet_store as jax_pq  # noqa: E402
from horovod_tpu.cluster import LocalStore as JaxLocalStore  # noqa: E402
from horovod_tpu.cluster import TorchEstimator as JaxTorchEstimator  # noqa: E402
from horovod_tpu.utils import data as jax_data  # noqa: E402
from horovod_tpu_torch.cluster import (LocalStore, ProcessBackend,  # noqa: E402
                                       TorchEstimator)
from horovod_tpu_torch.cluster import parquet_store as port_pq  # noqa: E402
from horovod_tpu_torch.run import api  # noqa: E402
from horovod_tpu_torch.utils import data as port_data  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": os.pathsep.join([os.path.join(REPO, "tests"), REPO,
                                      os.environ.get("PYTHONPATH", "")]),
       "OMP_NUM_THREADS": "1"}
PACKAGES = {"jax": jax_pq, "port": port_pq}


def _columns(n=40):
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(n, 3).astype(np.float32),
        "img": rng.randn(n, 2, 3).astype(np.float64),
        "half": rng.randn(n).astype(np.float16),
        "y": rng.randint(0, 9, n).astype(np.int64),
        "bf": (rng.randn(n, 2) * 8).astype(np.float32).astype(
            ml_dtypes.bfloat16),
    }


def _for(package, cols):
    """The columns as ``package`` holds them: the port a bfloat16 column
    as a tensor (numpy has none)."""
    if package == "jax":
        return cols
    out = dict(cols)
    out["bf"] = torch.from_numpy(cols["bf"].view(np.int16)).view(
        torch.bfloat16)
    return out


def _bits(col):
    if torch.is_tensor(col):
        return col.view(torch.int16).numpy().view(np.uint16)
    col = np.asarray(col)
    return col.view(np.uint16) if col.dtype == ml_dtypes.bfloat16 else col


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if k == "bf":
            assert (g.dtype == torch.bfloat16) if torch.is_tensor(g) else \
                (g.dtype == ml_dtypes.bfloat16)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_datasets_cross_between_the_packages(tmp_path, writer, reader,
                                             shards):
    cols = _columns()
    val = {k: v[:10] for k, v in cols.items()}
    PACKAGES[writer].ParquetStore(str(tmp_path), rows_per_row_group=4) \
        .materialize(_for(writer, cols), validation=_for(writer, val))
    read = PACKAGES[reader].ParquetStore(str(tmp_path))
    own = PACKAGES[reader].ParquetStore(str(tmp_path / "own"),
                                        rows_per_row_group=4)
    own.materialize(_for(reader, cols), validation=_for(reader, val))
    for split in ("train", "val"):
        for r in range(shards):
            _same(read.read_shard(r, shards, split=split),
                  own.read_shard(r, shards, split=split))
    assert read.shard_row_counts(shards) == own.shard_row_counts(shards)


def test_bf16_reads_back_as_the_jax_bits(tmp_path):
    cols = _columns()
    jax_pq.ParquetStore(str(tmp_path), rows_per_row_group=8).materialize(
        {"bf": cols["bf"]})
    got = port_pq.ParquetStore(str(tmp_path)).read_shard(0, 1)["bf"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(cols["bf"]))


def test_filesystem_store_reads_the_jax_dataset(tmp_path):
    x = np.arange(24, dtype=np.float32)
    jax_pq.FilesystemStore(f"file://{tmp_path}/fs",
                           rows_per_row_group=4).materialize({"x": x})
    store = port_pq.FilesystemStore(f"file://{tmp_path}/fs")
    np.testing.assert_array_equal(store.read_shard(1, 3)["x"],
                                  jax_pq.ParquetStore(
                                      str(tmp_path / "fs")).read_shard(
                                          1, 3)["x"])
    local = tmp_path / "run"
    local.mkdir()
    (local / "ckpt.bin").write_bytes(b"\x00" * 16)
    dest = store.sync_run_dir(str(local), run_id="r1")
    assert store.exists(f"{dest}/ckpt.bin")


@pytest.fixture
def stores(tmp_path):
    """The same 50 rows (13 row groups of 4) in each package's store."""
    cols = _columns(50)
    out = {}
    for name, mod in PACKAGES.items():
        out[name] = mod.ParquetStore(str(tmp_path / name),
                                     rows_per_row_group=4)
        out[name].materialize(_for(name, cols))
    return out


def _stream(name, stores, *args, **kw):
    mod = jax_data if name == "jax" else port_data
    return list(mod.ParquetShardIterator(stores[name], *args, **kw))


@pytest.mark.parametrize("shard,count", [(0, 1), (1, 2), (2, 3)])
@pytest.mark.parametrize("batch", [3, 8])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop", [True, False])
def test_stream_gives_the_jax_batches(stores, shard, count, batch, shuffle,
                                      drop):
    kw = dict(shuffle=shuffle, seed=7, drop_remainder=drop, epochs=2)
    want = _stream("jax", stores, shard, count, batch, **kw)
    got = _stream("port", stores, shard, count, batch, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("ranks,batch,epochs", [(1, 8, 1), (2, 5, 2),
                                                (3, 64, 1), (4, 3, 3)])
def test_lockstep_as_the_jax_package(stores, ranks, batch, epochs):
    assert port_data.lockstep_plan(stores["port"], ranks, batch, epochs) \
        == jax_data.lockstep_plan(stores["jax"], ranks, batch, epochs)
    for r in range(ranks):
        want = list(jax_data.lockstep_shard_batches(stores["jax"], r, ranks,
                                                    batch, epochs))
        got = list(port_data.lockstep_shard_batches(stores["port"], r,
                                                    ranks, batch, epochs))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", ["empty_shard_read", "empty_shard_min",
                                  "empty_shard_stream", "small_shard",
                                  "not_sharded"])
def test_errors_are_the_jax_ones(stores, tmp_path, case):
    def call(name):
        mod = jax_data if name == "jax" else port_data
        store = stores[name]
        if case == "empty_shard_read":      # 13 row groups, 16 ranks
            return lambda: store.read_shard(15, 16)
        if case == "empty_shard_min":
            return lambda: mod.min_shard_rows(store, 16)
        if case == "empty_shard_stream":
            return lambda: mod.ParquetShardIterator(store, 14, 16, 2)
        if case == "small_shard":           # 24 rows, a batch of 64
            return lambda: mod.ParquetShardIterator(store, 0, 2, 64)
        local = (LocalStore if name == "port" else JaxLocalStore)(
            str(tmp_path / f"l{name}"))
        return lambda: mod.require_sharded_store(local)

    assert _error(call("port")) == _error(call("jax"))


def test_stream_of_bf16_columns_is_tensors(stores):
    batches = _stream("port", stores, 0, 1, 8, columns=["bf", "y"])
    assert all(b["bf"].dtype == torch.bfloat16 for b in batches)
    want = _stream("jax", stores, 0, 1, 8, columns=["bf", "y"])
    for g, w in zip(batches, want):
        _same(g, w)


@pytest.mark.parametrize("streaming", [False, True])
def test_parquet_fit_matches_the_jax_torch_estimator(tmp_path, monkeypatch,
                                                     streaming):
    """Both packages' TorchEstimators from a ParquetStore, two ranks each
    through its ProcessBackend (row-group reads, or streamed batches):
    the weights and the metrics bitwise equal."""
    monkeypatch.setattr(api, "_pickler", pickle)   # the card's machine
    x, y = fns.linear_data(n=64)
    kw = dict(epochs=2, batch_size=8, learning_rate=0.05,
              streaming=streaming)
    jax_est = JaxTorchEstimator(
        fns.mlp_factory,
        store=jax_pq.ParquetStore(str(tmp_path / "j"),
                                  rows_per_row_group=4),
        backend=jax_backend.ProcessBackend(2, extra_env=ENV,
                                           jax_platform="cpu"), **kw)
    jax_model, jax_metrics = jax_est.fit(x, y)
    est = TorchEstimator(
        fns.mlp_factory,
        store=port_pq.ParquetStore(str(tmp_path / "p"),
                                   rows_per_row_group=4),
        backend=ProcessBackend(2, device="cpu", extra_env=ENV),
        device="cpu", **kw)
    model, metrics = est.fit(x, y)
    assert metrics == jax_metrics
    want = jax_model.model.state_dict()
    for k, v in model.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_streaming_needs_a_sharded_store(tmp_path):
    """Refused before the estimator joins a job: nothing is left
    initialized."""
    import horovod_tpu_torch as hvd

    est = TorchEstimator(fns.mlp_factory, streaming=True,
                         store=LocalStore(str(tmp_path)), device="cpu")
    try:
        with pytest.raises(ValueError, match="sharded-dataset store"):
            est.fit(*fns.linear_data())
        assert not hvd.is_initialized()
    finally:
        hvd.shutdown()
