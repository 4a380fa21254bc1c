"""The port's cluster layer (``horovod_tpu_torch/cluster``) against the
JAX package's (``horovod_tpu/cluster``): the Store's npz shards, which
each package reads from the other, bf16 included; ``split_validation``
and ``materialize_shards``; the Backends; and ``TorchEstimator`` at two
ranks through each package's ``ProcessBackend`` against the JAX
package's ``TorchEstimator`` (a plain module) and its ``JaxEstimator``
(the small transformer LM with ``lm_loss``, on the same weights through
``models.params_from_flax``).

The port's ``run(fn)`` pickles with plain pickle on the card's machine,
which has no cloudpickle; these tests make it do so here too."""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_cluster_fns as fns
from horovod_tpu.cluster import backend as jax_backend
from horovod_tpu.cluster import store as jax_store
from horovod_tpu.cluster import JaxEstimator
from horovod_tpu.cluster import TorchEstimator as JaxTorchEstimator
from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import lm_loss as jax_lm_loss
import horovod_tpu_torch as hvd
from horovod_tpu_torch.cluster import (InProcessBackend, LocalStore,
                                       ProcessBackend, TorchEstimator,
                                       TorchModel)
from horovod_tpu_torch.cluster import store as port_store
from horovod_tpu_torch.models import lm_loss, params_from_flax
from horovod_tpu_torch.run import api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
# the workers import torch_cluster_fns, beside this file
ENV = {"PYTHONPATH": os.pathsep.join([TESTS, REPO, os.environ.get(
    "PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}


@pytest.fixture
def plain_pickle(monkeypatch):
    """``run(fn)`` as on the card's machine: no cloudpickle."""
    monkeypatch.setattr(api, "_pickler", pickle)


# ------------------------------------------------------------------ store --
DTYPES = ["float32", "float64", "float16", "int32", "int64", "uint8",
          "bool", "bfloat16"]


def _jax_column(dtype, shape, seed=0):
    values = np.random.RandomState(seed).randn(*shape) * 8
    if dtype == "bfloat16":
        return values.astype(np.float32).astype(ml_dtypes.bfloat16)
    return values.astype(dtype)


def _bits(col):
    """A column's bytes, whichever package's in-memory form it has."""
    if torch.is_tensor(col):
        if col.dtype == torch.bfloat16:
            return col.view(torch.int16).numpy().view(np.uint16)
        return col.numpy()
    col = np.asarray(col)
    if col.dtype == ml_dtypes.bfloat16 or col.dtype == np.dtype("V2"):
        return col.view(np.uint16)
    return col


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_shards_cross_between_the_packages(tmp_path, dtype, writer):
    x = _jax_column(dtype, (6, 3, 2))
    y = _jax_column("int64", (6,), seed=1)
    if writer == "jax":
        jax_store.LocalStore(str(tmp_path)).save_shard(2, {"x": x, "y": y})
        got = LocalStore(str(tmp_path)).load_shard(2)
        if dtype == "bfloat16":
            assert got["x"].dtype == torch.bfloat16
    else:
        port_x = (torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
                  if dtype == "bfloat16" else x)
        LocalStore(str(tmp_path)).save_shard(2, {"x": port_x, "y": y})
        got = jax_store.LocalStore(str(tmp_path)).load_shard(2)
        # the bytes the JAX package reads from its own shard
        own = tmp_path / "own"
        jax_store.LocalStore(str(own)).save_shard(2, {"x": x, "y": y})
        own_x = jax_store.LocalStore(str(own)).load_shard(2)["x"]
        assert got["x"].dtype == own_x.dtype
    np.testing.assert_array_equal(_bits(got["x"]), _bits(x))
    np.testing.assert_array_equal(got["y"], y)


@pytest.mark.parametrize("n,ranks", [(10, 1), (10, 3), (17, 4), (8, 8)])
@pytest.mark.parametrize("validation", [None, 0.25])
def test_materialize_shards_as_the_jax_package(tmp_path, n, ranks,
                                                validation):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n, dtype=np.int64)
    out = {}
    for name, mod in (("jax", jax_store), ("port", port_store)):
        store = mod.LocalStore(str(tmp_path / name))
        xs, ys, xv, yv = x, y, None, None
        if validation is not None:
            xs, ys, xv, yv = mod.split_validation(x, y, validation)
        try:
            mod.materialize_shards(store, xs, ys, ranks, xv, yv)
        except ValueError as exc:   # too few rows for the ranks
            out[name] = str(exc)
            continue
        splits = ["train"] + (["val"] if xv is not None else [])
        out[name] = [store.load_shard(r, split)
                     for split in splits for r in range(ranks)]
    if isinstance(out["jax"], str):
        assert out["port"] == out["jax"]
        return
    for j, p in zip(out["jax"], out["port"]):
        for k in ("x", "y"):
            np.testing.assert_array_equal(p[k], j[k])


@pytest.mark.parametrize("module", [jax_store, port_store],
                         ids=["jax", "port"])
@pytest.mark.parametrize("fraction,match", [
    (0.0, "in \\(0, 1\\)"), (1.0, "in \\(0, 1\\)"),
    (0.9, "leaves no training rows")])
def test_split_validation_refuses_as_the_jax_package(module, fraction,
                                                     match):
    x = np.ones((1, 3), np.float32)
    with pytest.raises(ValueError, match=match):
        module.split_validation(x, x, fraction)


def test_too_few_rows_for_the_ranks_raise(tmp_path):
    with pytest.raises(ValueError, match="at least one sample per rank"):
        port_store.materialize_shards(
            LocalStore(str(tmp_path)), np.ones((3, 4), np.float32),
            np.ones((3, 2), np.float32), 4)


def test_tensor_columns_shard_as_numpy_ones(tmp_path):
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    store = LocalStore(str(tmp_path))
    xs, _ = port_store.materialize_shards(store, torch.from_numpy(x),
                                          torch.arange(7), 3)
    assert len(xs) == 6
    shards = [store.load_shard(r) for r in range(3)]
    np.testing.assert_array_equal(
        np.concatenate([s["x"] for s in shards]), x[:6])


# --------------------------------------------------------------- backends --
def test_in_process_backend_runs_one_rank():
    with pytest.raises(ValueError, match="ProcessBackend"):
        InProcessBackend(num_proc=2)
    backend = InProcessBackend(device="cpu")
    try:
        assert backend.num_processes() == 1
        assert backend.run(lambda r, a, b=0: (r, a + b), args=(2,),
                           kwargs={"b": 3}) == [(0, 5)]
        assert hvd.device() == torch.device("cpu")
    finally:
        hvd.shutdown()


def test_in_process_backend_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est = TorchEstimator(fns.mlp_factory)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        est.fit(*fns.linear_data())
    assert not hvd.is_initialized()


def test_process_backend_needs_picklable_functions(plain_pickle):
    """Plain pickle sends a function by name: a lambda cannot go."""
    with pytest.raises((pickle.PicklingError, AttributeError)):
        ProcessBackend(2, device="cpu", extra_env=ENV).run(lambda r: r)


def test_process_backend_runs_a_rank_a_process(plain_pickle):
    got = ProcessBackend(2, device="cpu", extra_env=ENV).run(
        fns.rank_and_world, args=(5,), kwargs={"b": 1})
    assert got == [(0, 2, 6), (1, 2, 6)]


# -------------------------------------------------------------- estimator --
def test_torch_estimator_in_process_fits_and_serves(tmp_path):
    x, y = fns.linear_data(n=96)
    est = TorchEstimator(fns.mlp_factory, epochs=6, batch_size=16,
                         learning_rate=0.05,
                         store=LocalStore(str(tmp_path)), validation=0.25,
                         device="cpu")
    try:
        model, metrics = est.fit(x, y)
    finally:
        hvd.shutdown()
    assert isinstance(model, TorchModel) and len(metrics) == 1
    assert set(metrics[0]) == {"loss", "val_loss"}
    baseline = float(np.mean(y ** 2))
    assert model.evaluate(x, y) < baseline
    assert model.predict(x[:2]).shape == (2, 3)
    assert os.path.exists(tmp_path / "checkpoints" / "model.pt")
    t = est.timings
    assert {"materialize_s", "run_s", "reload_s"} <= set(t)
    assert t["ranks"][0]["steps"] == 6 * (72 // 16)


def test_integer_features_stay_integer():
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    from horovod_tpu_torch.cluster.torch_estimator import _features, _labels

    assert _features(ids).dtype == torch.int32
    assert _features(ids.astype(np.float64)).dtype == torch.float32
    assert _labels(ids.astype(np.float64)).dtype == torch.float32
    assert _labels(ids).dtype == torch.int32


def test_torch_estimator_matches_jax_torch_estimator(tmp_path, plain_pickle):
    """Both packages' TorchEstimators at two ranks, each through its
    ProcessBackend, the same module and rows: the final weights and every
    rank's metrics bitwise equal (a sum of two gradients is the same in
    either order)."""
    x, y = fns.linear_data(n=72)
    kw = dict(epochs=3, batch_size=8, learning_rate=0.05, validation=0.25)
    jax_est = JaxTorchEstimator(
        fns.mlp_factory, store=jax_store.LocalStore(str(tmp_path / "j")),
        backend=jax_backend.ProcessBackend(2, extra_env=ENV,
                                           jax_platform="cpu"), **kw)
    jax_model, jax_metrics = jax_est.fit(x, y)
    est = TorchEstimator(
        fns.mlp_factory, store=LocalStore(str(tmp_path / "p")),
        backend=ProcessBackend(2, device="cpu", extra_env=ENV),
        device="cpu", **kw)
    model, metrics = est.fit(x, y)
    assert metrics == jax_metrics
    assert metrics[0] == metrics[1]
    want = jax_model.model.state_dict()
    got = model.model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(model.predict(x[:4]).numpy(),
                                  jax_model.predict(x[:4]).numpy())


def test_torch_estimator_matches_jax_estimator_on_the_lm(tmp_path,
                                                         plain_pickle):
    """``JaxEstimator`` on the JAX transformer with ``lm_loss`` against
    the port's ``TorchEstimator`` on the port's, from the same weights,
    both at two ranks: the weights within rtol 1e-5 of each tensor's
    largest entry and the metric within rtol 1e-6 (fp32 sums in another
    order; 8.7e-7 and bitwise seen)."""
    tokens = fns.lm_tokens()
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, **fns.LM))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))
    start = str(tmp_path / "start.pt")
    torch.save(params_from_flax(params["params"]), start)
    kw = dict(epochs=2, batch_size=4, learning_rate=0.1)
    jax_est = JaxEstimator(
        model, loss=jax_lm_loss, store=jax_store.LocalStore(
            str(tmp_path / "j")),
        backend=jax_backend.ProcessBackend(2, extra_env=ENV,
                                           jax_platform="cpu"), **kw)
    jax_fit, jax_metrics = jax_est.fit(tokens, tokens)
    est = TorchEstimator(
        functools.partial(fns.lm_factory, start), loss=lm_loss,
        store=LocalStore(str(tmp_path / "p")),
        backend=ProcessBackend(2, device="cpu", extra_env=ENV),
        device="cpu", **kw)
    fit, metrics = est.fit(tokens, tokens)
    np.testing.assert_allclose(metrics, jax_metrics, rtol=1e-6)
    assert metrics[0] == metrics[1]
    want = params_from_flax(jax_fit.params["params"])
    got = fit.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 1e-5 * float(w.abs().max())
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=atol)
