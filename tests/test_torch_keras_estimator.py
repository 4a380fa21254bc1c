"""The port's ``KerasEstimator`` (``horovod_tpu_torch/cluster/
keras_estimator.py``) against the JAX package's, and the
``spark.keras`` import path.

``tests/torch_keras_est_worker.py`` runs the fits in one process: the
JAX estimator and the port's on one in-process rank each, from the same
weights, data and shuffle seed, while the port's two-rank fit through
``ProcessBackend`` runs on uneven validation shards
(``tests/test_estimator.py``'s row-weighted case)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_keras_est_worker.py")
needs_tf = pytest.mark.skipif(importlib.util.find_spec("tensorflow") is None,
                              reason="TensorFlow is not installed")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """-> {"one": {"jax.*", "port.*"}, "two": {...}}: each fit's results."""
    out = tmp_path_factory.mktemp("keras_est") / "fits.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TF_CPP_MIN_LOG_LEVEL"] = "2"
    job = subprocess.run([sys.executable, WORKER, str(out)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, cwd=REPO, timeout=300)
    assert job.returncode == 0 and "KERAS_EST_OK" in job.stdout, \
        f"exit {job.returncode}\n{job.stdout[-4000:]}"
    with np.load(out) as data:
        res = {k: data[k] for k in data.files}
    return {"one": {k: v for k, v in res.items()
                    if not k.startswith("two.")},
            "two": {k[4:]: v for k, v in res.items()
                    if k.startswith("two.")}}


@needs_tf
@pytest.mark.parametrize("what", ["weights", "metrics"])
def test_one_rank_fit_matches_the_jax_estimator(fits, what):
    one = fits["one"]
    keys = [k[4:] for k in one if k.startswith("jax.")]
    keys = [k for k in keys if k.startswith("w") == (what == "weights")]
    assert keys
    for key in keys:
        np.testing.assert_allclose(one[f"port.{key}"], one[f"jax.{key}"],
                                   rtol=1e-6, err_msg=key)


@needs_tf
def test_two_rank_fit_agrees_across_ranks(fits):
    two = fits["two"]
    assert len(two["loss"]) == 2 and np.all(np.isfinite(two["loss"]))
    assert two["loss"][0] == two["loss"][1]
    assert two["val_loss"][0] == two["val_loss"][1]


@needs_tf
def test_two_rank_val_loss_is_row_weighted(fits):
    """27 validation rows over two ranks (14 and 13): ``val_loss`` is the
    row-weighted mean of the ranks' shard losses, which each rank
    computed with its own weights: it matches rank 0's fitted weights on
    each shard, so the ranks' weights agree."""
    two = fits["two"]
    assert list(two["shard_rows"]) == [14, 13]
    weighted = float(np.dot(two["evaluate_shards"], two["shard_rows"])
                     / np.sum(two["shard_rows"]))
    np.testing.assert_allclose(two["val_loss"][0], weighted, rtol=1e-5)
    np.testing.assert_allclose(two["val_loss"][0], two["evaluate_all"],
                               rtol=1e-5)
    # the equal-weight mean of the shards would differ
    assert abs(np.mean(two["evaluate_shards"]) - weighted) > 1e-3


def test_spark_keras_import_path():
    from horovod_tpu_torch import cluster, spark
    from horovod_tpu_torch.spark import keras as spark_keras

    assert spark_keras.KerasEstimator is cluster.KerasEstimator
    assert spark.KerasEstimator is cluster.KerasEstimator
    assert spark_keras.Store is cluster.Store
    assert spark_keras.LocalStore is cluster.LocalStore
    assert cluster.KerasModel.__module__ == \
        "horovod_tpu_torch.cluster.keras_estimator"


def test_keras_on_another_backend_raises_and_names_it():
    """The binding needs Keras on TensorFlow, as the JAX package's does;
    a stand-in ``keras`` whose backend is torch is refused on first use."""
    code = (
        "import sys, types\n"
        "keras = types.ModuleType('keras')\n"
        "keras.backend = types.SimpleNamespace(backend=lambda: 'torch')\n"
        "keras.callbacks = types.SimpleNamespace(Callback=object)\n"
        "sys.modules['keras'] = keras\n"
        "import horovod_tpu_torch.keras as hvd_keras\n"
        "for call in (lambda: hvd_keras.DistributedOptimizer(None),\n"
        "             lambda: hvd_keras.callbacks.MetricAverageCallback(),\n"
        "             lambda: hvd_keras.load_model('m.keras')):\n"
        "    try:\n"
        "        call()\n"
        "        raise SystemExit('no error')\n"
        "    except RuntimeError as exc:\n"
        "        assert \"'torch'\" in str(exc) and 'TensorFlow' in str(exc)\n"
        "print('refused')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr
