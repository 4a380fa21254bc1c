"""The port's TensorFlow and Keras bindings against the JAX package's.

``tests/torch_tf_worker.py`` runs the same scenarios, on inputs made with
numpy from seeds, in one two-rank job of each package: the JAX one
through ``bin/hvdrun``, the port's through ``python -m
horovod_tpu_torch.run`` with ``init(device="cpu")`` (gloo).  Both jobs
start at once (each rank pays about 10 s of TensorFlow import); every
test below holds one scenario's keys of the port's ``.npz`` against the
JAX job's: bf16 and fp16 at rtol 0.05 (``tests/test_tensorflow.py``'s
matrix), the Keras models' weights at rtol 1e-6, everything else exact.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

# TensorFlow is looked up, not imported: the jobs import it
pytestmark = pytest.mark.skipif(importlib.util.find_spec("tensorflow") is None,
                                reason="TensorFlow is not installed")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tf_worker.py")
MODEL_SCENARIOS = ("tape", "optimizer", "bpps", "sparse_as_dense", "fit",
                   "load_model", "keras_ops", "tf1_hook")
SCENARIOS = ("matrix", "errors", "compression", "collectives", "sparse",
             "graph", "grad") + MODEL_SCENARIOS


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both jobs, started together: -> {"jax": [rank0, rank1], "port":
    [...]}, each rank's results as a dict."""
    out = tmp_path_factory.mktemp("tf")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TF_CPP_MIN_LOG_LEVEL"] = "2"
    jax_env = {k: v for k, v in env.items() if k != "JAX_PLATFORMS"}
    jobs = {
        "jax": subprocess.Popen(
            [sys.executable, os.path.join(REPO, "bin", "hvdrun"), "-np",
             "2", sys.executable, WORKER, "horovod_tpu", str(out / "jax")],
            env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
             sys.executable, WORKER, "horovod_tpu_torch",
             str(out / "port")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO)}
    logs = {name: job.communicate(timeout=300)[0]
            for name, job in jobs.items()}
    loaded = {}
    for name, job in jobs.items():
        assert job.returncode == 0 and \
            logs[name].count("TF_WORKER_OK") == 2, \
            f"{name} job: exit {job.returncode}\n{logs[name][-4000:]}"
        loaded[name] = []
        for r in range(2):
            with np.load(out / name / f"rank{r}.npz") as data:
                loaded[name].append({k: data[k] for k in data.files})
    return loaded


def _tolerance(key):
    if key.startswith(("matrix.float16", "matrix.bfloat16", "compression.")):
        return 0.05
    if key.split(".")[0] in MODEL_SCENARIOS:
        return 1e-6
    return 0.0


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_port_matches_the_jax_binding(results, scenario):
    for r in range(2):
        want = {k: v for k, v in results["jax"][r].items()
                if k.startswith(scenario + ".")}
        got = {k: v for k, v in results["port"][r].items()
               if k.startswith(scenario + ".")}
        assert want and sorted(got) == sorted(want), (scenario, sorted(got))
        for key, value in want.items():
            rtol = _tolerance(key)
            if rtol and value.dtype.kind == "f":
                np.testing.assert_allclose(got[key], value, rtol=rtol,
                                           err_msg=f"rank {r} {key}")
            else:
                np.testing.assert_array_equal(got[key], value,
                                              err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("scenario", MODEL_SCENARIOS)
def test_port_ranks_hold_the_same_weights(results, scenario):
    ranks = results["port"]
    for key, value in ranks[0].items():
        if key.startswith(scenario + "."):
            np.testing.assert_array_equal(ranks[1][key], value, err_msg=key)


def test_port_checks_hold(results):
    """What each scenario asserts besides its values."""
    for res in results["port"]:
        assert all(res[f"errors.{frag}"] for frag in ("shape", "dtype", "op"))
        np.testing.assert_array_equal(res["errors.recovered"], [2.0] * 3)
        assert res["bpps.unchanged"]
        # the compiled learning rate again after warmup and the schedule
        np.testing.assert_allclose(res["fit.lr"], 0.05, rtol=1e-6)
        assert res["load_model.wrapped"] and res["load_model.same"]
        assert str(res["load_model.class"]) == "DistributedSGD"
        assert res["keras_ops.tf1_type_error"]
        assert int(res["collectives.object"]) == 3
