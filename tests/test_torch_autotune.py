"""The port's autotuner (``horovod_tpu_torch/common/autotune.py``,
``ops/autotune.py``) against the JAX package's (``horovod_tpu/common/
autotune.py``, the ctypes face of ``csrc/hvd/parameter_manager.cc`` and
``csrc/hvd/optim/``) as oracle.

- ``GaussianProcess``, ``expected_improvement`` and
  ``BayesianOptimizer`` on the inputs of ``tests/test_autotune.py:
  53-118``: the port computes in float64 in the C++ core's order, so the
  tolerance is exact equality (rel 0).
- ``ParameterManager`` fed one synthetic ``(bytes, time)`` sequence in
  both packages publishes the same values after every update and writes
  the same CSV rows.  Where it departs from the JAX package: the port
  has no TCP data plane, so its walk is the C++ walk with
  ``ring_tunable`` and ``schedule_tunable`` off, and its rows lack the
  last three columns (``ring_segment_bytes``, ``ring_stripes``,
  ``schedule``), which the comparison drops from the JAX rows.
  ``AutotuneManager``'s snapshot lacks the same three keys.
- At 2 gloo ranks through the port's launcher, ``HVD_AUTOTUNE=1``: every
  rank applies the same ``(seq)`` at the same cycle and reports the same
  ``tuned_params()``, the walk ends pinned, and rank 0's CSV has a row a
  sample (``test_tcp_autotune_synchronized_across_ranks``, :346).
"""

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from horovod_tpu.common import autotune as jat
from horovod_tpu.ops import autotune as jops

from horovod_tpu_torch.common import autotune as tat
from horovod_tpu_torch.ops import autotune as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RING_KEYS = ("ring_segment_bytes", "ring_stripes", "schedule")


@pytest.mark.parametrize("length_scale,signal_var,noise_var", [
    (1.0, 1.0, 1e-6), (0.5, 2.0, 1e-3), (2.0, 0.7, 0.1)])
def test_gp_matches_jax(length_scale, signal_var, noise_var):
    rng = np.random.RandomState(42)
    x = rng.uniform(-2, 2, size=(12, 3))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] - 0.5 * x[:, 2] ** 2
    got = tat.GaussianProcess(length_scale, signal_var, noise_var).fit(x, y)
    want = jat.GaussianProcess(length_scale, signal_var, noise_var).fit(x, y)
    for q in rng.uniform(-2, 2, size=(8, 3)):
        assert got.predict(q) == want.predict(q)
    one = tat.GaussianProcess(1.0, 1.0, 1e-10).fit([0.0, 1.0, 2.0],
                                                  [1.0, -1.0, 0.5])
    assert one.predict([1.0]) == jat.GaussianProcess(1.0, 1.0, 1e-10).fit(
        [0.0, 1.0, 2.0], [1.0, -1.0, 0.5]).predict([1.0])
    with pytest.raises(ValueError, match="samples but y has"):
        tat.GaussianProcess().fit(x, y[:3])


def test_expected_improvement_matches_jax():
    for mean, sd, best in [(1.0, 0.5, 0.8), (0.0, 1.0, 2.0), (3.0, 0.0, 1.0),
                           (-1.0, 0.2, -0.5), (2.0, 0.0, 3.0),
                           (0.0, 0.0, 1.0), (0.0, 1.0, 5.0)]:
        assert tat.expected_improvement(mean, sd, best) == \
            jat.expected_improvement(mean, sd, best)


@pytest.mark.parametrize("dims", [1, 2])
def test_bayesian_optimizer_walks_as_jax(dims):
    """25 suggestions of each, fed the same observations."""
    low, high = ([0.0], [8.0]) if dims == 1 else ([0.0, 1.0], [8.0, 25.0])
    got = tat.BayesianOptimizer(low, high, gp_noise=1e-4)
    want = jat.BayesianOptimizer(low, high, gp_noise=1e-4)
    for _ in range(25):
        x = want.suggest()
        np.testing.assert_array_equal(got.suggest(), x)
        y = -(x[0] - 3.2) ** 2 - 0.01 * x[-1]
        got.add_sample(x, y)
        want.add_sample(x, y)
        assert got.best_y == want.best_y
        assert all(lo <= v <= hi for v, lo, hi in zip(x, low, high))


def _bell(fusion_bytes):
    mb = fusion_bytes / (1024 * 1024)
    return 1e9 * math.exp(-((math.log2(max(mb, 1e-9)) - 5.0) ** 2) / 8.0)


def _drive(pm, steps=5000):
    """The walk of ``tests/test_autotune.py:119``: bytes a window in
    proportion to a bell over log2(fusion MB); -> the values after every
    update."""
    t, seen = 0.0, []
    for _ in range(steps):
        if not pm.tuning:
            break
        t += 0.01
        pm.record(int(_bell(pm.fusion_threshold_bytes) * 0.01))
        changed = pm.update(t)
        seen.append((changed, pm.fusion_threshold_bytes, pm.cycle_time_ms,
                     pm.hierarchical_allreduce, pm.hierarchical_allgather,
                     pm.cache_enabled, pm.compression_enabled, pm.tuning,
                     pm.best_score))
    return seen


@pytest.mark.parametrize("kw", [
    {},
    {"compression": True, "compression_available": True},
    {"hierarchical_allreduce": True, "cache_enabled": False,
     "fusion_threshold_bytes": 8 << 20, "cycle_time_ms": 5.0},
], ids=["default", "compression", "seeded"])
def test_parameter_manager_walks_as_jax(tmp_path, kw):
    args = dict(warmup_samples=1, steady_state_samples=3,
                bayes_opt_max_samples=5, gp_noise=0.1, **kw)
    got = tat.ParameterManager(log_path=str(tmp_path / "port.csv"), **args)
    want = jat.ParameterManager(log_path=str(tmp_path / "jax.csv"), **args)
    seq = _drive(got)
    assert seq == _drive(want)
    assert not seq[-1][7], "the walk did not pin"
    got.close()
    del want   # the native handle's destructor closes its CSV
    rows = (tmp_path / "port.csv").read_text().splitlines()
    jax_rows = (tmp_path / "jax.csv").read_text().splitlines()
    assert [r.rsplit(",", 3)[0] for r in jax_rows] == rows
    assert len(rows) == 1 + sum(1 for s in seq if s[0])


def test_parameter_manager_warmup_and_seeding_match_jax():
    for mod in (tat, jat):
        pm = mod.ParameterManager(warmup_samples=2, steady_state_samples=2,
                                  bayes_opt_max_samples=3)
        t, observations = 0.0, 0
        for _ in range(5):
            t += 1.0
            pm.record(1000)
            observations += pm.update(t)
        assert observations == 1
    seeded = dict(hierarchical_allreduce=True, hierarchical_allgather=True,
                  cache_enabled=False)
    for mod in (tat, jat):
        pm = mod.ParameterManager(**seeded)
        assert (pm.hierarchical_allreduce, pm.hierarchical_allgather,
                pm.cache_enabled) == (True, True, False)
        pm = mod.ParameterManager()
        assert (pm.hierarchical_allreduce, pm.cache_enabled) == (False, True)


def _config(**kw):
    base = dict(autotune=True, autotune_warmup_samples=1,
                autotune_steady_state_samples=2,
                autotune_bayes_opt_max_samples=3,
                autotune_gaussian_process_noise=0.8, autotune_log="",
                fusion_threshold_bytes=64 * 1024 * 1024, cycle_time_ms=1.0,
                hierarchical_allreduce=True, hierarchical_allgather=True,
                compression="none")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_autotune_manager_publishes_as_jax(compression):
    """The first publication keeps the configured hierarchical switches
    (``test_autotune.py:481``), and the snapshots agree with the JAX
    manager's on its keys but the ring and schedule ones."""
    cfg = _config(compression=compression)
    got, want = tops.AutotuneManager(cfg), jops.AutotuneManager(cfg)
    try:
        g, w = got.maybe_update(), want.maybe_update()
        assert g[0] == w[0] == 1
        assert g[1]["hierarchical_allreduce"] is True
        assert g[1]["hierarchical_allgather"] is True
        assert g[1] == {k: v for k, v in w[1].items() if k not in _RING_KEYS}
        assert got.maybe_update() is None
        assert set(tops.default_params(cfg)) == set(g[1])
    finally:
        got.close()
        want.close()
    assert tops.AutotuneManager.create(_config(autotune=False)) is None


WORKER = r"""
import json, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics

hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
controller = basics._get_state().controller
assert controller.tuned_params()["tuning"] is False   # nothing applied yet
seen = []
for s in range(int(sys.argv[1])):
    out = hvd.allreduce(torch.ones(256), op=hvd.Sum, name=f"tune.{s % 4}")
    assert out[0] == n
    seen.append(controller.tuned_params())
# one more collective, so that the last publication is applied
hvd.allreduce(torch.ones(8), op=hvd.Sum, name="tune.final")
res = {"applications": controller.tuned_applications(),
       "params": controller.tuned_params(), "steps": len(seen)}
hvd.shutdown()
print("RESULT " + json.dumps(res), flush=True)
"""


def test_autotune_synchronized_across_two_gloo_ranks(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    log = tmp_path / "autotune.csv"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               HVD_AUTOTUNE="1", HVD_AUTOTUNE_LOG=str(log),
               HVD_AUTOTUNE_WARMUP_SAMPLES="1",
               HVD_AUTOTUNE_STEADY_STATE_SAMPLES="1",
               HVD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES="3")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--output-filename", str(tmp_path / "logs"), sys.executable,
         str(script), "120"], env=env, capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    results = []
    for r in range(2):
        out = (tmp_path / "logs" / f"rank.{r}" / "stdout").read_text()
        results.append(json.loads(out.split("RESULT ", 1)[1]))
    a, b = results
    # the same sets applied at the same cycles, so the same values
    assert a["applications"] == b["applications"]
    assert a["params"] == b["params"]
    assert len(a["applications"]) >= 2
    assert a["params"]["tuning"] is False, "the walk did not pin"
    rows = log.read_text().strip().splitlines()
    assert rows[0].startswith("score_bytes_per_sec,")
    # five categoricals (the seed first) of three samples each
    assert len(rows) == 1 + 5 * 3
