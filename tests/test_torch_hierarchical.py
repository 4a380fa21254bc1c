"""The eager plane's hierarchical allreduce and allgather
(``horovod_tpu_torch/ops/nccl_executor.py``, the ``(cross, local)`` grid
``hvd.init`` makes under ``HVD_HIERARCHICAL_ALLREDUCE`` /
``HVD_HIERARCHICAL_ALLGATHER``) against the JAX executor's
(``xla_executor.py:314-331, 380-425, 465-473``).

One 4-rank world a side, started together: the port's 4 gloo ranks
through its launcher with ``HVD_HIER_LOCAL_SIZE=2`` (2 x 2), and the JAX
eager plane on 4 CPU devices with the same variables, run as
``tests/test_hierarchical.py`` runs it.  Each runs the allreduce
(compression none, bf16, fp16 and int8 on fp32 tensors; an aligned size
of 512 elements and a 13-element one), a grouped allreduce, int32
allreduces and allgathers with uneven first dimensions.  The port's
ranks then run the same calls on the flat path.

Tolerances: integers bitwise; fp32 rtol 1e-4, atol 1e-5
(``tests/test_hierarchical.py``); bf16 5e-2 and fp16 1e-2 on the wire
(``tests/test_dtype_matrix.py``); int8 against the JAX executor's int8
within fp32's tolerance, and against the flat int8 path within the
block bound ``(n + 1) * blockmax / 254`` for each path, so twice that.
Every rank must hold the same bytes.  The degenerate local sizes fall
back to flat with the JAX executor's warning, word for word.
"""

import logging
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
TOL = {"none": (1e-4, 1e-5), "bf16": (5e-2, 5e-2), "fp16": (1e-2, 1e-2),
       "int8": (1e-4, 1e-5)}
SHAPES = [(4, 128), (13,)]
COMPRESSIONS = ["none", "bf16", "fp16", "int8"]

# the cases, written once for both packages' workers: ``hvd`` is the
# package, ``T`` makes its tensor from a numpy array, ``A`` a numpy array
# from its result
CASES = r"""
def cases(hvd, T, A, r, tag=""):
    out = {}
    for comp in COMPRESSIONS:
        for shape in SHAPES:
            x = np.random.RandomState(10 * len(shape) + r).randn(*shape)
            out[("ar", comp, shape)] = A(hvd.allreduce(
                T(x.astype(np.float32)), op=hvd.Sum,
                name=f"h.{comp}.{len(shape)}{tag}", compression=comp))
    for shape in SHAPES:
        x = np.random.RandomState(50 + r).randint(-1000, 1000, shape)
        out[("int", shape)] = A(hvd.allreduce(
            T(x.astype(np.int32)), op=hvd.Sum, name=f"h.int.{len(shape)}{tag}"))
    out["grouped"] = [A(o) for o in hvd.grouped_allreduce(
        [T(np.random.RandomState(100 + r).randn(5).astype(np.float32)),
         T(np.random.RandomState(200 + r).randn(3, 3).astype(np.float32))],
        op=hvd.Sum, name="h.grouped" + tag)]
    out["gather"] = A(hvd.allgather(
        T(np.full((r + 1, 3), float(r), np.float32)), name="h.gather" + tag))
    out["gather_int"] = A(hvd.allgather(
        T(np.arange(2 * (N - r)).reshape(N - r, 2).astype(np.int32)
          + 100 * r), name="h.gather.int" + tag))
    return out
"""

PORT_WORKER = r"""
import pickle, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics

torch.set_num_threads(1)
hvd.init(device="cpu")
r = hvd.rank()
ex = basics._get_state().controller._executor
assert ex.hier is not None and ex.hier[2] == 2, ex.hier
assert ex.hierarchical_allreduce and ex.hierarchical_allgather
T = lambda x: torch.from_numpy(np.ascontiguousarray(x))
A = lambda t: t.numpy()
res = {"hier": cases(hvd, T, A, r), "wires": dict(ex.wires)}
# the flat path on the same calls: every rank switches before its next
# submission, so the next collective runs flat on every rank
ex.hierarchical_allreduce = ex.hierarchical_allgather = False
res["flat"] = cases(hvd, T, A, r, ".flat")
hvd.shutdown()
with open(sys.argv[1] + f".{r}", "wb") as f:
    pickle.dump(res, f)
"""

JAX_WORKER = r"""
import pickle, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import horovod_tpu as hvd
from horovod_tpu.common import basics

hvd.init()
state = basics._get_state()
assert dict(zip(state.executor.hier_mesh.axis_names,
                state.executor.hier_mesh.devices.shape)) == \
    {"cross": 2, "local": 2}
assert state.executor.hierarchical_allreduce
assert state.executor.hierarchical_allgather
T = lambda x: jnp.asarray(x)
A = lambda t: np.asarray(t)
res = basics.run_parallel(lambda r: cases(hvd, T, A, r))
hvd.shutdown()
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""


def _script(tmp, name, body):
    path = tmp / name
    head = (f"import numpy as np\nN = {N}\nSHAPES = {SHAPES!r}\n"
            f"COMPRESSIONS = {COMPRESSIONS!r}\n")
    # the imports of the body first, then the cases, then the body
    imports, _, rest = body.partition("\n\n")
    path.write_text(imports + "\n" + head + CASES + "\n" + rest)
    return path


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_hier")
    hier = {"HVD_HIERARCHICAL_ALLREDUCE": "1",
            "HVD_HIERARCHICAL_ALLGATHER": "1", "HVD_HIER_LOCAL_SIZE": "2"}
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("HVD_", "XLA_"))}
    path = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    port = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(N),
         sys.executable, str(_script(tmp, "port_worker.py", PORT_WORKER)),
         str(tmp / "port.pkl")],
        env=dict(base, PYTHONPATH=path, OMP_NUM_THREADS="1", **hier),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    jax_env = dict(base, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
                   **hier)
    from tests.conftest import readd_jax_cache
    readd_jax_cache(jax_env)
    ref = subprocess.Popen(
        [sys.executable, str(_script(tmp, "jax_worker.py", JAX_WORKER)),
         str(tmp / "jax.pkl")], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        for proc in (port, ref):
            out = proc.communicate(timeout=180)[0]
            assert proc.returncode == 0, out[-4000:]
    finally:
        for proc in (port, ref):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ports = []
    for r in range(N):
        with open(tmp / f"port.pkl.{r}", "rb") as f:
            ports.append(pickle.load(f))
    with open(tmp / "jax.pkl", "rb") as f:
        return ports, pickle.load(f)


def _keys():
    return ([("ar", c, s) for c in COMPRESSIONS for s in SHAPES]
            + [("int", s) for s in SHAPES]
            + ["grouped", "gather", "gather_int"])


@pytest.mark.parametrize("key", _keys(), ids=str)
def test_hierarchical_matches_jax_and_flat(key, worlds):
    ports, jax_res = worlds
    got = [p["hier"][key] for p in ports]
    flat = [p["flat"][key] for p in ports]
    want = [j[key] for j in jax_res]
    for r in range(N):
        g, w, f = got[r], want[r], flat[r]
        if isinstance(key, tuple) and key[0] == "int" \
                or key == "gather_int" or key == "gather":
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, f)
            continue
        if key == "grouped":
            for gi, wi, fi in zip(g, w, f):
                np.testing.assert_allclose(gi, wi, rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(gi, fi, rtol=1e-4, atol=1e-5)
            continue
        _, comp, shape = key
        assert g.shape == tuple(shape) and g.dtype == np.float32
        rtol, atol = TOL[comp]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        if comp == "int8":
            xs = np.stack([np.random.RandomState(10 * len(shape) + q)
                           .randn(*shape).astype(np.float32)
                           for q in range(N)]).reshape(N, -1)
            exact = xs.sum(0)
            blocks = -(-exact.size // 256) * 256
            mag = np.pad(np.abs(xs).sum(0), (0, blocks - exact.size))
            blockmax = np.repeat(mag.reshape(-1, 256).max(1), 256)
            bound = 2 * (N + 1) * blockmax[:exact.size] / 254
            assert (np.abs(g.reshape(-1) - f.reshape(-1))
                    <= bound + 1e-6).all()
        else:
            np.testing.assert_allclose(g, f, rtol=rtol, atol=atol)
    # the same bytes on every rank, on each path
    for results in (got, flat):
        blobs = [pickle.dumps(x) for x in results]
        assert blobs.count(blobs[0]) == N, key


def test_the_int8_path_ran_hierarchically(worlds):
    ports, _ = worlds
    for p in ports:
        assert p["wires"].get("int8", 0) >= 1, p["wires"]


@pytest.mark.parametrize("local", [1, 3, 4, 0])
def test_degenerate_local_sizes_stay_flat_with_the_jax_warning(local):
    """``HVD_HIER_LOCAL_SIZE`` = 1, 3, 4 over 4 ranks (and unset with the
    launcher's local size 4) gives no hierarchy; an explicit one warns as
    the JAX executor does."""
    import jax

    from horovod_tpu.ops.xla_executor import XlaExecutor

    from horovod_tpu_torch.common import basics

    def captured(name, fn):
        records = []
        handler = logging.Handler()
        handler.emit = lambda rec: records.append(rec.getMessage())
        logger = logging.getLogger(name)
        logger.addHandler(handler)
        try:
            out = fn()
        finally:
            logger.removeHandler(handler)
        return out, records

    cfg = types.SimpleNamespace(hierarchical_allreduce=True,
                                hierarchical_allgather=False,
                                autotune=False, hier_local_size=local)
    got, port_msgs = captured("horovod_tpu_torch", lambda: (
        basics._hier_local_size(N, 4, cfg)))
    assert got is None
    ex, jax_msgs = captured("horovod_tpu", lambda: XlaExecutor(
        jax.devices()[:N], hier_local_size=local or None))
    assert ex.hier_mesh is None
    assert port_msgs == jax_msgs
    assert bool(port_msgs) == bool(local)
    # no hierarchical switch and no tuner: no grid; the tuner alone
    # makes one at the launcher's local size
    cfg.hier_local_size = 0
    cfg.hierarchical_allreduce = False
    assert basics._hier_local_size(N, 2, cfg) is None
    cfg.autotune = True
    assert basics._hier_local_size(N, 2, cfg) == 2
