"""The port's MXNet binding against the JAX package's, over the numpy
stand-in ``tests/_mxnet_shim`` (MXNet is end of life upstream and
installed nowhere), and the host bridge under every framework binding
(``horovod_tpu_torch/common/host_bridge.py``).

``tests/torch_mx_worker.py`` runs the same scenarios in the JAX binding
on four device ranks (``run_parallel``) and in the port's on four gloo
ranks through ``python -m horovod_tpu_torch.run``; both start at once.
Inputs are multiples of 1/64, so that sums are exact in any order and
every result is held bitwise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIM = os.path.join(REPO, "tests", "_mxnet_shim")
WORKER = os.path.join(REPO, "tests", "torch_mx_worker.py")
SCENARIOS = ("coll", "opt", "trainer", "bcast")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """-> {"jax": [rank 0..3], "port": [...]}, each rank's results."""
    out = tmp_path_factory.mktemp("mx")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SHIM, REPO, env.get("PYTHONPATH", "")])
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = {
        "jax": subprocess.Popen(
            [sys.executable, WORKER, "horovod_tpu", str(out / "jax")],
            env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "4",
             sys.executable, WORKER, "horovod_tpu_torch",
             str(out / "port")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO)}
    logs = {name: job.communicate(timeout=240)[0]
            for name, job in jobs.items()}
    loaded = {}
    for name, job in jobs.items():
        assert job.returncode == 0 and "MX_WORKER_OK" in logs[name], \
            f"{name} job: exit {job.returncode}\n{logs[name][-4000:]}"
        loaded[name] = []
        for r in range(4):
            with np.load(out / name / f"rank{r}.npz") as data:
                loaded[name].append({k: data[k] for k in data.files})
    return loaded


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_port_matches_the_jax_binding(results, scenario):
    for r in range(4):
        want = {k: v for k, v in results["jax"][r].items()
                if k.startswith(scenario + ".")}
        got = {k: v for k, v in results["port"][r].items()
               if k.startswith(scenario + ".")}
        assert want and sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value,
                                          err_msg=f"rank {r} {key}")


def test_port_checks_hold(results):
    """The guards and the values each scenario implies."""
    ranks = results["port"]
    for res in ranks:
        for flag in ("coll.source_untouched", "opt.state_none",
                     "opt.double_wrap", "trainer.kvstore_none",
                     "trainer.double_wrap", "bcast.rejects_list"):
            assert res[flag], flag
        np.testing.assert_array_equal(res["coll.int_sum"],
                                      np.arange(5) * 10)
        # torch.distributed's gloo carries the port's bytes; no MPI
        assert res["probes.gloo"] and not res["probes.mpi"]
        assert res["probes.homogeneous"] and not res["probes.threads"]
        assert float(res["opt.lr"]) == 0.2
        # rank 3's values everywhere, the deferred parameter's too
        for key in ("bcast.a", "bcast.b", "bcast.deferred"):
            np.testing.assert_array_equal(res[key], ranks[3][key])
    for key in ranks[0]:
        if key.startswith(("opt.", "trainer.")):
            for res in ranks[1:]:
                np.testing.assert_array_equal(res[key], ranks[0][key])


def test_optimizer_and_trainer_average_the_gradients(results):
    """SGD on the mean of the ranks' gradients, in numpy."""
    sys.path.insert(0, os.path.dirname(WORKER))
    try:
        from torch_mx_worker import values
    finally:
        sys.path.pop(0)
    res = results["port"][0]
    mean = np.mean([values(r, 8, (4,)) for r in range(4)], axis=0)
    np.testing.assert_allclose(res["opt.index"],
                               values(0, 7, (4,)) - 0.1 * mean, rtol=1e-6)
    for i in range(2):
        mean = np.mean([values(r, 30 + i, (3,)) for r in range(4)], axis=0)
        # step(batch_size=2) rescales by 1 / (size * 2)
        np.testing.assert_allclose(res[f"trainer.w{i}"],
                                   values(0, 20 + i, (3,)) - 0.25 * mean,
                                   rtol=1e-6)
    # each context's gradient of a parameter is summed on its own
    for i in range(2):
        for j in range(2):
            np.testing.assert_array_equal(
                res[f"trainer.ctx{i}.{j}"],
                sum(values(r, 52 + 2 * i + j, (3,)) for r in range(4)))
    # a parameter with grad_req "null" is neither exchanged nor stepped
    np.testing.assert_array_equal(res["trainer.w2"], values(0, 22, (3,)))


# ------------------------------------------------------------ the bridge
@pytest.fixture
def bridge(monkeypatch):
    from horovod_tpu_torch.common import basics, host_bridge

    monkeypatch.setattr(basics, "device", lambda: torch.device("cpu"))
    host_bridge.reset_stats()
    return host_bridge


def test_bridge_round_trips_bfloat16_without_ml_dtypes_in_the_port(bridge):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = (np.arange(12, dtype=np.float32) / 8 - 0.7).reshape(3, 4)
    b = a.astype(ml_dtypes.bfloat16)
    t = bridge.to_device(b)
    assert t.dtype == torch.bfloat16
    torch.testing.assert_close(t, torch.from_numpy(a).to(torch.bfloat16),
                               rtol=0, atol=0)
    back = bridge.to_host(t, b.dtype)
    assert back.dtype == b.dtype and back.shape == b.shape
    np.testing.assert_array_equal(back.view(np.int16), b.view(np.int16))
    # numpy's own name for the same bits, as np.savez writes them
    v2 = bridge.to_host(t, np.dtype("V2"))
    assert v2.dtype == np.dtype("V2")
    np.testing.assert_array_equal(v2.view(np.int16), b.view(np.int16))
    # a float32 result asked for as bfloat16 is rounded, not reinterpreted
    np.testing.assert_array_equal(
        bridge.to_host(torch.from_numpy(a), b.dtype).view(np.int16),
        b.view(np.int16))


@pytest.mark.parametrize("case", ["read_only", "strided", "zero_d", "bool"])
def test_bridge_makes_a_private_tensor(bridge, case):
    if case == "read_only":
        a = np.arange(6, dtype=np.float64)
        a.flags.writeable = False
    elif case == "strided":
        a = np.arange(24, dtype=np.int32).reshape(4, 6)[::-1, ::2]
    elif case == "zero_d":
        a = np.array(2.5, dtype=np.float32)
    else:
        a = np.array([True, False, True])
    t = bridge.to_device(a)
    assert tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.numpy(), a)
    # the tensor owns its memory: neither side sees the other's writes
    if a.flags.writeable:
        before = a.copy()
        t.view(-1)[0] = 0 if case != "bool" else False
        np.testing.assert_array_equal(a, before)
    out = bridge.to_host(t, a.dtype)
    assert out.dtype == a.dtype and out.shape == a.shape


def test_bridge_counts_both_directions(bridge):
    a = np.ones((1024,), np.float32)
    t = bridge.to_device(a)
    bridge.to_host(t, a.dtype)
    bridge.to_host(t, a.dtype)
    stats = bridge.stats()
    assert stats["to_device"]["calls"] == 1
    assert stats["to_device"]["bytes"] == 4096
    assert stats["to_host"]["calls"] == 2
    assert stats["to_host"]["bytes"] == 8192
    assert stats["to_device"]["seconds"] > 0
    bridge.reset_stats()
    assert bridge.stats()["to_host"]["calls"] == 0


def test_store_shares_the_bridge_bfloat16_code():
    """``cluster/store.py`` reads and writes ``|V2`` through the bridge's
    functions, which live in a leaf module (``common/arrays.py``, numpy and
    torch alone) so that the store does not depend on the eager plane: a
    bfloat16 column survives the file."""
    import ast

    from horovod_tpu_torch.cluster import store
    from horovod_tpu_torch.common import arrays, host_bridge

    for name in ("is_bf16", "tensor_from_array", "array_from_tensor"):
        assert getattr(store, name) is getattr(arrays, name)
        assert getattr(host_bridge, name) is getattr(arrays, name)

    def imported(module):
        tree = ast.parse(open(module.__file__).read())
        return {n.module if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names}

    assert imported(arrays) == {"numpy", "torch"}
    assert not {m for m in imported(store)
                if m.startswith(("horovod_tpu_torch.ops",
                                 "horovod_tpu_torch.common.host_bridge"))}

    t = torch.linspace(-2, 2, 10).to(torch.bfloat16)
    arr = store.to_numpy(t)
    assert arr.dtype == np.dtype("V2")
    back = store.from_numpy(arr)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
