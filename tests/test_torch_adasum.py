"""The port's Adasum (``horovod_tpu_torch/ops/adasum.py``, the eager
plane's ``op=Adasum`` and both gradient paths of ``optimizer.py``)
against the JAX package's.

- ``adasum_pair`` and ``adasum_reduce_stacked`` at n = 2, 4 and 8, in
  fp32 and bf16, with and without zero-norm operands, against the JAX
  functions and the float64 ``adasum_reference``; a count that is not a
  power of two raises the reference's words.
- One module-scoped scenario a world: 2 and 4 gloo ranks (subprocesses,
  rendezvous through a ``FileStore``), and 4 ranks with
  ``HVD_ADASUM_HIERARCHICAL=1``, ``HVD_HIER_LOCAL_SIZE=2``.  Each rank
  runs ``adasum_vhdd`` (held to the JAX ``adasum_vhdd`` under
  ``shard_map`` on as many CPU devices), ``adasum_reduce_hierarchical``
  (to the JAX function on a (cross 2, local 2) mesh), the eager plane's
  ``allreduce``, ``grouped_allreduce`` and ``allreduce_`` with
  ``op=Adasum`` in fp32, bf16 and fp16, with a joined rank and on a
  process group (to the JAX eager plane over a group of its 8 device
  ranks, and for the joined rank to the JAX ``adasum_reduce_stacked`` of
  the stack with that rank's zeros, which is what the JAX executor
  reduces), the validation errors (word for word the JAX
  ``validate_requests``'), ``allreduce_gradients(op=Adasum)`` with and
  without int8 (to ``jax_api.allreduce_gradients`` under ``shard_map``),
  and ``DistributedOptimizer(SGD / AdamW, op=Adasum)`` for three steps
  (to the JAX package's torch binding ``DistributedOptimizer(op=Adasum)``
  on its own 8 in-process ranks, each block of 8 / n ranks fed the same
  batches: Adasum of two equal vectors is that vector, exactly, so the
  first levels of its tree give the n-rank tree's leaves).  In the
  hierarchical world the eager plane is held to the JAX
  ``adasum_reduce_hierarchical``.  Every rank's result must be bitwise
  the same.

Tolerances: fp32 rtol 1e-4, atol 1e-5 (``tests/test_collectives.py:
253``, ``tests/test_spmd.py:136-195``); bf16 5e-2
(``tests/test_dtype_matrix.py:149``); fp16 1e-2 (the dtype matrix
allows 2e-2).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.common import basics as jax_basics
from horovod_tpu.ops import adasum as ja
from horovod_tpu.parallel import make_mesh
from horovod_tpu.parallel._compat import shard_map_unchecked

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum as ta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2),
       "float16": (1e-2, 1e-2)}
STEPS = 3


def _stack(n, k, seed, zeros=()):
    x = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    for i in zeros:
        x[i] = 0.0
    return x


# ------------------------------------------------------ the local functions
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_reduce_stacked_matches_jax_and_reference(n, dtype, zeros):
    x = _stack(n, 33, 10 * n, zeros=(1, n - 1) if zeros else ())
    got = ta.adasum_reduce_stacked(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    want = ja.adasum_reduce_stacked(jnp.asarray(x).astype(dtype))
    assert str(got.dtype) == f"torch.{dtype}"
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    ref = ja.adasum_reference(list(
        torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", ["random", "zero_a", "zero_b", "bf16"])
def test_pair_matches_jax(case):
    a, b = _stack(2, 17, 3).reshape(2, 1, 17)
    if case == "zero_a":
        a = np.zeros_like(a)
    if case == "zero_b":
        b = np.zeros_like(b)
    dtype = "bfloat16" if case == "bf16" else "float32"
    got = ta.adasum_pair(torch.from_numpy(a).to(getattr(torch, dtype)),
                         torch.from_numpy(b).to(getattr(torch, dtype)))
    want = ja.adasum_pair(jnp.asarray(a).astype(dtype),
                          jnp.asarray(b).astype(dtype))
    assert tuple(got.shape) == (1, 17)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    if case.startswith("zero"):   # plain addition
        np.testing.assert_array_equal(got.numpy(), a + b)


@pytest.mark.parametrize("n", [3, 5, 6])
def test_non_power_of_two_raises_the_references_words(n):
    x = _stack(n, 4, 0)
    with pytest.raises(ValueError) as got:
        ta.adasum_reduce_stacked(torch.from_numpy(x))
    with pytest.raises(ValueError) as want:
        ja.adasum_reduce_stacked(jnp.asarray(x))
    assert str(got.value) == str(want.value) == (
        f"Adasum requires a power-of-two rank count, got {n}")


def test_reduce_scatter_refuses_adasum_with_the_references_words():
    from horovod_tpu.ops import eager as jax_eager

    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError) as got:
            hvd.reduce_scatter(torch.ones(4), op=hvd.Adasum)
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError) as want:
        jax_eager.reduce_scatter_async(jnp.ones((4,)), op=hvd.Adasum,
                                       name="rs.adasum")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ gloo worlds
MODEL = textwrap.dedent('''
    import numpy as np
    import torch


    def make_model():
        # weights from numpy: the JAX binding's ranks are threads of one
        # process, which must not share torch's generator
        model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                                    torch.nn.Linear(5, 1))
        rng = np.random.RandomState(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(
                    rng.randn(*p.shape).astype(np.float32) * 0.5))
        return model


    def batch(seed, step):
        rng = np.random.RandomState(1000 * seed + step)
        x = rng.randn(8, 6).astype(np.float32)
        return torch.from_numpy(x), torch.from_numpy(
            x.sum(axis=1, keepdims=True) * 0.5)


    def make_optimizer(kind, model):
        if kind == "sgd":
            return torch.optim.SGD(model.parameters(), lr=0.1,
                                   momentum=0.9)
        return torch.optim.AdamW(model.parameters(), lr=0.05,
                                 weight_decay=1e-2)


    def branches(wrap, rank):
        """Two linear branches; rank 1's loss leaves the second unused,
        so its parameters get no gradient there.  ``wrap`` wraps the
        SGD optimizer (the identity for a local step).  -> the
        parameters after one step."""
        a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
        model = torch.nn.ModuleDict({"a": a, "b": b})
        rng = np.random.RandomState(5)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(rng.randn(*p.shape)
                                         .astype(np.float32)))
        opt = wrap(torch.optim.SGD(model.parameters(), lr=0.1), model)
        x = torch.from_numpy(np.random.RandomState(10 + rank).randn(4, 3)
                             .astype(np.float32))
        out = a(x) + (b(x) if rank == 0 else 0.0)
        opt.zero_grad()
        out.pow(2).mean().backward()
        opt.step()
        return [p.detach().clone().numpy() for p in model.parameters()]


    def train(hvd, kind, seed, steps):
        model = make_model()
        opt = hvd.DistributedOptimizer(
            make_optimizer(kind, model),
            named_parameters=model.named_parameters(), op=hvd.Adasum)
        out = []
        for s in range(steps):
            x, y = batch(seed, s)
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            opt.step()
            out.append([p.detach().clone().numpy()
                        for p in model.parameters()])
        return out
''')

WORKER = MODEL + textwrap.dedent('''
    import pickle
    import sys

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import groups, mpi_ops
    from horovod_tpu_torch.ops import adasum as ta


    def data(shape, seed, dt="float32"):
        x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
        return torch.from_numpy(x).to(getattr(torch, dt))


    def T(x):
        return str(x.dtype).replace("torch.", ""), \\
            x.detach().float().numpy().astype(np.float64)


    def err(fn):
        try:
            fn()
        except Exception as exc:
            return str(exc)
        return None


    torch.set_num_threads(1)
    store, out_path, hier = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
    hvd.init(device="cpu", store_path=store)
    r, n = hvd.rank(), hvd.size()
    res = {}
    try:
        if hier:
            g = hvd.grid(cross=n // 2, local=2)
            res["hier_fn"] = T(ta.adasum_reduce_hierarchical(
                data((33,), 200 + r), groups.torch_group(g.group("local")),
                groups.torch_group(g.group("cross"))))
            res["hier_eager"] = T(hvd.allreduce(
                data((40,), 210 + r), op=hvd.Adasum, name="ad.hier"))
            res["hier_grouped"] = [T(o) for o in hvd.grouped_allreduce(
                [data((9,), 220 + r), data((2, 3), 230 + r)],
                op=hvd.Adasum, name="ad.hier.g")]
        else:
            res["vhdd"] = [T(ta.adasum_vhdd(data((k,), 100 + k + r)))
                           for k in (64, 37)]
            for dt in ("float32", "bfloat16", "float16"):
                res["eager_" + dt] = T(hvd.allreduce(
                    data((16,), 300 + r, dt), op=hvd.Adasum,
                    name=f"ad.{dt}"))
            res["grouped"] = [T(o) for o in hvd.grouped_allreduce(
                [data((5,), 400 + r), data((3, 4), 410 + r),
                 data((7,), 420 + r, "bfloat16")],
                op=hvd.Adasum, name="ad.group")]
            a, b = data((6,), 500 + r), data((2, 2), 510 + r)
            hvd.allreduce_(a, op=hvd.Adasum, name="ad.inplace")
            mpi_ops.synchronize(mpi_ops.allreduce_async_(
                b, op=hvd.Adasum, name="ad.inplace.async"))
            res["inplace"] = [T(a), T(b)]
            h = None
            if r != n - 1:
                h = hvd.allreduce_async(data((12,), 600 + r),
                                        op=hvd.Adasum, name="ad.joined")
            hvd.join()
            res["joined"] = None if h is None else T(hvd.synchronize(h))
            members = [0, 1] if n == 2 else [1, 3]
            pg = hvd.new_group(members, name="adasum.members")
            res["group"] = (T(hvd.allreduce(data((10,), 700 + r),
                                            op=hvd.Adasum, group=pg,
                                            name="ad.pg"))
                            if r in members else None)
            ones = lambda shape, dt="float32": torch.ones(
                shape, dtype=getattr(torch, dt))
            res["errors"] = {
                "op": err(lambda: hvd.allreduce(
                    ones((3,)), op=hvd.Adasum if r == 0 else hvd.Sum,
                    name="ad.bad.op")),
                "shape": err(lambda: hvd.allreduce(
                    ones((3,) if r == 0 else (4,)), op=hvd.Adasum,
                    name="ad.bad.shape")),
                "dtype": err(lambda: hvd.allreduce(
                    ones((3,), "float32" if r == 0 else "float64"),
                    op=hvd.Adasum, name="ad.bad.dtype")),
                "next": T(hvd.allreduce(data((3,), 800 + r),
                                        op=hvd.Adasum, name="ad.after")),
            }
            for comp in ("none", "int8"):
                got = hvd.allreduce_gradients(
                    {"a": data((300,), 900 + r), "b": data((4, 5), 910 + r)},
                    op=hvd.Adasum,
                    compression=getattr(hvd.Compression, comp))
                res["grads_" + comp] = {k: T(v) for k, v in got.items()}
            for kind in ("sgd", "adamw"):
                res["do_" + kind] = train(hvd, kind, r, 3)
            if n == 2:
                res["do_unused"] = branches(
                    lambda opt, model: hvd.DistributedOptimizer(
                        opt, named_parameters=model.named_parameters(),
                        op=hvd.Adasum), r)
    finally:
        hvd.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
''')


def _launch(tmp, n, hier):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(n),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            if hier:
                env.update(HVD_ADASUM_HIERARCHICAL="1",
                           HVD_HIER_LOCAL_SIZE="2")
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp / "store"),
                 str(tmp / f"out{r}.pkl"), "1" if hier else "0"], env=env,
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
def worlds(tmp_path_factory):
    return {key: _launch(tmp_path_factory.mktemp(f"adasum{key}"), n, hier)
            for key, n, hier in [("2", 2, False), ("4", 4, False),
                                 ("4h", 4, True)]}


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


def _data(shape, seed, dt="float32"):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x).astype(dt)


def _np(x):
    a = np.asarray(x)
    return a.dtype.name, a.astype(np.float64)


def _shard_map(fn, axes, n, xs):
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    spec = P(tuple(axes)) if len(axes) > 1 else P(next(iter(axes)))
    out = jax.jit(shard_map_unchecked(
        lambda g: fn(g[0])[None], mesh=mesh, in_specs=(spec,),
        out_specs=P()))(jnp.stack(xs))
    return np.asarray(out)[0]


def _jax_group(jax_hvd, members):
    """One JAX process group a member list for the session (groups are
    capped)."""
    key = tuple(members)
    if key not in _JAX_GROUPS:
        _JAX_GROUPS[key] = jax_hvd.new_group(
            list(members), name="torch_adasum." + "-".join(map(str, key)))
    return _JAX_GROUPS[key]


_JAX_GROUPS = {}


def _jax_plane(jax_hvd, n, fn):
    """``fn(r, group)`` on the first ``n`` of the JAX eager plane's 8
    device ranks, over a group of them (its Adasum runs over the
    group)."""
    group = _jax_group(jax_hvd, range(n))
    return jax_basics.run_parallel(
        lambda r: fn(r, group) if r < n else None)[:n]


def _same(got, want, where):
    if isinstance(want, tuple) and len(want) == 2 \
            and isinstance(want[1], np.ndarray):
        assert got[0] == want[0], (where, got[0], want[0])
        rtol, atol = TOL[want[0]]
        np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=atol,
                                   err_msg=where)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _bitwise_across(results, case):
    outs = [res[case] for res in results if res[case] is not None]

    def flat(x):
        if isinstance(x, tuple) and len(x) == 2 \
                and isinstance(x[1], np.ndarray):
            return [x[1].tobytes()]
        if isinstance(x, dict):
            return [b for k in sorted(x) for b in flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [b for v in x for b in flat(v)]
        return [repr(x).encode()]

    first = flat(outs[0])
    for o in outs[1:]:
        assert flat(o) == first, f"{case}: ranks differ"


def _want_vhdd(n):
    return [_np(_shard_map(lambda g: ja.adasum_vhdd(g, "x"), {"x": n}, n,
                           [_data((k,), 100 + k + r) for r in range(n)]))
            for k in (64, 37)]


def _want_eager(jax_hvd, n, dt):
    return _jax_plane(jax_hvd, n, lambda r, g: _np(jax_hvd.allreduce(
        _data((16,), 300 + r, dt), op=jax_hvd.Adasum, name=f"ad.{dt}",
        group=g)))


def _want_grouped(jax_hvd, n):
    return _jax_plane(jax_hvd, n, lambda r, g: [_np(o) for o in
                      jax_hvd.grouped_allreduce(
                          [_data((5,), 400 + r), _data((3, 4), 410 + r),
                           _data((7,), 420 + r, "bfloat16")],
                          op=jax_hvd.Adasum, name="ad.group", group=g)])


def _want_inplace(jax_hvd, n):
    return _jax_plane(jax_hvd, n, lambda r, g: [
        _np(jax_hvd.allreduce(_data((6,), 500 + r), op=jax_hvd.Adasum,
                              name="ad.inplace", group=g)),
        _np(jax_hvd.allreduce(_data((2, 2), 510 + r), op=jax_hvd.Adasum,
                              name="ad.inplace.async", group=g))])


def _want_joined(n):
    """What the JAX executor reduces when rank n - 1 has joined: the
    stack with that rank's zeros."""
    xs = [np.asarray(_data((12,), 600 + r)) for r in range(n - 1)]
    stack = jnp.asarray(np.stack(xs + [np.zeros(12, np.float32)]))
    out = _np(ja.adasum_reduce_stacked(stack))
    np.testing.assert_allclose(out[1], ja.adasum_reference(list(stack)),
                               rtol=1e-4, atol=1e-5)
    return [out] * (n - 1) + [None]


def _want_group(jax_hvd, n):
    members = [0, 1] if n == 2 else [1, 3]
    group = _jax_group(jax_hvd, members)
    out = jax_basics.run_parallel(
        lambda r: _np(jax_hvd.allreduce(
            _data((10,), 700 + r), op=jax_hvd.Adasum, group=group,
            name="ad.pg")) if r in members else None)
    return out[:n]


def _want_grads(n, comp):
    from horovod_tpu import jax_api
    from horovod_tpu.common.compression import Compression
    from horovod_tpu.common.ops_enum import Adasum

    shapes = {"a": (300,), "b": (4, 5)}
    mesh = make_mesh({"hvd": n}, devices=jax.devices()[:n])
    stacked = {k: jnp.stack([_data(s, (900 if k == "a" else 910) + r)
                             for r in range(n)])
               for k, s in shapes.items()}
    fn = jax.jit(shard_map_unchecked(
        lambda g: jax_api.allreduce_gradients(
            {k: v[0] for k, v in g.items()}, named_axes=("hvd",),
            op=Adasum,
            compression=getattr(Compression, comp)),
        mesh=mesh, in_specs=(P("hvd"),), out_specs=P()))
    out = fn(stacked)
    return [{k: _np(v) for k, v in out.items()}] * n


def _want_do(jax_hvd, n, kind):
    """The JAX torch binding's ``DistributedOptimizer(op=Adasum)`` on its
    8 in-process ranks, rank r fed the batches of rank r // (8 / n)."""
    import horovod_tpu.torch as jt

    ns = {}
    exec(MODEL, ns)
    per = 8 // n
    out = jax_basics.run_parallel(
        lambda r: ns["train"](jt, kind, r // per, STEPS))
    for other in out[1:]:
        for a, b in zip(other, out[0]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    return [[[_np(p) for p in step] for step in out[0]]] * n


def _do_as_np(results):
    return [[[("float32", p.astype(np.float64)) for p in step]
             for step in res] for res in results]


CASES = ["vhdd", "eager_float32", "eager_bfloat16", "eager_float16",
         "grouped", "inplace", "joined", "group", "errors", "grads_none",
         "grads_int8", "do_sgd", "do_adamw"]


def _want(case, n, jax_hvd):
    if case == "vhdd":
        return [_want_vhdd(n)] * n
    if case.startswith("eager_"):
        return _want_eager(jax_hvd, n, case[6:])
    if case == "grouped":
        return _want_grouped(jax_hvd, n)
    if case == "inplace":
        return _want_inplace(jax_hvd, n)
    if case == "joined":
        return _want_joined(n)
    if case == "group":
        return _want_group(jax_hvd, n)
    if case.startswith("grads_"):
        return _want_grads(n, case[6:])
    return _want_do(jax_hvd, n, case[3:])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_adasum_case_matches_jax(case, n, worlds, jax_hvd):
    results = worlds[str(n)]
    if case == "errors":
        _check_errors(results, n)
        return
    want = _want(case, n, jax_hvd)
    got = ([res[case] for res in results] if not case.startswith("do_")
           else _do_as_np([res[case] for res in results]))
    for r in range(n):
        _same(got[r], want[r], f"{case} rank {r} of {n}")
    if case.startswith("do_"):
        for res in results[1:]:
            for a, b in zip(res[case], results[0][case]):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
    else:
        _bitwise_across(results, case)


def _check_errors(results, n):
    """The port's messages are the JAX ``validate_requests``' words for
    the same per-rank requests; the name after them reduces as Adasum."""
    from horovod_tpu.common.ops_enum import RequestType
    from horovod_tpu.ops.python_controller import (EagerRequest,
                                                   PythonController)

    def message(name, make):
        requests = {}
        for r in range(n):
            req_type, op, tensor = make(r)
            requests[r] = EagerRequest(rank=r, req_type=req_type, name=name,
                                       tensor=tensor, handle=None, op=op)
        return PythonController.validate_requests(name, requests, size=n,
                                                  joined=False)

    ad, ar = RequestType.ADASUM, RequestType.ALLREDUCE
    want = {
        "op": message("ad.bad.op", lambda r: (
            ad if r == 0 else ar, hvd.Adasum if r == 0 else hvd.Sum,
            np.ones(3, np.float32))),
        "shape": message("ad.bad.shape", lambda r: (
            ad, hvd.Adasum, np.ones((3,) if r == 0 else (4,), np.float32))),
        "dtype": message("ad.bad.dtype", lambda r: (
            ad, hvd.Adasum, np.ones(3, np.float32 if r == 0
                                    else np.float64))),
    }
    assert want["op"].startswith("mismatched collective types")
    after = ja.adasum_reference([np.random.RandomState(800 + r).randn(3)
                                 .astype(np.float32) for r in range(n)])
    for r, res in enumerate(results):
        for k, text in want.items():
            assert res["errors"][k] == text, (r, k, res["errors"][k], text)
        np.testing.assert_allclose(res["errors"]["next"][1], after,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["hier_fn", "hier_eager", "hier_grouped"])
def test_hierarchical_matches_jax(case, worlds):
    """4 ranks as (cross 2, local 2): the port's function and its eager
    plane under ``HVD_ADASUM_HIERARCHICAL`` against the JAX
    ``adasum_reduce_hierarchical`` on the same mesh, and against Adasum
    of the local groups' averages."""
    results = worlds["4h"]
    specs = {"hier_fn": [((33,), 200)], "hier_eager": [((40,), 210)],
             "hier_grouped": [((9,), 220), ((2, 3), 230)]}[case]
    want = []
    for shape, seed in specs:
        xs = [_data(shape, seed + r) for r in range(4)]
        out = _shard_map(ja.adasum_reduce_hierarchical,
                         {"cross": 2, "local": 2}, 4, xs)
        groups = [(np.asarray(xs[0]) + np.asarray(xs[1])) / 2,
                  (np.asarray(xs[2]) + np.asarray(xs[3])) / 2]
        np.testing.assert_allclose(out, ja.adasum_reference(groups),
                                   rtol=1e-4, atol=1e-5)
        want.append(_np(out))
    if case != "hier_grouped":
        want = want[0]
    for r, res in enumerate(results):
        _same(res[case], want, f"{case} rank {r}")
    _bitwise_across(results, case)


def test_adasum_optimizer_with_a_parameter_unused_on_one_rank(worlds):
    """ROADMAP C.11: the JAX torch binding's Adasum optimizer reduces the
    changes of the parameters that have a gradient on this rank, so a
    rank whose loss leaves a parameter unused never submits its name and
    the others wait for it.  The port submits every parameter that
    requires a gradient (a zero change where it has none), and Adasum's
    zero-norm guard makes the unused side plain addition: the result is
    each rank's local step combined by ``adasum_reference``."""
    ns = {}
    exec(MODEL, ns)
    local = [ns["branches"](lambda opt, model: opt, r) for r in range(2)]
    start = ns["branches"](lambda opt, model: _NoStep(opt), 0)
    results = worlds["2"]
    for i, p0 in enumerate(start):
        deltas = [local[r][i] - p0 for r in range(2)]
        want = p0 + ja.adasum_reference(deltas)
        for r in range(2):
            np.testing.assert_allclose(results[r]["do_unused"][i], want,
                                       rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(local[1][2], start[2])   # b unused there
    for a, b in zip(results[0]["do_unused"], results[1]["do_unused"]):
        np.testing.assert_array_equal(a, b)


class _NoStep:
    """An optimizer whose step does nothing: the starting parameters."""

    def __init__(self, opt):
        self.opt = opt

    def zero_grad(self):
        self.opt.zero_grad()

    def step(self):
        pass
