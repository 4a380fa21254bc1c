"""The port's eager collective plane (its public surface
``horovod_tpu_torch.mpi_ops``, exported by the package, over
``ops/eager.py`` and ``ops/controller.py``) against the JAX package's
eager plane.

One module-scoped scenario: 8 gloo ranks in subprocesses (rendezvous
through a ``FileStore``) run the scripted cases of ``CASES`` in order, on
inputs made with numpy from seeds; the JAX side runs the same cases on
the same inputs in the JAX package's device-rank mode (8 ranks,
``basics.run_parallel``; initialised as the session ``hvd`` fixture
does, see ``jax_hvd``).  One test per case holds every rank's result
to the JAX rank's, as ``tests/test_collectives.py`` and
``tests/test_eager_semantics.py`` do: dtypes equal, fp32 within rtol
1e-5, bf16 within rtol 1e-2 (each with an absolute floor of the same
share of the tensor's largest entry, for sums that cancel), integers
exactly; error messages word for word.  The int8 cases are held to the
same tolerances: both planes quantize the same fused buffers and add the
ranks' contributions in the same order, so they agree to the last bit
or nearly."""

import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.common import basics as jax_basics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 8

# The scripted sequence, run by every rank on both sides.  ``hvd`` is the
# package under test, ``T`` turns numpy arrays into its tensors and back.
CASES = textwrap.dedent('''
    import numpy as np

    N = 8
    CASE_NAMES = [
        "average", "sum", "odd_shapes", "scales", "async_poll", "fusion",
        "burst", "grouped_mixed", "allgather", "broadcast", "alltoall",
        "reduce_scatter", "join", "join_orphan", "barrier", "out_of_order",
        "reuse", "broadcast_object", "errors", "int8", "int8_grouped",
        "int8_reduce_scatter", "int8_passthrough"]


    def data(shape, seed, kind="f"):
        rng = np.random.RandomState(seed)
        if kind == "i":
            return rng.randint(-1000, 1000, size=shape).astype(np.int32)
        return np.asarray(rng.randn(*shape), dtype=np.float32)


    def err(fn):
        try:
            fn()
        except Exception as exc:
            if type(exc).__name__ != "HvdError":
                raise
            return str(exc)
        return None


    def case_average(hvd, r, T):
        return {dt: T.np(hvd.allreduce(
            T.arr(data((4, 5), 100 + r, "i" if dt == "int32" else "f"), dt),
            name=f"te.avg.{dt}")) for dt in ("float32", "bfloat16", "int32")}


    def case_sum(hvd, r, T):
        return {dt: T.np(hvd.allreduce(
            T.arr(data((3, 4), 200 + r, "i" if dt == "int32" else "f"), dt),
            op=hvd.Sum, name=f"te.sum.{dt}"))
            for dt in ("float32", "bfloat16", "int32")}


    def case_odd_shapes(hvd, r, T):
        return [T.np(hvd.allreduce(T.arr(data(s, 300 + r), "float32"),
                                   op=hvd.Sum, name=f"te.odd.{i}"))
                for i, s in enumerate([(), (1,), (7,), (3, 5, 2)])]


    def case_scales(hvd, r, T):
        return [
            T.np(hvd.allreduce(T.arr(data((4,), r), "float32"), op=hvd.Sum,
                               name="te.scaled", prescale_factor=0.5,
                               postscale_factor=2.0)),
            T.np(hvd.allreduce(T.arr(data((4,), r), "float32"),
                               op=hvd.Average, name="te.scaled.avg",
                               prescale_factor=2.0, postscale_factor=0.5)),
            T.np(hvd.allreduce(T.arr(data((6,), r, "i"), "int32"),
                               op=hvd.Average, name="te.scaled.int",
                               prescale_factor=3.0, postscale_factor=0.5)),
        ]


    def case_async_poll(hvd, r, T):
        import time
        h = hvd.allreduce_async(
            T.arr(np.full((8,), float(r), np.float32), "float32"),
            op=hvd.Sum, name="te.async")
        while not hvd.poll(h):
            time.sleep(0.001)
        done = bool(hvd.poll(h))
        return [done, T.np(hvd.synchronize(h))]


    def case_fusion(hvd, r, T):
        handles = [hvd.allreduce_async(
            T.arr(data((5,), 1000 * r + i), "float32"), op=hvd.Sum,
            name=f"te.fuse.{i}") for i in range(32)]
        return [T.np(hvd.synchronize(h)) for h in handles]


    def case_burst(hvd, r, T):
        # 256 tensors in one submission: a cycle message longer than the
        # port's fixed slot, which takes its second exchange
        return [T.np(o) for o in hvd.grouped_allreduce(
            [T.arr(data((5,), 2000 * r + i), "float32") for i in range(256)],
            op=hvd.Sum, name="te.burst")]


    def case_grouped_mixed(hvd, r, T):
        outs = hvd.grouped_allreduce(
            [T.arr(data((3,), r), "float32"),
             T.arr(data((4,), r, "i"), "int32"),
             T.arr(data((2,), r), "bfloat16")], op=hvd.Sum, name="te.gmix")
        return [T.np(o) for o in outs]


    def case_allgather(hvd, r, T):
        out = [
            hvd.allgather(T.arr(data((2, 3), r), "float32"), name="te.ag.u"),
            hvd.allgather(T.arr(data((r + 1, 2), r), "float32"),
                          name="te.ag.v"),
            hvd.allgather(T.arr(data((r % 3 + 1, 2), r), "bfloat16"),
                          name="te.ag.bf16"),
        ]
        out += hvd.grouped_allgather(
            [T.arr(data((1, 2), r), "float32"),
             T.arr(data((r % 2 + 1,), r, "i"), "int32")], name="te.gag")
        return [T.np(x) for x in out]


    def case_broadcast(hvd, r, T):
        return [
            T.np(hvd.broadcast(T.arr(data((4,), r), "float32"), root_rank=3,
                               name="te.bc")),
            T.np(hvd.broadcast(T.arr(data((2, 3), r, "i"), "int32"),
                               root_rank=0, name="te.bc.int")),
        ]


    def case_alltoall(hvd, r, T):
        equal = hvd.alltoall(T.arr(
            np.arange(N * 2, dtype=np.float32).reshape(N * 2, 1) + 100 * r,
            "float32"), name="te.a2a")
        x = np.concatenate([np.full((d + 1, 2), 100 * r + d, np.float32)
                            for d in range(N)])
        var, recv = hvd.synchronize(hvd.alltoall_async(
            T.arr(x, "float32"), splits=T.splits([d + 1 for d in range(N)]),
            name="te.a2a.var"))
        return [T.np(equal), T.np(var), [int(s) for s in recv]]


    def case_reduce_scatter(hvd, r, T):
        return [
            T.np(hvd.reduce_scatter(T.arr(data((11, 3), r), "float32"),
                                    op=hvd.Sum, name="te.rs.sum")),
            T.np(hvd.reduce_scatter(T.arr(data((16,), r), "float32"),
                                    name="te.rs.avg")),
            T.np(hvd.reduce_scatter(T.arr(data((9, 2), r, "i"), "int32"),
                                    op=hvd.Sum, name="te.rs.int")),
        ]


    def case_int8(hvd, r, T):
        # every rank its own values; the sums cancel in part
        x = lambda seed: T.arr(data((4, 300), 500 + seed + 10 * r),
                               "float32")
        return [
            T.np(hvd.allreduce(x(0), op=hvd.Sum, name="te.q.sum",
                               compression="int8")),
            T.np(hvd.allreduce(x(1), name="te.q.avg",
                               compression=hvd.Compression.int8)),
            T.np(hvd.allreduce(x(2), op=hvd.Sum, name="te.q.scaled",
                               prescale_factor=0.5, postscale_factor=2.0,
                               compression="int8")),
            T.np(hvd.allreduce(x(3), op=hvd.Average, name="te.q.scaled.avg",
                               prescale_factor=3.0, postscale_factor=0.25,
                               compression="int8")),
            T.np(hvd.allreduce(T.arr(data((2, 700), 600 + r), "bfloat16"),
                               op=hvd.Sum, name="te.q.bf16",
                               compression="int8")),
        ]


    def case_int8_grouped(hvd, r, T):
        # whole blocks only: the JAX plane fuses a group as its cycles
        # happen to meet its members, and tensors of whole blocks give
        # the same numbers fused or not (tests/test_torch_mpi_ops.py
        # holds a fused bucket whose blocks cross tensors)
        return [T.np(o) for o in hvd.grouped_allreduce(
            [T.arr(data(s, 700 + 10 * r + i), "float32")
             for i, s in enumerate([(256,), (3, 512), (4, 64)])],
            op=hvd.Sum, name="te.q.group", compression="int8")]


    def case_int8_reduce_scatter(hvd, r, T):
        return [
            T.np(hvd.reduce_scatter(T.arr(data((33, 40), 800 + r), "float32"),
                                    op=hvd.Sum, name="te.q.rs.sum",
                                    compression="int8")),
            T.np(hvd.reduce_scatter(T.arr(data((16, 64), 810 + r), "float32"),
                                    name="te.q.rs.avg", compression="int8")),
        ]


    def case_int8_passthrough(hvd, r, T):
        # the exact wire: integers, and fewer than 256 elements
        return [
            T.np(hvd.allreduce(T.arr(data((512,), 900 + r, "i"), "int32"),
                               op=hvd.Sum, name="te.q.int",
                               compression="int8")),
            T.np(hvd.allreduce(T.arr(np.full((8,), r + 0.25, np.float32),
                                     "float32"),
                               op=hvd.Sum, name="te.q.tiny",
                               compression="int8")),
            T.np(hvd.reduce_scatter(T.arr(data((9, 5), 910 + r), "float32"),
                                    op=hvd.Sum, name="te.q.rs.tiny",
                                    compression="int8")),
        ]


    def case_join(hvd, r, T):
        steps = 2 if r < 2 else 4
        outs = [T.np(hvd.allreduce(
            T.arr(np.full((2,), float(r + 1), np.float32), "float32"),
            op=hvd.Sum, name=f"te.join.{i}")) for i in range(steps)]
        last = hvd.join()
        return [outs, 2 <= last < N]


    def case_join_orphan(hvd, r, T):
        h = None
        if r < 3:
            h = hvd.allreduce_async(
                T.arr(np.full((2,), float(r + 1), np.float32), "float32"),
                op=hvd.Sum, name="te.orphan")
        last = hvd.join()
        return [None if h is None else T.np(hvd.synchronize(h)),
                0 <= last < N]


    def case_barrier(hvd, r, T):
        return hvd.barrier(name="te.barrier")


    def case_out_of_order(hvd, r, T):
        a = T.arr(np.full((3,), 1.0 * r, np.float32), "float32")
        b = T.arr(np.full((5,), 2.0 * r, np.float32), "float32")
        if r % 2 == 0:
            ha = hvd.allreduce_async(a, op=hvd.Sum, name="te.ooo.a")
            hb = hvd.allreduce_async(b, op=hvd.Sum, name="te.ooo.b")
        else:
            hb = hvd.allreduce_async(b, op=hvd.Sum, name="te.ooo.b")
            ha = hvd.allreduce_async(a, op=hvd.Sum, name="te.ooo.a")
        return [T.np(hvd.synchronize(ha)), T.np(hvd.synchronize(hb))]


    def case_reuse(hvd, r, T):
        before = T.cache_hits()
        outs = [T.np(hvd.allreduce(T.arr(data((2,), 10 * r + s), "float32"),
                                   op=hvd.Sum, name="te.reuse"))
                for s in range(4)]
        return [outs, T.cache_hits() - before >= 3]


    def case_broadcast_object(hvd, r, T):
        payload = ({"cfg": [1, 2, 3], "root": r, "big": "x" * 10000}
                   if r == 5 else None)
        return hvd.broadcast_object(payload, root_rank=5, name="te.obj")


    def case_errors(hvd, r, T):
        ones = lambda shape, dt="float32": T.arr(
            np.ones(shape, np.float32), dt)
        return {
            "shape": err(lambda: hvd.allreduce(
                ones((3,) if r == 0 else (4,)), name="te.bad.shape")),
            "dtype": err(lambda: hvd.allreduce(
                ones((3,), "float32" if r == 0 else "int32"),
                name="te.bad.dtype")),
            "type": err(lambda: hvd.allreduce(ones((3,)), name="te.bad.kind")
                        if r == 0 else
                        hvd.allgather(ones((3,)), name="te.bad.kind")),
            "root": err(lambda: hvd.broadcast(ones((2,)), root_rank=r % 2,
                                              name="te.bad.root")),
            "trailing": err(lambda: hvd.allgather(
                ones((2, 3) if r == 0 else (2, 4)), name="te.bad.trailing")),
            # an error does not poison the next name
            "next": T.np(hvd.allreduce(
                T.arr(np.full((3,), float(r), np.float32), "float32"),
                op=hvd.Sum, name="te.after.error")),
        }
''')

WORKER = CASES + textwrap.dedent('''
    import pickle
    import sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics


    class T:
        @staticmethod
        def arr(x, dt):
            return torch.from_numpy(np.array(x)).to(getattr(torch, dt))

        @staticmethod
        def np(x):
            name = str(x.dtype).replace("torch.", "")
            return name, x.detach().cpu().to(
                torch.float64 if x.dtype.is_floating_point
                else torch.int64).numpy()

        @staticmethod
        def splits(xs):
            # Horovod's torch surface returns the received splits when
            # the splits are given as a tensor
            return torch.tensor(xs)

        @staticmethod
        def cache_hits():
            return basics._get_state().controller.cache_hits


    torch.set_num_threads(1)
    store, out_path = sys.argv[1:3]
    hvd.init(device="cpu", store_path=store)
    try:
        results = {name: globals()["case_" + name](hvd, hvd.rank(), T)
                   for name in CASE_NAMES}
    finally:
        hvd.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
''')


class JaxT:
    @staticmethod
    def arr(x, dt):
        return jnp.asarray(x).astype(getattr(jnp, dt))

    @staticmethod
    def np(x):
        a = np.asarray(x)
        name = a.dtype.name
        return name, a.astype(np.float64 if "float" in name else np.int64)

    @staticmethod
    def splits(xs):
        return xs

    @staticmethod
    def cache_hits():
        controller = jax_basics._get_state().controller
        if hasattr(controller, "cache_stats"):   # the native controller
            return controller.cache_stats()["hits"]
        return controller.cache_hits


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eager")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r in range(RANKS):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(RANKS),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp / "store"),
                 str(tmp / f"out{r}.pkl")], env=env,
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
    for r in range(RANKS):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="session")
def jax_hvd():
    """The JAX package initialised as the session ``hvd`` fixture does (8
    device ranks), without setting that fixture up: a file that shuts the
    package down in-process (``test_autotune.py``) would leave it set up
    but shut down for the files after it on the same worker.  Initialised
    here only when it is not, and shut down at the end of the session."""
    import horovod_tpu

    owned = not horovod_tpu.is_initialized()
    if owned:
        horovod_tpu.init()
    yield horovod_tpu
    if owned:
        horovod_tpu.shutdown()


@pytest.fixture(scope="module")
def jax_results(jax_hvd):
    ns = {}
    exec(CASES, ns)

    def fn(r):
        return {name: ns["case_" + name](jax_hvd, r, JaxT)
                for name in ns["CASE_NAMES"]}

    return jax_basics.run_parallel(fn)


TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _same(got, want, where):
    """Structures equal; (dtype name, array) pairs within the dtype's
    tolerance."""
    if isinstance(want, tuple) and len(want) == 2 \
            and isinstance(want[1], np.ndarray):
        assert got[0] == want[0], (where, got[0], want[0])
        assert got[1].shape == want[1].shape, (where, got[1].shape,
                                               want[1].shape)
        tol = TOL.get(want[0])
        if tol is None:
            np.testing.assert_array_equal(got[1], want[1], err_msg=where)
        else:
            scale = max(1.0, float(np.abs(want[1]).max(initial=0.0)))
            np.testing.assert_allclose(got[1], want[1], rtol=tol,
                                       atol=tol * scale, err_msg=where)
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


def _check(case, port_results, jax_results):
    for r in range(RANKS):
        got, want = port_results[r][case], jax_results[r][case]
        if case == "errors":
            # the session's JAX plane (the native controller) words its
            # errors as the prefix of the python controller's, whose full
            # text the port keeps (test_errors_are_the_references_words)
            for k in ("shape", "dtype", "type", "root", "trailing"):
                assert got[k].startswith(want[k]), (r, k, got[k], want[k])
            got, want = got["next"], want["next"]
        _same(got, want, f"{case} rank {r}")


@pytest.mark.parametrize("case", [
    "average",          # fp32, bf16, int32 (truncated toward zero)
    "sum",
    "odd_shapes",       # 0-d, (1,), (7,), (3, 5, 2)
    "scales",           # prescale/postscale with Sum and Average, ints too
    "async_poll",
    "fusion",           # 32 small tensors in flight, fused
    "burst",            # 256 in one submission
    "grouped_mixed",    # one group over fp32, int32, bf16
    "allgather",        # uniform and variable dim0, bf16, grouped
    "broadcast",
    "alltoall",         # equal and variable splits, received splits
    "reduce_scatter",   # np.array_split rows, Sum/Average, int32
    "join",             # uneven steps; the last rank to join
    "join_orphan",      # a name whose submitters all join
    "barrier",
    "out_of_order",     # names pair across ranks whatever the order
    "reuse",            # one name every step: the response cache hits
    "broadcast_object",
    "errors",           # shape, dtype, type, root, trailing; then a name
    "int8",             # Sum, Average, pre/postscale, bf16; each rank's own
    "int8_grouped",     # grouped, whole blocks
    "int8_reduce_scatter",  # both quantized legs, then the rank's rows
    "int8_passthrough",  # int32 and fewer than 256 elements: exact
])
def test_eager_case_matches_jax(case, port_results, jax_results):
    _check(case, port_results, jax_results)


def test_errors_are_the_references_words(port_results):
    """Every rank's messages are, word for word, those of the JAX
    package's ``PythonController.validate_requests`` for the same
    per-rank requests."""
    from horovod_tpu.common.ops_enum import RequestType
    from horovod_tpu.ops.python_controller import (EagerRequest,
                                                   PythonController)

    def message(name, make):
        requests = {}
        for r in range(RANKS):
            req_type, tensor, root = make(r)
            requests[r] = EagerRequest(rank=r, req_type=req_type, name=name,
                                       tensor=tensor, handle=None,
                                       root_rank=root)
        return PythonController.validate_requests(name, requests,
                                                  size=RANKS, joined=False)

    ar, ag, bc = (RequestType.ALLREDUCE, RequestType.ALLGATHER,
                  RequestType.BROADCAST)
    ones = lambda shape, dt=np.float32: np.ones(shape, dt)
    want = {
        "shape": message("te.bad.shape", lambda r: (
            ar, ones((3,) if r == 0 else (4,)), -1)),
        "dtype": message("te.bad.dtype", lambda r: (
            ar, ones((3,), np.float32 if r == 0 else np.int32), -1)),
        "type": message("te.bad.kind", lambda r: (
            ar if r == 0 else ag, ones((3,)), -1)),
        "root": message("te.bad.root", lambda r: (bc, ones((2,)), r % 2)),
        "trailing": message("te.bad.trailing", lambda r: (
            ag, ones((2, 3) if r == 0 else (2, 4)), -1)),
    }
    assert want["shape"] == ("mismatched shapes for allreduce "
                             "'te.bad.shape': [(3,), (4,)]")
    for r in range(RANKS):
        got = port_results[r]["errors"]
        for k, text in want.items():
            assert got[k] == text, (r, k, got[k], text)
        np.testing.assert_array_equal(got["next"][1], np.full((3,), 28.0))


def test_signature_cache_ids():
    """A name resubmitted with its validated signature travels as the
    cache entry's id, which every rank's identical copy reads back; a new
    signature for the name, or an eviction, retires the id."""
    from horovod_tpu_torch.common.ops_enum import RequestType
    from horovod_tpu_torch.common.response_cache import SignatureCache
    from horovod_tpu_torch.ops.controller import Signature

    a = Signature(RequestType.ALLREDUCE, "float32", (3,))
    b = a._replace(shape=(4,))
    cache = SignatureCache(capacity=2)
    assert cache.id_of("x", a) is None
    cache.store("x", [a, a])
    first = cache.id_of("x", a)
    assert first is not None and cache.entry(first) == ("x", a)
    assert cache.id_of("x", b) is None
    assert cache.check("x", [a, a]) and not cache.check("x", [a, b])
    cache.store("x", [b])
    assert cache.id_of("x", a) is None
    second = cache.id_of("x", b)
    assert second != first and cache.entry(second) == ("x", b)
    with pytest.raises(KeyError):
        cache.entry(first)
    cache.store("y", [a])
    cache.store("z", [a])   # capacity 2: "x" is the least recent
    assert cache.id_of("x", b) is None and len(cache) == 2
    with pytest.raises(KeyError):
        cache.entry(second)
    cache.store("w", [a, b])   # ranks disagree: nothing to cache
    assert cache.id_of("w", a) is None
