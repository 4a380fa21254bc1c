"""The port's torch surface (``horovod_tpu_torch/mpi_ops.py``: integer
handles, the in-place and grouped variants) and its ``SyncBatchNorm`` on
4 gloo ranks in subprocesses, and the arguments this slice refuses.

``SyncBatchNorm``'s output, input gradient, affine gradients and running
statistics are held against the JAX package's torch binding
(``horovod_tpu/torch/sync_batch_norm.py``) run in the JAX package's
device-rank mode (8 ranks, ``jax_hvd``): the global batch is the same,
cut into 8 chunks there and into 4 of two chunks here, so each
element's output and input gradient and the affine gradients summed
over the ranks must agree.
Tolerances: fp32, rtol 1e-5 with an absolute floor of 1e-5 times the
tensor's largest entry (the statistics are summed in another grouping);
the collectives of ``mpi_ops`` exactly against numpy (small integers in
fp32)."""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from horovod_tpu.common import basics as jax_basics

import horovod_tpu_torch as hvd
from horovod_tpu_torch import mpi_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
JAX_RANKS = 8
C, L = 3, 5


def _bn_data():
    rng = np.random.RandomState(21)
    return dict(
        x=(rng.randn(JAX_RANKS, 2, C, L) * 2 + 1).astype(np.float32),
        g=rng.randn(JAX_RANKS, 2, C, L).astype(np.float32),
        weight=(1 + 0.1 * rng.randn(C)).astype(np.float32),
        bias=(0.1 * rng.randn(C)).astype(np.float32))


def _bn_run(module, x, g, weight, bias):
    """One training forward and backward of a SyncBatchNorm module on this
    rank's chunk; -> numpy results."""
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(weight))
        module.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return dict(out=out.detach().numpy(), dx=xt.grad.numpy(),
                dw=module.weight.grad.numpy(), db=module.bias.grad.numpy(),
                mean=module.running_mean.numpy(),
                var=module.running_var.numpy())


WORKER = textwrap.dedent(f"""
    import pickle
    import sys
    import time
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import mpi_ops
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import compression as tc

    torch.set_num_threads(1)
    store, data_path, out_path = sys.argv[1:4]
    data = dict(np.load(data_path))
    hvd.init(device="cpu", store_path=store)
    res = {{}}
    try:
        r, n = hvd.rank(), hvd.size()
        full = lambda v, shape=(3,): torch.full(shape, float(v))

        h = mpi_ops.allreduce_async(full(r + 1), op=hvd.Sum, name="m.ar")
        res["handle_is_int"] = isinstance(h, int)
        res["allreduce_async"] = mpi_ops.synchronize(h).numpy()
        try:
            mpi_ops.synchronize(h)
            res["stale_handle"] = "no error"
        except ValueError as exc:
            res["stale_handle"] = str(exc)

        t = full(r + 1)
        same = mpi_ops.allreduce_(t, name="m.ar_")
        res["allreduce_"] = (same is t, t.numpy())
        t = full(r, (2, 2))
        h = mpi_ops.broadcast_async_(t, root_rank=2, name="m.bc_")
        res["broadcast_"] = (mpi_ops.synchronize(h) is t, t.numpy())
        res["broadcast"] = mpi_ops.broadcast(full(r), 1, name="m.bc").numpy()

        ts = [full(r), full(2 * r, (2,))]
        h = mpi_ops.grouped_allreduce_async_(ts, op=hvd.Sum, name="m.g_")
        outs = mpi_ops.synchronize(h)
        res["grouped_"] = ([o is t for o, t in zip(outs, ts)],
                           [t.numpy() for t in ts])
        outs = mpi_ops.grouped_allreduce([full(r), full(1, (2, 2))],
                                         name="m.g")
        res["grouped"] = [o.numpy() for o in outs]
        res["fp16"] = mpi_ops.allreduce(
            full(r + 0.5), op=hvd.Sum, name="m.fp16",
            compression=hvd.Compression.fp16).numpy()

        # int8: a grouped submission fuses into one buffer whose blocks
        # cross its tensors; each rank its own values
        gen = torch.Generator().manual_seed(50 + r)
        xs = [torch.randn(shape, generator=gen)
              for shape in [(100,), (3, 257), (7,)]]
        fused = tc.quantized_allreduce(torch.cat([x.reshape(-1)
                                                  for x in xs]))
        outs = mpi_ops.grouped_allreduce(xs, op=hvd.Sum, name="m.q.g",
                                         compression="int8")
        ts = [x.clone() for x in xs]
        mpi_ops.synchronize(mpi_ops.grouped_allreduce_async_(
            ts, op=hvd.Sum, name="m.q.g_", compression="int8"))
        t = xs[1].clone()
        mpi_ops.synchronize(mpi_ops.allreduce_async_(
            t, name="m.q.ar_", compression=hvd.Compression.int8))
        res["int8"] = dict(
            fused=fused.numpy(), grouped=[o.numpy() for o in outs],
            grouped_=[t.numpy() for t in ts], avg_=t.numpy(),
            avg_want=(tc.quantized_allreduce(xs[1].reshape(-1)) / n)
            .view(3, 257).numpy(),
            wires=dict(basics._get_state().controller._executor.wires))

        h = mpi_ops.allgather_async(full(r, (r + 1, 2)), name="m.ag")
        res["allgather"] = mpi_ops.synchronize(h).numpy()
        x = torch.cat([full(10 * r + d, (d + 1,)) for d in range(n)])
        out, splits = mpi_ops.alltoall(
            x, splits=torch.tensor([d + 1 for d in range(n)]), name="m.a2a")
        res["alltoall"] = (out.numpy(), splits.dtype == torch.int32,
                           splits.tolist())
        res["alltoall_plain"] = mpi_ops.alltoall(
            torch.arange(n, dtype=torch.float32) + 10 * r,
            name="m.a2a.eq").numpy()

        # the package's top level: integer handles from the in-place
        # variant, polled and synchronized there
        t = full(r + 1)
        h = hvd.allreduce_async_(t, op=hvd.Sum, name="m.top")
        while not hvd.poll(h):
            time.sleep(0.001)
        res["top_level"] = (isinstance(h, int), hvd.synchronize(h) is t,
                            t.numpy())

        # the optimizer's collectives come after the plane has issued what
        # this rank submitted to it, however late the other ranks submit
        if r > 0:
            time.sleep(0.3)
        h = hvd.allreduce_async(full(r), op=hvd.Sum, name="m.order")
        grads = hvd.allreduce_gradients([full(1, (4,))])
        res["order"] = (hvd.poll(h), hvd.synchronize(h).numpy(),
                        grads[0].numpy())

        # an idle plane backs off: few cycles in half a second
        ctrl = basics._get_state().controller
        before = ctrl.cycles
        time.sleep(0.5)
        res["idle_cycles"] = ctrl.cycles - before

        res["join"] = mpi_ops.join()

        bn = hvd.SyncBatchNorm({C})
        chunk = slice(2 * r, 2 * r + 2)
        x = data["x"][chunk].reshape(4, {C}, {L})
        g = data["g"][chunk].reshape(4, {C}, {L})
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(data["weight"]))
            bn.bias.copy_(torch.from_numpy(data["bias"]))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = bn(xt)
        (y * torch.from_numpy(g)).sum().backward()
        res["bn"] = dict(out=y.detach().numpy(), dx=xt.grad.numpy(),
                         dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                         mean=bn.running_mean.numpy(),
                         var=bn.running_var.numpy())
    finally:
        hvd.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mpi_ops")
    (tmp / "worker.py").write_text(WORKER)
    np.savez(tmp / "data.npz", **_bn_data())
    procs = []
    try:
        for r in range(RANKS):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(RANKS),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(tmp / "worker.py"), str(tmp / "store"),
                 str(tmp / "data.npz"), str(tmp / f"out{r}.pkl")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            out, _ = p.communicate(timeout=90)
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


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_integer_handles(ranks):
    for res in ranks:
        assert res["handle_is_int"]
        _eq(res["allreduce_async"], np.full(3, 10.0))
        assert res["stale_handle"].startswith("unknown handle")


def test_in_place_variants(ranks):
    for r, res in enumerate(ranks):
        same, value = res["allreduce_"]
        assert same
        _eq(value, np.full(3, 2.5))
        same, value = res["broadcast_"]
        assert same
        _eq(value, np.full((2, 2), 2.0))
        _eq(res["broadcast"], np.full(3, 1.0))
        same, values = res["grouped_"]
        assert same == [True, True]
        _eq(values[0], np.full(3, 6.0))
        _eq(values[1], np.full(2, 12.0))


def test_grouped_and_compressed_allreduce(ranks):
    for res in ranks:
        _eq(res["grouped"][0], np.full(3, 1.5))
        _eq(res["grouped"][1], np.full((2, 2), 1.0))
        _eq(res["fp16"], np.full(3, 8.0))


def test_int8_fused_bucket_quantizes_the_fused_buffer(ranks):
    """A grouped int8 allreduce of 100, 771 and 7 elements runs as one
    fused buffer of 878, whose 256-blocks cross the tensors, as the JAX
    plane's fused program (``xla_executor.py:380-420``) quantizes it: each
    result is its slice of ``quantized_allreduce`` of the concatenation
    (held to the JAX function in ``tests/test_torch_compression.py``),
    exactly, in the plain and the in-place forms; the in-place async
    average is that of the tensor alone, divided after the fp32 sum."""
    for res in ranks:
        q = res["int8"]
        offsets = np.cumsum([0, 100, 771, 7])
        for i, shape in enumerate([(100,), (3, 257), (7,)]):
            want = q["fused"][offsets[i]:offsets[i + 1]].reshape(shape)
            _eq(q["grouped"][i], want)
            _eq(q["grouped_"][i], want)
        _eq(q["avg_"], q["avg_want"])
        assert q["wires"].get("int8", 0) == 3, q["wires"]


def test_allgather_alltoall_join(ranks):
    want_ag = np.concatenate([np.full((r + 1, 2), float(r))
                              for r in range(RANKS)])
    for r, res in enumerate(ranks):
        _eq(res["allgather"], want_ag)
        out, is_int32, splits = res["alltoall"]
        _eq(out, np.concatenate([np.full(r + 1, 10.0 * s + r)
                                 for s in range(RANKS)]))
        assert is_int32 and splits == [r + 1] * RANKS
        _eq(res["alltoall_plain"], 10.0 * np.arange(RANKS) + r)
        assert 0 <= res["join"] < RANKS


def test_top_level_takes_integer_handles(ranks):
    """``hvd.allreduce_async_`` returns an integer handle that
    ``hvd.poll`` and ``hvd.synchronize`` take; the result is written into
    the input."""
    for res in ranks:
        is_int, same, value = res["top_level"]
        assert is_int and same
        _eq(value, np.full(3, 10.0))


def test_optimizer_collectives_follow_the_eager_plane(ranks):
    """Ranks 1-3 submit to the plane 0.3 s after rank 0; on every rank
    ``allreduce_gradients`` returns only after the plane has issued that
    op, so the two groups' collectives run in the same order on every
    rank."""
    for res in ranks:
        done, value, grad = res["order"]
        assert done
        _eq(value, np.full(3, 6.0))
        _eq(grad, np.full(4, 1.0))


def test_idle_plane_backs_off(ranks):
    """Half a second with nothing submitted: at most the 16 idle cycles
    before the backoff, its ramp of doubling waits and 0.5 s of 50 ms
    ones; a plane that cycles every millisecond runs about 200."""
    for res in ranks:
        assert res["idle_cycles"] <= 40, res["idle_cycles"]


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
def jax_bn(jax_hvd):
    from horovod_tpu.torch.sync_batch_norm import SyncBatchNorm

    data = _bn_data()

    def fn(r):
        return _bn_run(SyncBatchNorm(C), data["x"][r], data["g"][r],
                       data["weight"], data["bias"])

    return jax_basics.run_parallel(fn)


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("field", ["out", "dx", "mean", "var"])
def test_sync_batch_norm_matches_jax_binding(ranks, jax_bn, field):
    """Output and input gradient element by element, running statistics
    on every rank."""
    for r, res in enumerate(ranks):
        got = res["bn"][field]
        if field in ("out", "dx"):
            want = np.concatenate([jax_bn[2 * r][field],
                                   jax_bn[2 * r + 1][field]])
        else:
            want = jax_bn[0][field]
        _close(got, want, f"rank {r} {field}")


@pytest.mark.parametrize("field", ["dw", "db"])
def test_sync_batch_norm_affine_gradients_sum_to_jax(ranks, jax_bn, field):
    """The affine gradients are each rank's own (the optimizer reduces
    them), so their sums over the ranks agree."""
    _close(sum(res["bn"][field] for res in ranks),
           sum(res[field] for res in jax_bn), field)


# ------------------------------------------------ refused, at one CPU rank
@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("call,roadmap", [
    (lambda t: hvd.allreduce(t, group=object()), "A.10"),
    (lambda t: hvd.allgather(t, group=object()), "A.10"),
])
def test_unported_arguments_raise(one_rank, call, roadmap):
    """``group=`` is ported (A.10): anything but a ``ProcessGroup`` there
    raises the reference's ``groups.resolve`` error.  (``op=Adasum`` is
    ported too, A.11: ``tests/test_torch_adasum.py``.)"""
    with pytest.raises(hvd.HvdError) as got:
        call(torch.ones(3))
    from horovod_tpu.groups import resolve as jax_resolve
    with pytest.raises(Exception) as want:
        jax_resolve(object())
    assert str(got.value) == str(want.value)


def test_int8_at_one_rank_is_the_exact_wire(one_rank):
    """At one rank int8 resolves to the exact wire, as the reference's
    executor does (``xla_executor.py:232``): every form returns the input's
    own values."""
    from horovod_tpu_torch.common import basics

    x = torch.randn(3, 300, generator=torch.Generator().manual_seed(0))
    assert torch.equal(hvd.allreduce(x, compression="int8"), x)
    t = x.clone()
    mpi_ops.allreduce_(t, op=hvd.Sum, compression=hvd.Compression.int8)
    assert torch.equal(t, x)
    outs = hvd.grouped_allreduce([x, x[0]], op=hvd.Sum, compression="int8")
    assert torch.equal(outs[0], x) and torch.equal(outs[1], x[0])
    assert torch.equal(hvd.reduce_scatter(x, compression="int8"), x)
    wires = basics._get_state().controller._executor.wires
    assert wires["int8"] == 0 and wires["none"] == 4, wires


def test_one_rank_plane_and_handles(one_rank):
    """At one rank every collective returns the rank's own values, as new
    tensors; a tensor off the plane's device is refused."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = hvd.allreduce(t)
    assert out is not t and torch.equal(out, t)
    h = mpi_ops.allreduce_async(t, op=hvd.Sum)
    assert isinstance(h, int) and torch.equal(mpi_ops.synchronize(h), t)
    assert hvd.broadcast_object({"k": [1, 2]}) == {"k": [1, 2]}
    assert hvd.join() == 0
    with pytest.raises(ValueError, match="eager plane runs on"):
        hvd.allreduce(torch.ones(2, device="meta"))
