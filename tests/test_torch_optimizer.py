"""The port's ``DistributedOptimizer`` (``horovod_tpu_torch/optimizer.py``)
against the JAX package's ``hvd.DistributedOptimizer`` under
``shard_map``.

Two gloo ranks run in subprocesses (rendezvous through a ``FileStore`` in
``tmp_path``) and take 3 AdamW steps on the small transformer, each on
its half of the batch; the JAX side takes the same 3 steps on a 2-device
CPU mesh with ``optax.adamw``.  The parameters must match after every
step, within rtol 1e-5 / atol 2e-6 (fp32 gradients summed in another
order, then Adam's normalised update of 1e-3 per step).

Also pinned: ``optax.adamw``'s default ``weight_decay`` is 1e-4, not
torch ``AdamW``'s 1e-2."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import lm_loss as jax_lm_loss
from horovod_tpu.parallel import make_mesh
from horovod_tpu.parallel._compat import shard_map_unchecked

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.compression import Compression
from horovod_tpu_torch.models import flatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
             max_len=32)
LR, STEPS, RANKS, PER_RANK = 1e-3, 3, 2, 2

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                          lm_loss)
    from horovod_tpu_torch.parallel.ring_attention import reference_attention

    data_path, store_path, out_path = sys.argv[1:4]
    # dense attention, as the JAX model takes off the TPU
    cfg = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
               max_len=32, attn_fn=reference_attention)
    data = np.load(data_path)
    hvd.init(device="cpu", store_path=store_path)
    try:
        r = hvd.rank()
        model = Transformer(TransformerConfig(**cfg, dtype=torch.float32),
                            device="cpu", seed=r)
        model.load_state_dict({k[2:]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("p.")})
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=float(data["lr"]),
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        n = int(data["per_rank"])
        tokens = torch.from_numpy(data["tokens"][r * n:(r + 1) * n]).long()
        out = {}
        for step in range(int(data["steps"])):
            opt.zero_grad()
            lm_loss(model(tokens), tokens).backward()
            opt.step()
            for k, v in model.state_dict().items():
                out[f"{step}.{k}"] = v.numpy().copy()
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that this file leaves the
    cores to the test files running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_steps(params, tokens):
    model = JaxTransformer(JaxConfig(**SMALL, dtype=jnp.float32))
    opt = jhvd.DistributedOptimizer(optax.adamw(LR), named_axes=("hvd",))
    mesh = make_mesh({"hvd": RANKS}, devices=jax.devices()[:RANKS])

    def per_shard(p, s, tok):
        grads = jax.grad(lambda q: jax_lm_loss(
            model.apply({"params": q}, tok), tok))(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s

    step = jax.jit(shard_map_unchecked(
        per_shard, mesh=mesh, in_specs=(P(), P(), P("hvd")),
        out_specs=(P(), P())))
    state = opt.init(params)
    history = []
    for _ in range(STEPS):
        params, state = step(params, state, jnp.asarray(tokens))
        history.append(flatten_tree(
            jax.tree.map(lambda a: np.asarray(a), params)))
    return history


def _run_ranks(tmp_path, extra_env, worker=WORKER, arg=None):
    """Run ``worker`` on every rank as ``worker.py ARG STORE OUT``; ``ARG``
    defaults to the path of ``data.npz``."""
    script = tmp_path / "worker.py"
    script.write_text(worker)
    arg = str(tmp_path / "data.npz") if arg is None else arg
    procs = []
    try:
        for r in range(RANKS):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(RANKS),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""), **extra_env)
            procs.append(subprocess.Popen(
                [sys.executable, str(script), arg, str(tmp_path / "store"),
                 str(tmp_path / f"out{r}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for p in procs:
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [np.load(tmp_path / f"out{r}.npz") for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_run():
    """Initial parameters, the global batch and the JAX side's parameters
    after each of the 3 steps (shared by both fusion thresholds)."""
    params = JaxTransformer(JaxConfig(**SMALL, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))["params"]
    tokens = np.random.RandomState(5).randint(
        0, 512, (RANKS * PER_RANK, 32)).astype(np.int32)
    flat = flatten_tree(jax.tree.map(lambda a: np.asarray(a), params))
    return flat, tokens, _jax_steps(params, tokens)


@pytest.mark.parametrize("threshold", [None, 4096])
def test_two_rank_adamw_matches_jax_shard_map(tmp_path, threshold, jax_run):
    """``threshold`` 4096 bytes splits the gradients into many fusion
    buckets; the default (64 MB) makes one."""
    flat, tokens, want = jax_run
    np.savez(tmp_path / "data.npz", tokens=tokens, lr=LR, steps=STEPS,
             per_rank=PER_RANK, **{f"p.{k}": v for k, v in flat.items()})
    env = {} if threshold is None else {
        "HVD_FUSION_THRESHOLD": str(threshold)}

    ranks = _run_ranks(tmp_path, env)
    for step in range(STEPS):
        for name, value in want[step].items():
            got = [r[f"{step}.{name}"] for r in ranks]
            np.testing.assert_array_equal(got[0], got[1],
                                          err_msg=f"ranks differ: {name}")
            np.testing.assert_allclose(got[0], value, rtol=1e-5, atol=2e-6,
                                       err_msg=f"step {step} {name}")


TCP_WORKER = textwrap.dedent("""
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        r = hvd.rank()
        assert (hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (2, r, 2, 0, 1)
        grads = {"a": torch.full((3,), float(r + 1)),
                 "b": torch.full((2, 2), 10.0 * r)}
        avg = hvd.allreduce_gradients(grads)
        total = hvd.allreduce_gradients(grads, op=hvd.Sum)
        assert torch.equal(avg["a"], torch.full((3,), 1.5)), avg
        assert torch.equal(total["b"], torch.full((2, 2), 10.0)), total
        params = {"w": torch.full((4,), float(r))}
        hvd.broadcast_parameters(params, root_rank=1)
        assert torch.equal(params["w"], torch.ones(4)), params
    finally:
        hvd.shutdown()
    print("ok", r)
""")


def test_two_rank_tcp_rendezvous_and_collectives(tmp_path):
    """The launcher contract: the port's launcher (``python -m
    horovod_tpu_torch.run -np 2``) starts both ranks with
    HVD_RANK/HVD_SIZE/HVD_LOCAL_*/HVD_CROSS_* and the address of its
    rendezvous KV server (HVD_RENDEZVOUS_ADDR/PORT), where rank 0
    publishes the ``TCPStore`` it hosts on a port of its own."""
    script = tmp_path / "tcp_worker.py"
    script.write_text(TCP_WORKER)
    logs = tmp_path / "logs"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(RANKS),
         "--output-filename", str(logs), sys.executable, str(script)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for r in range(RANKS):
        assert f"ok {r}" in (logs / f"rank.{r}" / "stdout").read_text(), (
            out.stdout + out.stderr)


RESUME_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    rank1_state, store_path, out_path = sys.argv[1:4]
    hvd.init(device="cpu", store_path=store_path)
    try:
        r = hvd.rank()
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
        opt = torch.optim.AdamW(m.parameters(), lr=0.1 if r == 0 else 0.5)
        # local steps stand in for a checkpoint that only this rank loaded
        if r == 0:
            # the root's state covers the first layer only
            for _ in range(2):
                m[0](torch.randn(2, 4)).sum().backward()
                opt.step()
        elif rank1_state == "other":
            m[1](torch.randn(2, 3)).sum().backward()
            opt.step()
        opt.zero_grad(set_to_none=True)
        hvd.broadcast_parameters(m.state_dict(), root_rank=0)
        before = [p.detach().clone() for p in m.parameters()]
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        out = {"lr": np.float64(opt.param_groups[0]["lr"])}
        for i, (a, p) in enumerate(zip(before, m.parameters())):
            assert torch.equal(a, p), f"broadcast moved parameter {i}"
        for pid, st in opt.state_dict()["state"].items():
            for key, v in st.items():
                out[f"s.{pid}.{key}"] = v.numpy().copy()
        opt = hvd.DistributedOptimizer(opt)
        m(torch.randn(5, 4, generator=torch.Generator().manual_seed(r))
          ).sum().backward()
        opt.step()
        for i, p in enumerate(m.parameters()):
            out[f"p.{i}"] = p.detach().numpy().copy()
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()
""")


@pytest.mark.parametrize("rank1_state", ["empty", "other"])
def test_two_rank_broadcast_optimizer_state_from_resumed_root(tmp_path,
                                                              rank1_state):
    """Only rank 0 holds optimizer state (for some parameters); rank 1
    holds none, or that of other parameters.  After the broadcast both
    ranks hold exactly the root's state and learning rate, no parameter
    moved, and one averaged step leaves the ranks bitwise equal."""
    ranks = _run_ranks(tmp_path, {}, worker=RESUME_WORKER, arg=rank1_state)
    root, other = ranks
    assert sorted(root.files) == sorted(other.files)
    assert sorted(k for k in root.files if k.startswith("s.")) == [
        "s.0.exp_avg", "s.0.exp_avg_sq", "s.0.step",
        "s.1.exp_avg", "s.1.exp_avg_sq", "s.1.step"]
    assert float(root["s.0.step"]) == 2.0
    for k in root.files:
        np.testing.assert_array_equal(other[k], root[k], err_msg=k)
    assert float(other["lr"]) == 0.1


def test_optax_adamw_default_weight_decay_is_1e_4():
    p = {"w": jnp.ones(3)}
    opt = optax.adamw(0.1)
    upd, _ = opt.update({"w": jnp.zeros(3)}, opt.init(p), p)
    np.testing.assert_allclose(np.asarray(upd["w"]), -0.1 * 1e-4, rtol=1e-6)
    assert torch.optim.AdamW([torch.zeros(1)]).defaults[
        "weight_decay"] == 1e-2


# --------------------------------------------- one-rank semantics, in process
@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))


def test_one_rank_without_launcher_contract(one_rank):
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert hvd.device() == torch.device("cpu") and hvd.is_initialized()


def test_duplicate_names_raise(one_rank):
    m = _model()
    named = [("w", p) for p in m.parameters()]
    with pytest.raises(ValueError, match="duplicate names"):
        hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                 named_parameters=named)


def test_unnamed_parameters_get_global_noname_indices(one_rank):
    m = _model()
    ps = list(m.parameters())
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        [{"params": ps[:2]}, {"params": ps[2:]}], lr=0.1))
    assert [opt._parameter_names[p] for p in ps] == [
        f"allreduce.noname.{i}" for i in range(4)]


def test_backward_passes_per_step_averages_and_guards(one_rank):
    m = _model()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.0),
                                   backward_passes_per_step=2)
    x1, x2 = torch.randn(5, 4), torch.randn(5, 4)
    m(x1).sum().backward()
    m(x2).sum().backward()
    summed = [p.grad.clone() for p in m.parameters()]
    opt.synchronize()
    for p, s in zip(m.parameters(), summed):
        torch.testing.assert_close(p.grad, s / 2, rtol=0, atol=0)
    m(x1).sum().backward()
    m(x2).sum().backward()
    with pytest.raises(AssertionError, match="backward_passes_per_step"):
        m(x1).sum().backward()


def test_optimizer_is_freed_with_its_last_reference(one_rank):
    """The gradient hooks hold the optimizer weakly: a parameter keeps
    its hooks in C++, where the collector sees no cycle, so a strong
    reference kept every optimizer, its state and its parameters alive
    (at one card, the smoke's earlier optimizers held 60 GiB).  A new
    optimizer over the same model still trains, the old hooks inert."""
    import gc
    import weakref

    m = _model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
        named_parameters=m.named_parameters())
    m(torch.randn(5, 4)).sum().backward()
    opt.step()
    gone = weakref.ref(opt)
    del opt
    gc.collect()
    assert gone() is None
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   named_parameters=m.named_parameters())
    before = [p.detach().clone() for p in m.parameters()]
    opt.zero_grad()
    m(torch.randn(5, 4)).sum().backward()
    opt.step()
    assert all(not torch.equal(b, p) for b, p in zip(before, m.parameters()))


def test_step_skips_synchronize_inside_context(one_rank):
    m = _model()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1))
    m(torch.randn(2, 4)).sum().backward()
    opt.synchronize()
    before = [p.detach().clone() for p in m.parameters()]
    with opt.skip_synchronize():
        opt.step()
    assert not all(torch.equal(a, b) for a, b in zip(before, m.parameters()))


@pytest.mark.parametrize("compression", [Compression.none,
                                         Compression.fp16])
def test_allreduce_gradients_keeps_structure(one_rank, compression):
    grads = {"a": torch.randn(3, 2), "b": torch.randn(5)}
    out = hvd.allreduce_gradients(grads, op=hvd.Sum,
                                  compression=compression)
    assert list(out) == ["a", "b"]
    for k in grads:
        assert out[k].dtype == grads[k].dtype
        torch.testing.assert_close(out[k], grads[k], rtol=1e-3, atol=1e-3)
    listed = hvd.allreduce_gradients(list(grads.values()))
    torch.testing.assert_close(listed[1], grads["b"], rtol=0, atol=0)


@pytest.mark.parametrize("how", ["argument", "HVD_TPU_COMPRESSION"])
def test_allreduce_gradients_int8_at_one_rank(monkeypatch, how):
    """``jax_api.allreduce_gradients`` quantizes each float leaf of at
    least 256 elements even at one rank: the contribution's and the
    result's round trips, ``Int8Compressor.compress`` twice.  The port
    gives the JAX function's result under ``shard_map`` on one device,
    bitwise; smaller and integer leaves come back unchanged.  With
    ``HVD_TPU_COMPRESSION=int8``, ``compression=None`` does the same."""
    gen = torch.Generator().manual_seed(3)
    grads = {"w": torch.randn(20, 30, generator=gen) * 5,
             "b": torch.randn(10, generator=gen),
             "n": torch.arange(300, dtype=torch.int32)}
    kwargs = {"compression": Compression.int8}
    if how != "argument":
        monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
        kwargs = {"compression": None}
    hvd.init(device="cpu")
    try:
        out = hvd.allreduce_gradients(grads, op=hvd.Sum, **kwargs)
    finally:
        hvd.shutdown()
    mesh = make_mesh({"hvd": 1}, devices=jax.devices()[:1])
    want = jax.jit(shard_map_unchecked(
        lambda g: jhvd.allreduce_gradients(
            g, op=jhvd.Sum, compression=jhvd.Compression.int8),
        mesh=mesh, in_specs=P(), out_specs=P()))(
        {k: jnp.asarray(v.numpy()) for k, v in grads.items()})
    twice = Compression.int8.compress(
        Compression.int8.compress(grads["w"])[0])[0]
    assert not torch.equal(twice, grads["w"])
    assert torch.equal(out["w"], twice)
    for k, v in grads.items():
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
    assert torch.equal(out["b"], grads["b"])
    assert torch.equal(out["n"], grads["n"])


def test_broadcast_optimizer_state_from_empty_root_keeps_step_zero(one_rank):
    """An empty root state broadcasts only hyperparameters: no rank takes
    a dummy step, so the first real step is step 1 everywhere, as after
    ``optax.adamw(...).init``."""
    m = _model()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=0.1))
    before = [p.detach().clone() for p in m.parameters()]
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    assert opt.state_dict()["state"] == {}
    assert opt.param_groups[0]["lr"] == 0.1
    for a, b in zip(before, m.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_broadcast_optimizer_state_keeps_root_values(one_rank):
    m = _model()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=0.1))
    m(torch.randn(2, 4)).sum().backward()
    opt.step()
    want = {k: {n: v.clone() for n, v in st.items()}
            for k, st in opt.state_dict()["state"].items()}
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    got = opt.state_dict()["state"]
    assert set(got) == set(want) and len(want) == 4
    for k in want:
        for n in want[k]:
            torch.testing.assert_close(got[k][n], want[k][n], rtol=0,
                                       atol=0)


def test_bf16_compressor_round_trip():
    t = torch.randn(7, dtype=torch.float32)
    c, ctx = Compression.bf16.compress(t)
    assert c.dtype == torch.bfloat16 and ctx == torch.float32
    assert Compression.bf16.decompress(c, ctx).dtype == torch.float32
    i = torch.arange(3)
    assert Compression.bf16.compress(i) == (i, None)


# ----------------------------- backward_passes_per_step, averaged or summed
ACCUM_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    data_path, store_path, out_path = sys.argv[1:4]
    data = np.load(data_path)
    hvd.init(device="cpu", store_path=store_path)
    try:
        r = hvd.rank()
        params = {k: torch.nn.Parameter(torch.from_numpy(data[k]))
                  for k in ("w1", "b1", "w2")}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params.values(), lr=float(data["lr"])),
            named_parameters=params.items(), backward_passes_per_step=2,
            average_aggregated_gradients=bool(data["average"]))
        out = {}
        x, y = data["x"], data["y"]   # [micro step, rank, rows, ...]
        for m in range(x.shape[0]):
            xm, ym = torch.from_numpy(x[m, r]), torch.from_numpy(y[m, r])
            pred = torch.tanh(xm @ params["w1"] + params["b1"]) @ params["w2"]
            ((pred - ym) ** 2).mean().backward()
            if m % 2 == 1:
                opt.step()
                opt.zero_grad()
                for k, p in params.items():
                    out[f"{m // 2}.{k}"] = p.detach().numpy().copy()
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()
""")


@pytest.mark.parametrize("average", [True, False])
def test_two_rank_backward_passes_match_jax_multisteps(tmp_path, average):
    """``backward_passes_per_step=2`` on 2 gloo ranks, 2 SGD steps of a
    small MLP, against the JAX package's ``DistributedOptimizer`` (the
    ``optax.MultiSteps`` chain, ``jax_api.py:98-133``) under
    ``shard_map`` with the same ``average_aggregated_gradients``.  SGD
    keeps the factor of 2 between averaging and summing the passes in the
    update.  rtol 1e-5 (fp32, sums in another order)."""
    rng = np.random.RandomState(11)
    micro, rows = 4, 3
    init = {"w1": rng.randn(5, 6).astype(np.float32) * 0.5,
            "b1": rng.randn(6).astype(np.float32) * 0.1,
            "w2": rng.randn(6, 2).astype(np.float32) * 0.5}
    x = rng.randn(micro, RANKS, rows, 5).astype(np.float32)
    y = rng.randn(micro, RANKS, rows, 2).astype(np.float32)
    lr = 0.1
    np.savez(tmp_path / "data.npz", x=x, y=y, lr=lr, average=average,
             **init)

    def loss(p, xb, yb):
        pred = jnp.tanh(xb @ p["w1"] + p["b1"]) @ p["w2"]
        return jnp.mean((pred - yb) ** 2)

    opt = jhvd.DistributedOptimizer(
        optax.sgd(lr), named_axes=("hvd",), backward_passes_per_step=2,
        average_aggregated_gradients=average)
    mesh = make_mesh({"hvd": RANKS}, devices=jax.devices()[:RANKS])

    def per_shard(p, s, xb, yb):
        grads = jax.grad(loss)(p, xb[0], yb[0])
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s

    step = jax.jit(shard_map_unchecked(
        per_shard, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P())))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(params)
    want = []
    for m in range(micro):
        params, state = step(params, state, jnp.asarray(x[m]),
                             jnp.asarray(y[m]))
        if m % 2 == 1:
            want.append({k: np.asarray(v) for k, v in params.items()})

    ranks = _run_ranks(tmp_path, {}, worker=ACCUM_WORKER)
    for s, step_want in enumerate(want):
        for k, value in step_want.items():
            got = [r[f"{s}.{k}"] for r in ranks]
            np.testing.assert_array_equal(got[0], got[1])
            np.testing.assert_allclose(got[0], value, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {s} {k}")
    # the two settings differ by the factor 2 of the first step's update
    moved = np.abs(want[0]["w2"] - init["w2"]).max()
    assert moved > 1e-3


# ------------------------------------------- int8, quantized per gradient
INT8_SHAPES = {"w1": (20, 30), "b1": (30,), "w2": (30, 10), "b2": (10,),
               "w3": (256,), "k": (3, 5, 7, 11)}

INT8_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    data_path, store_path, out_path = sys.argv[1:4]
    data = np.load(data_path)
    hvd.init(device="cpu", store_path=store_path)
    try:
        r = hvd.rank()
        names = [k for k in data.files if k.startswith("p.")]
        params = {k[2:]: torch.nn.Parameter(torch.from_numpy(data[k]))
                  for k in names}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params.values(), lr=float(data["lr"]),
                            momentum=0.9),
            named_parameters=params.items(),
            compression=hvd.Compression.int8)
        out = {}
        for step in range(int(data["steps"])):
            opt.zero_grad()
            sum((p * torch.from_numpy(data[f"x.{k}"][step, r])).sum()
                for k, p in params.items()).backward()
            opt.synchronize()
            with opt.skip_synchronize():
                opt.step()
            for k, p in params.items():
                out[f"{step}.grad.{k}"] = p.grad.numpy().copy()
                out[f"{step}.{k}"] = p.detach().numpy().copy()
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()
""")


@pytest.mark.parametrize("threshold", [None, 2048])
def test_two_rank_int8_matches_jax_per_leaf(tmp_path, threshold):
    """``DistributedOptimizer(SGD(momentum=0.9), compression=int8)`` on 2
    gloo ranks, 3 steps, against ``jax_api.DistributedOptimizer(
    optax.sgd(lr, momentum=0.9), compression=Compression.int8)`` under
    ``shard_map``.  The leaves mix 600, 300, 256 and 1155 elements, which
    the reference quantizes each on its own, and 30 and 10, which it
    reduces exactly; the port fuses them into buckets (one bucket, or
    several of at most 2048 bytes).  The loss is linear in the
    parameters, so each rank's gradient is its data exactly on both
    sides: the averaged gradients are held to the reference's within
    1e-6 of each leaf's largest entry (in fact bitwise), the parameters
    within 1e-6 of each leaf's largest entry (torch's ``p - lr * buf``
    rounds once where optax rounds twice)."""
    rng = np.random.RandomState(17)
    lr, steps = 0.1, 3
    init = {k: rng.randn(*s).astype(np.float32)
            for k, s in INT8_SHAPES.items()}
    x = {k: (rng.randn(steps, RANKS, *s)
             * rng.choice([1e-2, 1.0, 30.0], (steps, RANKS) + (1,) * len(s)))
         .astype(np.float32) for k, s in INT8_SHAPES.items()}
    x["w1"][1, :, 4:] = 0.0      # zero blocks in the second step
    np.savez(tmp_path / "data.npz", lr=lr, steps=steps,
             **{f"p.{k}": v for k, v in init.items()},
             **{f"x.{k}": v for k, v in x.items()})

    opt = jhvd.DistributedOptimizer(optax.sgd(lr, momentum=0.9),
                                    named_axes=("hvd",),
                                    compression=jhvd.Compression.int8)
    mesh = make_mesh({"hvd": RANKS}, devices=jax.devices()[:RANKS])

    def per_shard(p, s, xs):
        grads = jax.grad(lambda q: sum(
            jnp.sum(q[k] * xs[k][0]) for k in q))(p)
        reduced = jhvd.allreduce_gradients(
            grads, compression=jhvd.Compression.int8)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, reduced

    step = jax.jit(shard_map_unchecked(
        per_shard, mesh=mesh, in_specs=(P(), P(), P("hvd")),
        out_specs=(P(), P(), P())))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(params)
    want = []
    for s in range(steps):
        params, state, reduced = step(
            params, state, {k: jnp.asarray(v[s]) for k, v in x.items()})
        want.append(({k: np.asarray(v) for k, v in params.items()},
                     {k: np.asarray(v) for k, v in reduced.items()}))

    env = {} if threshold is None else {
        "HVD_FUSION_THRESHOLD": str(threshold)}
    ranks = _run_ranks(tmp_path, env, worker=INT8_WORKER)
    exact_err = 0.0
    for s, (want_p, want_g) in enumerate(want):
        for k in INT8_SHAPES:
            got = [r[f"{s}.grad.{k}"] for r in ranks]
            np.testing.assert_array_equal(got[0], got[1])
            scale = float(np.abs(want_g[k]).max())
            np.testing.assert_allclose(got[0], want_g[k], rtol=0,
                                       atol=1e-6 * scale,
                                       err_msg=f"step {s} grad {k}")
            exact = x[k][s].astype(np.float64).mean(axis=0)
            err = float(np.abs(got[0] - exact).max())
            if x[k][0, 0].size < 256:
                assert err <= 1e-6 * scale, (s, k, err)
            exact_err = max(exact_err, err)
            np.testing.assert_allclose(
                ranks[0][f"{s}.{k}"], want_p[k], rtol=1e-6,
                atol=1e-6 * float(np.abs(want_p[k]).max()),
                err_msg=f"step {s} {k}")
    assert exact_err > 1e-4   # the quantized leaves did go through int8
