"""The port's sequence parallelism (``horovod_tpu_torch/parallel``: ring,
zigzag and Ulysses attention over ``parallel/_comm.py``) and the
transformer's ``remat`` and ``positions=`` against the JAX package.

2 and 4 gloo ranks run in subprocesses (rendezvous through a
``FileStore``), each world size launched once for all its cases
(``WORKER``); the JAX side runs the same global inputs, made with numpy
from seeds, through ``ring_self_attention``, ``zigzag_ring_self_attention``
and ``ulysses_self_attention`` on as many virtual CPU devices, as
``tests/test_sequence_parallel.py`` and ``tests/test_zigzag_attention.py``
do.  Each rank's shard of the output and of dq, dk and dv (for a cotangent
from a seed) is gathered and held to the JAX result.

Tolerances, those of the JAX tests: ring and Ulysses outputs rtol = atol
= 2e-5, zigzag 2e-4; gradients 5e-4.  The ranks' flash route
(``use_flash=True``: the flash kernels' plain versions on the CPU) is
held to the same JAX functions, and zigzag's also to JAX's Pallas kernel
in interpret mode (``use_flash=True``), at 2e-4 as
``test_zigzag_with_flash_blocks``.  The transformer with zigzag attention
and global positions on 4 ranks is held to the JAX ``Transformer`` with
``attn_fn`` = ring attention under ``shard_map`` (logits 1e-4, as
``tests/test_model_parallel.py``; gradients 5e-4).  A causal ring under
``DistributedOptimizer`` trains 3 SGD steps on 4 ranks and is held to
``optax.sgd`` on the whole sequence (parameters rtol 1e-5, atol 2e-6, as
``tests/test_torch_optimizer.py``; gradients rtol 1e-4, atol 1e-6): the
order test, since its ranks' graphs differ.  ``remat`` is held to flax's ``nn.remat`` with the
tolerances of ``tests/test_torch_transformer.py``."""

import functools
import importlib
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import lm_loss as jax_lm_loss
from horovod_tpu.parallel import make_mesh
from horovod_tpu.parallel._compat import shard_map

from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      flatten_tree, lm_loss,
                                      params_from_flax)
from horovod_tpu_torch.parallel import (reference_attention, zigzag_shard,
                                        zigzag_unshard)

# the modules (the package's names of the same spelling are functions)
jra, jul, jzz = (importlib.import_module(f"horovod_tpu.parallel.{m}")
                 for m in ("ring_attention", "ulysses", "zigzag_attention"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
             max_len=32)
ATTN = (1, 32, 4, 8)          # B, T, H, D of the attention cases
FLASH = (1, 1024, 2, 16)      # zigzag on flash blocks: C = 128
LR, STEPS = 0.1, 3
VARIANTS = ["ring", "ring_causal", "ring_flash", "ring_causal_flash",
            "zigzag", "zigzag_flash", "ulysses", "ulysses_causal",
            "ulysses_flash"]

WORKER = textwrap.dedent('''
    import pickle
    import sys

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.ops.cuda.flash_attention import flash_attention
    from horovod_tpu_torch.ops.cuda.softmax_xent import softmax_xent
    from horovod_tpu_torch.parallel import (
        reference_attention, ring_attention, ring_self_attention,
        ulysses_attention, ulysses_self_attention, zigzag_ring_attention,
        zigzag_ring_self_attention, zigzag_shard)

    data_path, store_path, out_path = sys.argv[1:4]
    data = np.load(data_path, allow_pickle=True)
    torch.set_num_threads(1)
    hvd.init(device="cpu", store_path=store_path)
    r, n = hvd.rank(), hvd.size()
    out = {}

    def shard(x, zigzag=False):
        x = torch.from_numpy(np.array(x))
        if zigzag:
            x = zigzag_shard(x, n)
        c = x.shape[1] // n
        return x[:, r * c:(r + 1) * c].clone()

    def run(fn, zigzag, arrays=("q", "k", "v", "do")):
        q, k, v, do = (shard(data[a], zigzag) for a in arrays)
        leaves = [x.requires_grad_(True) for x in (q, k, v)]
        o = fn(*leaves)
        (o * do).sum().backward()
        return [t.detach().numpy() for t in [o] + [x.grad for x in leaves]]

    ring = lambda c, f: lambda q, k, v: ring_attention(
        q, k, v, causal=c, use_flash=f)
    uly = lambda c, a=None: lambda q, k, v: ulysses_attention(
        q, k, v, causal=c, attn_fn=a)
    cases = {
        "ring": (ring(False, False), False),
        "ring_causal": (ring(True, False), False),
        "ring_flash": (ring(False, True), False),
        "ring_causal_flash": (ring(True, True), False),
        "zigzag": (lambda q, k, v: zigzag_ring_attention(
            q, k, v, use_flash=False), True),
        "zigzag_flash": (lambda q, k, v: zigzag_ring_attention(
            q, k, v, use_flash=True), True),
        "ulysses": (uly(False), False),
        "ulysses_causal": (uly(True), False),
        "ulysses_flash": (uly(True, flash_attention), False),
    }
    for name, (fn, zz) in cases.items():
        out[name] = run(fn, zz)
    g = [torch.from_numpy(np.array(data[a])) for a in ("q", "k", "v")]
    out["self"] = {
        "ring_causal": ring_self_attention(*g, causal=True).numpy(),
        "zigzag": zigzag_ring_self_attention(*g).numpy(),
        "ulysses_causal": ulysses_self_attention(*g, causal=True).numpy()}
    if n == 4:
        out["zigzag_pallas"] = run(
            lambda q, k, v: zigzag_ring_attention(q, k, v, use_flash=True),
            True, ("fq", "fk", "fv", "fdo"))[0]
    errors = {}
    try:
        ulysses_attention(*(shard(data[a])[:, :, :2] for a in "qkv"))
    except ValueError as exc:
        errors["ulysses"] = str(exc)
    try:
        zigzag_ring_attention(*(shard(data[a])[:, :1] for a in "qkv"))
    except ValueError as exc:
        errors["odd"] = str(exc)
    out["errors"] = errors

    if n == 4:
        params = data["params"].item()
        cfg = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4,
                   d_ff=128, max_len=32, dtype=torch.float32)

        def zz_attn(q, k, v, causal=True, scale=None):
            return zigzag_ring_attention(q, k, v, scale=scale)

        model = Transformer(TransformerConfig(**cfg, attn_fn=zz_attn),
                            device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
        tokens = torch.from_numpy(data["tokens"]).long()
        t = tokens.shape[1]
        tok = shard(tokens, True)
        pos = shard(torch.arange(t)[None], True)[0]
        labels = shard(torch.roll(tokens, -1, dims=-1), True)
        logits = model(tok, positions=pos)
        softmax_xent(logits, labels).mean().backward()
        grads = hvd.allreduce_gradients(
            {k: p.grad for k, p in model.named_parameters()})
        out["model"] = {"logits": logits.detach().numpy(),
                        "grads": {k: v.numpy() for k, v in grads.items()}}

        # the order test: a causal ring (each rank's graph its own) under
        # DistributedOptimizer, whose hooks allreduce during backward
        ring_attn = lambda q, k, v, causal=True, scale=None: ring_attention(
            q, k, v, causal=causal, scale=scale)
        model = Transformer(TransformerConfig(**cfg, attn_fn=ring_attn),
                            device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=float(data["lr"])),
            named_parameters=model.named_parameters())
        c = t // n
        pos = torch.arange(r * c, (r + 1) * c)
        tok, labels = shard(tokens), shard(torch.roll(tokens, -1, dims=-1))
        history = []
        for _ in range(int(data["steps"])):
            opt.zero_grad()
            softmax_xent(model(tok, positions=pos), labels).mean().backward()
            opt.step()
            history.append({
                "params": {k: v.detach().numpy().copy()
                           for k, v in model.state_dict().items()},
                "grads": {k: p.grad.numpy().copy()
                          for k, p in model.named_parameters()}})
        out["train"] = history
    hvd.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
''')


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkvdo(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax_params():
    model = JaxTransformer(JaxConfig(**SMALL, dtype=jnp.float32,
                                     attn_fn=jra.reference_attention))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SMALL["max_len"]), jnp.int32))["params"]
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _tokens():
    return np.random.RandomState(3).randint(0, 512, (2, 32)).astype(
        np.int32)


def _launch(tmp, n):
    q, k, v, do = _qkvdo(ATTN, 10 + n)
    fq, fk, fv, fdo = _qkvdo(FLASH, 20)
    np.savez(tmp / "data.npz", q=q, k=k, v=v, do=do, fq=fq, fk=fk, fv=fv,
             fdo=fdo, tokens=_tokens(), lr=LR, steps=STEPS,
             params=np.array(flatten_tree(_jax_params()), dtype=object))
    script = tmp / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(n),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp / "data.npz"),
                 str(tmp / "store"), str(tmp / f"out{r}.pkl")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for r in range(n):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return {n: _launch(tmp_path_factory.mktemp(f"sp{n}"), n) for n in (2, 4)}


def _mesh(n):
    return make_mesh({"sp": n}, devices=jax.devices()[:n])


def _jax_vjp(name, n, q, k, v, do):
    """The JAX function's output and (dq, dk, dv) for cotangent ``do``."""
    mesh = _mesh(n)
    causal = "causal" in name or name.startswith("zigzag")
    if name.startswith("ring"):
        fn = functools.partial(jra.ring_self_attention, mesh=mesh,
                               causal=causal)
    elif name.startswith("zigzag"):
        fn = functools.partial(jzz.zigzag_ring_self_attention, mesh=mesh,
                               use_flash=False)
    else:
        fn = functools.partial(jul.ulysses_self_attention, mesh=mesh,
                               causal=causal)

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c), q, k, v)
        return (out, *vjp(do))

    return [np.asarray(x) for x in run(*map(jnp.asarray, (q, k, v, do)))]


@functools.lru_cache(maxsize=None)
def _jax_results(n):
    q, k, v, do = _qkvdo(ATTN, 10 + n)
    done = {}
    results = {}
    for name in VARIANTS:
        # the flash route computes the same function as the dense one
        base = name.replace("_flash", "")
        if name == "ulysses_flash":
            base = "ulysses_causal"
        if base not in done:
            done[base] = _jax_vjp(base, n, q, k, v, do)
        results[name] = done[base]
    return results


def _gather(ranks, name, i, zigzag, n):
    x = np.concatenate([r[name][i] for r in ranks], axis=1)
    return np.asarray(zigzag_unshard(torch.from_numpy(x), n)) if zigzag \
        else x


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", VARIANTS)
def test_attention_and_gradients_match_jax(port_runs, name, n):
    want = _jax_results(n)[name]
    zz = name.startswith("zigzag")
    tol = 2e-4 if zz else 2e-5
    for i, what in enumerate(["out", "dq", "dk", "dv"]):
        got = _gather(port_runs[n], name, i, zz, n)
        t = tol if what == "out" else 5e-4
        np.testing.assert_allclose(got, want[i], rtol=t, atol=t,
                                   err_msg=f"{name} {what} at {n} ranks")


@pytest.mark.parametrize("n", [2, 4])
def test_self_attention_wrappers_match_jax(port_runs, n):
    want = _jax_results(n)
    for name in ("ring_causal", "zigzag", "ulysses_causal"):
        zz = name == "zigzag"
        x = np.concatenate([r["self"][name] for r in port_runs[n]], axis=1)
        got = np.asarray(zigzag_unshard(torch.from_numpy(x), n)) if zz else x
        tol = 2e-4 if zz else 2e-5
        np.testing.assert_allclose(got, want[name][0], rtol=tol, atol=tol,
                                   err_msg=name)


def test_zigzag_flash_blocks_match_jax_pallas_interpret(port_runs):
    """As ``test_zigzag_with_flash_blocks``: the JAX side runs its Pallas
    flash kernel in interpret mode in each block, the port its flash
    kernels' plain versions."""
    n = 4
    q, k, v, _ = _qkvdo(FLASH, 20)
    mesh = _mesh(n)
    spec = P(None, "sp", None, None)
    fn = functools.partial(jzz.zigzag_ring_attention, axis_name="sp",
                           use_flash=True)
    try:
        sm = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                       check_vma=False)
    except TypeError:
        sm = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                       check_rep=False)
    sharding = NamedSharding(mesh, spec)
    args = [jax.device_put(jzz.zigzag_shard(jnp.asarray(x), n), sharding)
            for x in (q, k, v)]
    want = np.asarray(jzz.zigzag_unshard(sm(*args), n))
    x = np.concatenate([r["zigzag_pallas"] for r in port_runs[n]], axis=1)
    got = np.asarray(zigzag_unshard(torch.from_numpy(x), n))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jra.reference_attention(
        *map(jnp.asarray, (q, k, v)), causal=True)), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_error_texts_are_the_references(port_runs, n):
    errors = port_runs[n][0]["errors"]
    q = jnp.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError) as jax_err:
        jax.block_until_ready(jul.ulysses_self_attention(
            q, q, q, make_mesh({"sp": 4}, devices=jax.devices()[:4])))
    if n == 4:
        assert errors["ulysses"] == str(jax_err.value)
    else:
        assert "ulysses" not in errors   # 2 heads over 2 ranks divide
    assert errors["odd"] == "zigzag shard holds 2 chunks; got T=1"
    for fn in (zigzag_shard, zigzag_unshard):
        with pytest.raises(ValueError) as got:
            fn(torch.zeros(1, 30, 2, 4), 4)
        with pytest.raises(ValueError) as want:
            getattr(jzz, fn.__name__)(jnp.zeros((1, 30, 2, 4)), 4)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("p_size", [1, 2, 4])
def test_zigzag_shard_round_trip_and_layout(p_size):
    x = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    z = zigzag_shard(x, p_size)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jzz.zigzag_shard(jnp.asarray(x.numpy()),
                                               p_size)))
    assert torch.equal(zigzag_unshard(z, p_size), x)


def _sp_attn(mesh):
    def attn(q, k, v, causal=True, scale=None):
        spec = P(None, "sp", None, None)
        return shard_map(
            functools.partial(jra.ring_attention, axis_name="sp",
                              causal=causal, scale=scale),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)(q, k, v)
    return attn


def test_zigzag_transformer_matches_jax_ring_transformer(port_runs):
    """4 ranks, each with its zigzag shard of the tokens, their global
    positions and the zigzag-reordered next-token labels; the ranks'
    gradients averaged.  The JAX model sees the whole sequence with ring
    attention under ``shard_map`` over 4 devices."""
    n = 4
    params, tokens = _jax_params(), _tokens()
    cfg = JaxConfig(**SMALL, dtype=jnp.float32, attn_fn=_sp_attn(_mesh(n)))
    model = JaxTransformer(cfg)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return jax_lm_loss(logits, jnp.asarray(tokens)), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    ranks = port_runs[n]
    got = np.concatenate([r["model"]["logits"] for r in ranks], axis=1)
    got = np.asarray(zigzag_unshard(torch.from_numpy(got), n))
    np.testing.assert_allclose(got, np.asarray(logits), rtol=1e-4, atol=1e-4)
    want = flatten_tree(jax.tree.map(np.asarray, grads))
    for r in ranks:
        assert set(r["model"]["grads"]) == set(want)
        for k in sorted(want):
            np.testing.assert_allclose(r["model"]["grads"][k], want[k],
                                       rtol=5e-4, atol=5e-4, err_msg=k)


def test_causal_ring_under_distributed_optimizer_matches_optax(port_runs):
    """The order test: each of 3 steps, every rank's averaged gradients
    (rtol 1e-4, atol 1e-6) and parameters (rtol 1e-5, atol 2e-6) equal
    ``optax.sgd`` on the whole sequence's loss.  SGD, whose update is
    linear in the gradient: Adam's first step, ``g / (|g| + eps)``, turns
    the summation-order noise of a gradient entry near 1e-8 into a
    difference of lr/20."""
    params, tokens = _jax_params(), _tokens()
    model = JaxTransformer(JaxConfig(**SMALL, dtype=jnp.float32,
                                     attn_fn=jra.reference_attention))
    opt = optax.sgd(LR)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        g = jax.grad(lambda q: jax_lm_loss(
            model.apply({"params": q}, jnp.asarray(tokens)),
            jnp.asarray(tokens)))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, g

    for i in range(STEPS):
        params, state, grads = step(params, state)
        want = flatten_tree(jax.tree.map(np.asarray, params))
        want_g = flatten_tree(jax.tree.map(np.asarray, grads))
        for r, rank in enumerate(port_runs[4]):
            got = rank["train"][i]
            for k in sorted(want):
                where = f"step {i} rank {r} {k}"
                np.testing.assert_allclose(got["grads"][k], want_g[k],
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=where)
                np.testing.assert_allclose(got["params"][k], want[k],
                                           rtol=1e-5, atol=2e-6,
                                           err_msg=where)


def _torch_model(params, **kw):
    model = Transformer(TransformerConfig(
        **SMALL, dtype=torch.float32, attn_fn=reference_attention, **kw),
        device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def test_remat_matches_flax_nn_remat():
    """``remat=True`` (each block under ``torch.utils.checkpoint``)
    against flax's ``nn.remat(Block)``: logits and loss 1e-5, gradients
    rtol 1e-4 / atol 1e-6; against ``remat=False`` the loss is bitwise
    the same (the same forward) and so are the gradients on the CPU."""
    params, tokens = _jax_params(), _tokens()
    cfg = JaxConfig(**SMALL, dtype=jnp.float32, remat=True,
                    attn_fn=jra.reference_attention)
    model = JaxTransformer(cfg)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return jax_lm_loss(logits, jnp.asarray(tokens)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn,
                                                  has_aux=True)(params)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jgrads))
    tok = torch.from_numpy(tokens).long()
    runs = {}
    for remat in (True, False):
        m = _torch_model(params, remat=remat)
        logits = m(tok)
        loss = lm_loss(logits, tok)
        loss.backward()
        runs[remat] = (logits.detach().numpy(), loss.detach(),
                       {k: p.grad.numpy() for k, p in m.named_parameters()})
    logits, loss, grads = runs[True]
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in sorted(jgrads):
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert torch.equal(loss, runs[False][1])
    for k in grads:
        np.testing.assert_array_equal(grads[k], runs[False][2][k])


def test_positions_default_to_arange():
    params, tokens = _jax_params(), _tokens()
    m = _torch_model(params)
    tok = torch.from_numpy(tokens).long()
    with torch.no_grad():
        assert torch.equal(m(tok), m(tok, positions=torch.arange(32)))
        assert torch.equal(m(tok), m(tok, positions=torch.arange(32)
                                     .expand(2, 32)))
        shifted = m(tok[:, 8:], positions=torch.arange(8, 32))
        assert not torch.equal(shifted, m(tok[:, 8:]))




def test_ulysses_at_one_rank_defaults_to_the_reference(tmp_path):
    """One rank, in this process: each all-to-all sends one part.  q, k
    and v are views of one ``[B, T, 3, H, D]`` tensor, as the
    transformer hands them over, so the backward's all-to-alls receive
    strided gradients (batch 2: torch takes a batch of one as contiguous
    whatever its stride).  ``ulysses_attention`` with ``attn_fn=None``
    on CPU tensors is ``reference_attention``; output and dq, dk, dv
    against the JAX ``reference_attention`` (rtol = atol = 2e-5;
    gradients 5e-4)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import ulysses_attention

    b, t, h, d = 2, 32, 4, 8
    rng = np.random.RandomState(30)
    qkv = rng.randn(b, t, 3, h, d).astype(np.float32)
    do = rng.randn(b, t, h, d).astype(np.float32)
    jout, vjp = jax.vjp(
        lambda a, b_, c: jra.reference_attention(a, b_, c, causal=True),
        *(jnp.asarray(qkv[:, :, i]) for i in range(3)))
    jgrads = vjp(jnp.asarray(do))
    leaf = torch.from_numpy(qkv).requires_grad_(True)
    hvd.init(device="cpu", store_path=str(tmp_path / "store"))
    try:
        out = ulysses_attention(*leaf.unbind(2), causal=True)
        (out * torch.from_numpy(do)).sum().backward()
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for i, want in enumerate(jgrads):
        np.testing.assert_allclose(leaf.grad[:, :, i].numpy(),
                                   np.asarray(want), rtol=5e-4, atol=5e-4)
