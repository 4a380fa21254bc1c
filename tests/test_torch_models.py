"""The port's CNN family (``horovod_tpu_torch/models/{resnet,vgg,
inception,mlp}.py``) against the JAX package's flax models.

flax ``init`` weights, moved off their initial values by seeded noise
(BatchNorm scales and biases, running statistics, Dense biases; so that
no branch is zeroed by a zero-initialised scale), are carried across by
``models.params_from_flax``.  On the CPU, in fp32, at small inputs as in
``tests/test_models.py`` (64x64, 10 classes, Inception at 128x128):

- the logits agree in eval and in train mode (rtol 1e-4, atol 1e-5),
- train mode updates ``batch_stats`` as flax does (the biased variance,
  momentum 0.9): rtol 1e-4, atol 1e-6,
- the gradients of the loss agree with ``jax.grad`` leaf by leaf (rtol
  1e-4, with an absolute floor of 1e-5 of the leaf's largest entry),
- in bf16 the logits agree to 2e-2 of their largest entry,
- Inception V3's train-mode logits and statistics, and the gradients of
  Inception V3 and ResNet-50, are held in float64 on both sides
  (``TRAIN_F64``, ``GRAD_F64``: in fp32 both sides are further from the
  exact result than the tolerance),
- one ``DistributedOptimizer`` SGD step on 2 gloo ranks matches the
  reference's ``shard_map`` step of ``bench.py::_bench_resnet``
  (bench.py:105-129) on a ResNet-18 at 32x32: parameters and the
  rank-averaged batch statistics.

Dropout is off (rate 0) on both sides where train-mode numbers are
compared: the two draw their masks from different generators."""

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
from horovod_tpu import models as jm
from horovod_tpu.parallel import make_mesh
from horovod_tpu.parallel._compat import shard_map_unchecked

import horovod_tpu_torch.models as tm
from horovod_tpu_torch.models.layers import same_pads
from horovod_tpu_torch.models import _is_conv_kernel, flatten_tree, \
    params_from_flax
from horovod_tpu_torch.train_cnn import cross_entropy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 10

# name -> (flax model of a dtype, port model of a dtype, input shape)
MODELS = {
    "resnet18": (lambda dt: jm.ResNet18(num_classes=CLASSES, dtype=dt),
                 lambda dt: tm.ResNet18(num_classes=CLASSES, dtype=dt,
                                        device="cpu"), (2, 64, 64, 3)),
    "resnet50": (lambda dt: jm.ResNet50(num_classes=CLASSES, dtype=dt),
                 lambda dt: tm.ResNet50(num_classes=CLASSES, dtype=dt,
                                        device="cpu"), (2, 64, 64, 3)),
    "vgg16": (lambda dt: jm.VGG16(num_classes=CLASSES, dtype=dt,
                                  classifier_width=64, dropout_rate=0.0),
              lambda dt: tm.VGG16(num_classes=CLASSES, dtype=dt,
                                  classifier_width=64, dropout_rate=0.0,
                                  image=64, device="cpu"), (2, 64, 64, 3)),
    "inception_v3": (lambda dt: jm.InceptionV3(num_classes=CLASSES, dtype=dt,
                                               dropout_rate=0.0),
                     lambda dt: tm.InceptionV3(num_classes=CLASSES, dtype=dt,
                                               dropout_rate=0.0,
                                               device="cpu"),
                     (2, 128, 128, 3)),
    "mlp": (lambda dt: jm.MLP(), lambda dt: tm.MLP(28 * 28, device="cpu"),
            (4, 28, 28)),
}
TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
            jnp.float64: torch.float64}
# Held in float64 on both sides, where fp32 cannot meet the tolerance
# at these sizes: Inception V3's train-mode logits (flax's fp32 logits
# are 5.9e-4 off its own float64 ones, the port's 1.6e-4), and the
# gradients of both deep BatchNorm models (train-mode BatchNorm over a
# few samples a channel: in ResNet-50 some leaves of both sides' fp32
# gradients are 1.5-4% off the float64 ones).
TRAIN_F64 = {"inception_v3"}
GRAD_F64 = {"inception_v3", "resnet50"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """At most two intra-op threads: the test files beside this one on
    the other workers keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _apply(name, model, variables, x, train):
    """-> (logits, new batch_stats or None) of the flax model."""
    if name == "mlp":
        return model.apply(variables, x), None
    if not train:
        return model.apply(variables, x, train=False), None
    logits, upd = model.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    return logits, upd.get("batch_stats")


def _perturb(tree, seed):
    """Seeded noise on the leaves that init sets to constants (a scale
    that starts at 0 stays near it)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flatten_tree(tree).items():
        v = np.array(v, np.float32)
        leaf = k.split(".")[-1]
        if leaf == "scale":
            v = v + 0.1 * rng.randn(*v.shape)
        elif leaf in ("bias", "mean"):
            v = 0.05 * rng.randn(*v.shape)
        elif leaf == "var":
            v = 0.5 + rng.rand(*v.shape)
        out[k] = v.astype(np.float32)
    return _unflatten(out)


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _setup(name, dtype=jnp.float32):
    """-> (flax model, its variables, the port's model loaded with them,
    the input, the labels), all from seeds."""
    make_jax, make_port, shape = MODELS[name]
    jmodel = make_jax(dtype)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    kw = {} if name == "mlp" else {"train": False}
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw)
    variables = {k: _perturb(v, 10 + i)
                 for i, (k, v) in enumerate(sorted(variables.items()))}
    port = make_port(TORCH_DT[dtype])
    port.load_state_dict(params_from_flax(variables["params"],
                                          variables.get("batch_stats")))
    if dtype == jnp.float64:
        port.double()
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 variables)
        x = x.astype(np.float64)
    y = np.random.RandomState(4).randint(0, CLASSES, shape[0])
    return jmodel, variables, port, x, y


def _close(got, want, rtol, atol_share, what):
    want = np.asarray(want, np.float64)
    atol = atol_share * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol, atol=atol, err_msg=what)


def _port_layout(name, value):
    value = np.asarray(value, np.float32)
    return value.transpose(3, 2, 0, 1) if _is_conv_kernel(name, value) \
        else value


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_and_batch_stats_match_flax(name, train):
    f64 = train and name in TRAIN_F64
    with jax.enable_x64(f64):
        jmodel, variables, port, x, _ = _setup(
            name, jnp.float64 if f64 else jnp.float32)
        want, stats = _apply(name, jmodel, variables, jnp.asarray(x), train)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5, err_msg=f"{name} logits")
    state = port.state_dict()
    for k, v in flatten_tree(stats or {}).items():
        np.testing.assert_allclose(state[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    if not train:
        for k, v in flatten_tree(variables.get("batch_stats", {})).items():
            np.testing.assert_array_equal(state[k].numpy(), v)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_gradients_match_jax_grad(name):
    f64 = name in GRAD_F64
    with jax.enable_x64(f64):
        jmodel, variables, port, x, y = _setup(
            name, jnp.float64 if f64 else jnp.float32)
        onehot = jax.nn.one_hot(jnp.asarray(y), CLASSES)

        def loss_fn(p):
            logits, _ = _apply(name, jmodel, {**variables, "params": p},
                               jnp.asarray(x), True)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                     axis=-1))

        want_loss, want = jax.value_and_grad(loss_fn)(variables["params"])
    port.train()
    loss = cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = {k: p.grad for k, p in port.named_parameters()}
    want = flatten_tree(want)
    assert sorted(grads) == sorted(want)
    for k, g in want.items():
        _close(grads[k].numpy(), _port_layout(k, g), 1e-4, 1e-5,
               f"{name} grad {k}")


@pytest.mark.parametrize("name,train", [
    ("resnet18", False), ("resnet18", True), ("vgg16", False),
    ("vgg16", True), ("inception_v3", False)])
def test_bf16_logits_match_flax(name, train):
    """Inception V3 in eval only: in train mode its fp32 logits are
    already ill-conditioned at this size (``TRAIN_F64``)."""
    jmodel, variables, port, x, _ = _setup(name, jnp.bfloat16)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    want, _ = _apply(name, jmodel, variables, jnp.asarray(x), train)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want, np.float32), 0, 2e-2,
           f"{name} bf16 logits")


def test_same_padding_is_flaxs():
    assert same_pads(224, 7, 2, "SAME") == (2, 3)    # the ResNet stem
    assert same_pads(112, 3, 2, "SAME") == (0, 1)    # its max pool
    assert same_pads(56, 3, 2, "SAME") == (0, 1)     # a stage's first 3x3
    assert same_pads(35, 3, 1, "SAME") == (1, 1)
    assert same_pads(17, 7, 1, "SAME") == (3, 3)
    assert same_pads(147, 3, 2, "VALID") == (0, 0)


def test_params_from_flax_layouts():
    """Conv kernels go HWIO -> OIHW; Dense kernels, and the transformer's
    4-D qkv kernel, keep flax's layout; batch statistics come along."""
    tree = {"conv_init": {"kernel": np.zeros((7, 5, 3, 64))},
            "Block_0": {"Conv_1": {"kernel": np.zeros((1, 3, 8, 16))}},
            "block_0": {"attn": {"qkv": {"kernel": np.zeros((8, 3, 2, 4))}}},
            "Dense_0": {"kernel": np.zeros((32, 10)), "bias": np.zeros(10)}}
    stats = {"bn_init": {"mean": np.ones(64), "var": np.ones(64)}}
    out = params_from_flax(tree, stats)
    assert out["conv_init.kernel"].shape == (64, 3, 7, 5)
    assert out["Block_0.Conv_1.kernel"].shape == (16, 8, 1, 3)
    assert out["block_0.attn.qkv.kernel"].shape == (8, 3, 2, 4)
    assert out["Dense_0.kernel"].shape == (32, 10)
    assert out["bn_init.var"].dtype == torch.float32
    assert set(out) == set(flatten_tree(tree)) | {"bn_init.mean",
                                                  "bn_init.var"}


def test_port_state_names_are_flaxs():
    """Every model's state_dict has exactly flax's params and
    batch_stats names (so no layer is registered twice or missing)."""
    for name, (make_jax, make_port, shape) in MODELS.items():
        kw = {} if name == "mlp" else {"train": False}
        shapes = jax.eval_shape(
            lambda x: make_jax(jnp.float32).init(jax.random.PRNGKey(0), x,
                                                 **kw),
            jnp.zeros(shape))
        want = {k: _port_layout(k, np.zeros(v.shape)).shape
                for col in shapes.values()
                for k, v in flatten_tree(col).items()}
        got = {k: tuple(v.shape)
               for k, v in make_port(torch.float32).state_dict().items()}
        assert got == want, name


def test_dropout_draws_from_its_generator():
    x = torch.ones(4, 64, 64, 3)

    def logits(seed):
        m = tm.VGG16(num_classes=CLASSES, dtype=torch.float32,
                     classifier_width=64, image=64, device="cpu", seed=seed)
        m.train()
        return m(x)

    a, b = logits(0), logits(0)
    assert torch.equal(a, b)
    m = tm.VGG16(num_classes=CLASSES, dtype=torch.float32,
                 classifier_width=64, image=64, device="cpu", seed=0)
    m.eval()
    assert not torch.equal(a, m(x))


# ------------------------------------- one data-parallel SGD step, 2 ranks
# 8 images a rank: the last stage is 1x1, so each of its BatchNorms
# normalizes over 8 samples a channel (at 2, the second step's loss of
# both sides differs by 7%)
RANKS, PER_RANK, IMAGE = 2, 8, 32

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet18
    from horovod_tpu_torch import train_cnn

    data_path, store_path, out_path = sys.argv[1:4]
    data = np.load(data_path)
    torch.set_num_threads(1)
    hvd.init(device="cpu", store_path=store_path)
    try:
        r = hvd.rank()
        model = ResNet18(num_classes=int(data["classes"]),
                         dtype=torch.float32, device="cpu", seed=r)
        model.load_state_dict({k[2:]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("s.")})
        opt = train_cnn.make_optimizer(model)
        x, y = train_cnn.synthetic_batch(int(data["per_rank"]),
                                         int(data["image"]),
                                         int(data["classes"]), "cpu",
                                         rank=r, size=hvd.size())
        losses = [float(train_cnn.train_step(model, opt, x, y))
                  for _ in range(int(data["steps"]))]
        np.savez(out_path, losses=np.array(losses),
                 **{k: v.numpy() for k, v in model.state_dict().items()})
    finally:
        hvd.shutdown()
""")


def _reference_steps(variables, steps):
    """bench.py::_bench_resnet's per_shard_step (bench.py:105-129) on a
    2-device CPU mesh, on the same synthetic batch."""
    model = jm.ResNet18(num_classes=CLASSES, dtype=jnp.float32)
    n = RANKS * PER_RANK
    x = np.random.RandomState(0).randn(n, IMAGE, IMAGE, 3).astype(np.float32)
    y = np.random.RandomState(1).randint(0, CLASSES, (n,))
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                    named_axes=("hvd",))
    mesh = make_mesh({"hvd": RANKS}, devices=jax.devices()[:RANKS])

    def per_shard_step(params, batch_stats, opt_state, x, y):
        def loss_fn(p):
            logits, updates = model.apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            one_hot = jax.nn.one_hot(y, CLASSES)
            loss = -jnp.mean(
                jnp.sum(jax.nn.log_softmax(logits) * one_hot, axis=-1))
            return loss, updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        new_stats = jax.tree.map(lambda s: jax.lax.pmean(s, "hvd"),
                                 new_stats)
        updates, new_opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats,
                new_opt_state, jax.lax.pmean(loss, "hvd"))

    step = jax.jit(shard_map_unchecked(
        per_shard_step, mesh=mesh,
        in_specs=(P(), P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P(), P(), P())))
    params, stats = variables["params"], variables["batch_stats"]
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        params, stats, state, loss = step(params, stats, state,
                                          jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return params, stats, losses


def test_two_rank_sgd_step_matches_bench_resnet(tmp_path):
    """Two steps, so that the momentum's second step is held too."""
    steps = 2
    jmodel = jm.ResNet18(num_classes=CLASSES, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, IMAGE, IMAGE, 3)), train=False)
    variables = {k: _perturb(v, 20 + i)
                 for i, (k, v) in enumerate(sorted(variables.items()))}
    params, stats, losses = _reference_steps(variables, steps)
    state = params_from_flax(variables["params"], variables["batch_stats"])
    np.savez(tmp_path / "data.npz", classes=CLASSES, per_rank=PER_RANK,
             image=IMAGE, steps=steps,
             **{f"s.{k}": v.numpy() for k, v in state.items()})
    (tmp_path / "worker.py").write_text(WORKER)
    procs = []
    try:
        for r in range(RANKS):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(RANKS),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(tmp_path / "worker.py"),
                 str(tmp_path / "data.npz"), str(tmp_path / "store"),
                 str(tmp_path / f"out{r}.npz")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in range(RANKS)]
    # the rank-averaged loss of each step
    np.testing.assert_allclose(
        np.mean([r["losses"] for r in ranks], axis=0), losses, rtol=1e-5)
    want = {k: _port_layout(k, v) for k, v in
            {**flatten_tree(params), **flatten_tree(stats)}.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                      err_msg=f"ranks differ: {k}")
        _close(ranks[0][k], v, 1e-4, 1e-5, f"step {k}")
