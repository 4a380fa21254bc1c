"""The port's model parallelism (``horovod_tpu_torch/parallel``: the mesh,
tensor parallelism, the switch MoE, the pipeline; the transformer's
``mesh=``, ``moe_every`` and ``apply_with_aux``) against the JAX package,
case by case as ``tests/test_model_parallel.py`` runs it.

In this process (no ``hvd.init``): the sharding-spec table against
``params_shardings`` on ``make_mesh({"dp": 2, "tp": 4})`` parameter for
parameter; ``switch_route``'s dispatch and combine equal and its expert
index bitwise; ``switch_moe`` (with the padded group-size cases) to rtol
1e-4 / atol 1e-5, outputs and gradients; the MoE transformer and
``apply_with_aux`` against flax's (logits and aux 1e-5, gradients of
``lm_loss + 0.01 * aux`` against ``jax.grad`` rtol 1e-4 / atol 1e-6, as
``tests/test_torch_transformer.py``).

On 4 and 8 gloo ranks (subprocesses, rendezvous through a ``FileStore``,
each world size launched once for all its cases, ``WORKER``): the
transformer on ``{"dp": 2, "tp": 2}`` (4 ranks) and ``{"dp": 2, "tp":
4}`` (8 ranks), each dp replica its rows of the batch, gradients averaged
over the dp group: logits and every rank's block of one step's gradients
against the flax model and ``jax.grad`` of its loss over the whole batch,
rtol 1e-4 / atol 1e-4 (``test_tensor_parallel_matches_single_device``);
``switch_moe`` at ``ep`` = 2 and 4 against the unsharded JAX
``switch_moe`` (rtol 1e-4 / atol 1e-4, as
``test_moe_expert_parallel_matches_unsharded``), outputs and gradients;
the MoE transformer on ``{"dp": 2, "ep": 2}`` with the same oracle as at
one rank (logits, aux, the router's and the experts' gradients); the
pipeline on ``{"pp": 4, "dp": 2}`` (8 ranks) against the reference's
``pipelined`` on the same mesh, outputs 1e-5 and gradients 1e-4
(``test_pipeline_matches_sequential``, ``test_pipeline_grads_flow``); and
the grid and the mesh of the same axes giving bitwise the same logits
and pipeline outputs.

The MoE routing groups: the JAX model routes the whole batch in groups
of ``group_size`` tokens, the port each dp replica's rows; both are the
same function when the groups fall inside the replicas, as at the card's
size (4096 | 16,384 tokens a replica).  The small cases here take
``group_size`` 16 on both sides (both modules' ``switch_moe`` replaced
by a partial, in this process and in the workers).
"""

import functools
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

from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import apply_with_aux as jax_apply_with_aux
from horovod_tpu.models import lm_loss as jax_lm_loss
from horovod_tpu.parallel import init_moe_params as jax_init_moe
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import params_shardings as jax_params_shardings
from horovod_tpu.parallel import pipelined as jax_pipelined
from horovod_tpu.parallel import switch_moe as jax_switch_moe
from horovod_tpu.parallel import moe as jax_moe_mod
from horovod_tpu.parallel.ring_attention import \
    reference_attention as jax_attention

from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      apply_with_aux, flatten_tree, lm_loss,
                                      params_from_flax)
from horovod_tpu_torch.models import transformer as port_transformer
from horovod_tpu_torch.parallel import (make_mesh, params_shardings,
                                        switch_moe, switch_route)
from horovod_tpu_torch.parallel import moe as port_moe
from horovod_tpu_torch.parallel.tensor_parallel import shard_tensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_model_parallel.py's tiny_cfg and its MoE config
TP_CFG = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=8, d_ff=128,
              max_len=64)
MOE_CFG = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=4, d_ff=64,
               max_len=16, moe_every=2, n_experts=4)
MOE_GROUP = 16      # routing group of the small MoE transformer cases
AUX_WEIGHT = 0.01   # examples/transformer_lm.py's loss: lm + 0.01 * aux
# switch_moe at ep: (mesh, capacity factor)
EP_CASES = {"ep2": ({"dp": 2, "ep": 2}, 2.0), "ep4": ({"ep": 4}, 2.0),
            "ep4_drops": ({"ep": 4}, 1.0)}

WORKER = textwrap.dedent('''
    import functools
    import pickle
    import sys

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                          apply_with_aux, lm_loss,
                                          params_from_flax)
    from horovod_tpu_torch.models import transformer as tmod
    from horovod_tpu_torch.parallel import (constrain, make_mesh, pipelined,
                                            switch_moe)
    from horovod_tpu_torch.parallel import moe
    from horovod_tpu_torch.parallel.mesh import as_mesh
    from horovod_tpu_torch.parallel.tensor_parallel import shard_params

    data_path, store_path, out_path = sys.argv[1:4]
    data = np.load(data_path, allow_pickle=True)
    torch.set_num_threads(1)
    hvd.init(device="cpu", store_path=store_path)
    r, n = hvd.rank(), hvd.size()
    tmod.switch_moe = functools.partial(moe.switch_moe,
                                        group_size=int(data["moe_group"]))
    out = {}

    def lm(case, cfg, params, tokens, mesh, aux_weight=0.0):
        """One forward and backward of this rank's dp replica's rows;
        -> logits, aux, loss and the gradients averaged over dp."""
        model = Transformer(TransformerConfig(**cfg, dtype=torch.float32),
                            device="cpu", mesh=mesh)
        model.load_state_dict(params_from_flax(params, mesh=mesh))
        mesh = as_mesh(mesh)
        shape = mesh.shape
        dp = mesh.coords(r).get("dp", 0)
        rows = tokens.shape[0] // shape.get("dp", 1)
        tok = torch.from_numpy(tokens[dp * rows:(dp + 1) * rows]).long()
        logits, aux = apply_with_aux(model, tok)
        loss = lm_loss(logits, tok) + aux_weight * aux
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        if "dp" in shape:
            grads = hvd.allreduce_gradients(grads, group=mesh.group("dp"))
        return {"logits": logits.detach().numpy(),
                "aux": float(aux.detach()), "loss": float(loss.detach()),
                "grads": {k: v.numpy() for k, v in grads.items()}}

    def ep_case(axes, cf):
        mesh = make_mesh(axes)
        full = {f"moe.{k}.kernel": torch.from_numpy(np.array(v))
                for k, v in data["moe_params"].item().items()}
        mine = {k: v.requires_grad_(True) for k, v in
                shard_params(full, mesh).items()}
        params = {k: {"kernel": mine[f"moe.{k}.kernel"]}
                  for k in ("router", "wi", "wo")}
        x = torch.from_numpy(np.array(data["moe_x"])).requires_grad_(True)
        y, aux = switch_moe(x, params, capacity_factor=cf, mesh=mesh)
        ((y * torch.from_numpy(np.array(data["moe_ct"]))).sum()
         + aux).backward()
        return {"out": y.detach().numpy(), "aux": float(aux.detach()),
                "x": x.grad.numpy(),
                "grads": {k: v.grad.numpy() for k, v in mine.items()}}

    def stage_fn(p, h):
        w, b = p
        return torch.tanh(h @ w + b)

    def pipe(mesh_or_grid, ws, bs, x):
        ws, bs = (torch.from_numpy(np.array(a)).requires_grad_(True)
                  for a in (ws, bs))
        got = pipelined(stage_fn, mesh_or_grid, axis_name="pp")(
            (ws, bs), torch.from_numpy(np.array(x)))
        (got ** 2).sum().backward()
        return {"out": got.detach().numpy(), "ws": ws.grad.numpy(),
                "bs": bs.grad.numpy()}

    tp_params = data["tp_params"].item()
    tp_tokens = np.array(data["tp_tokens"])
    if n == 4:
        mesh = make_mesh({"dp": 2, "tp": 2})
        out["tp"] = lm("tp", data["tp_cfg"].item(), tp_params, tp_tokens,
                       mesh)
        grid = hvd.grid(dp=2, tp=2)
        out["tp_grid_logits"] = lm("tp", data["tp_cfg"].item(), tp_params,
                                   tp_tokens, grid)["logits"]
        out["moe_model"] = lm("moe", data["moe_cfg"].item(),
                              data["moe_model_params"].item(),
                              np.array(data["moe_tokens"]),
                              make_mesh({"dp": 2, "ep": 2}),
                              float(data["aux_weight"]))
        for name, (axes, cf) in data["ep_cases"].item().items():
            out[name] = ep_case(axes, cf)
        x = torch.from_numpy(np.array(data["c_x"])).requires_grad_(True)
        ct = torch.from_numpy(np.array(data["c_ct"]))
        y = constrain(x, mesh, None, "tp")
        tp = mesh.coords(r)["tp"]
        (y * ct[:, tp * 4:(tp + 1) * 4]).sum().backward()
        out["constrain"] = {
            "y": y.detach().numpy(), "grad": x.grad.numpy(),
            "noop": constrain(x, make_mesh({"dp": 4}), None, "tp") is x}
    else:
        out["tp"] = lm("tp", data["tp_cfg"].item(), tp_params, tp_tokens,
                       make_mesh({"dp": 2, "tp": 4}))
        mesh = make_mesh({"pp": 4, "dp": 2})
        out["pipe"] = pipe(mesh, data["pipe_ws"], data["pipe_bs"],
                           data["pipe_x"])
        out["pipe_grads"] = pipe(mesh, data["pg_ws"], data["pg_bs"],
                                 data["pg_x"])
        out["pipe_grid"] = pipe(hvd.grid(pp=4, dp=2), data["pipe_ws"],
                                data["pipe_bs"], data["pipe_x"])["out"]
        out["coords"] = mesh.coords(r)
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


@pytest.fixture
def moe_group(monkeypatch):
    """Both modules' MoE blocks route in groups of ``MOE_GROUP`` tokens."""
    monkeypatch.setattr(jax_moe_mod, "switch_moe", functools.partial(
        jax_moe_mod.switch_moe, group_size=MOE_GROUP))
    monkeypatch.setattr(port_transformer, "switch_moe", functools.partial(
        port_moe.switch_moe, group_size=MOE_GROUP))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# --------------------------------------------------------------- oracles
@functools.lru_cache(maxsize=None)
def _flax_init(kind):
    cfg = TP_CFG if kind == "tp" else MOE_CFG
    model = JaxTransformer(JaxConfig(**cfg, dtype=jnp.float32,
                                     attn_fn=jax_attention))
    tokens = np.random.RandomState(0).randint(
        0, cfg["vocab_size"], (4, 32 if kind == "tp" else 16)).astype(
        np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    return model, _np(params), tokens


def _flax_lm(kind, aux_weight=0.0):
    """Logits, aux, loss and gradients of the flax model over the whole
    batch (``lm_loss + aux_weight * aux``)."""
    model, params, tokens = _flax_init(kind)
    jt = jnp.asarray(tokens)

    def loss_fn(p):
        logits, aux = jax_apply_with_aux(model, p, jt)
        return jax_lm_loss(logits, jt) + aux_weight * aux, (logits, aux)

    (loss, (logits, aux)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    return {"logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "grads": flatten_tree(_np(grads))}


@functools.lru_cache(maxsize=None)
def _flax_lm_routed(kind, aux_weight):
    saved = jax_moe_mod.switch_moe
    jax_moe_mod.switch_moe = functools.partial(saved, group_size=MOE_GROUP)
    try:
        return _flax_lm(kind, aux_weight)
    finally:
        jax_moe_mod.switch_moe = saved


def _moe_inputs():
    params = _np(jax_init_moe(jax.random.PRNGKey(1), d_model=32, d_ff=64,
                              n_experts=8))
    rng = np.random.RandomState(2)
    x = rng.randn(128, 32).astype(np.float32)
    ct = rng.randn(128, 32).astype(np.float32)
    return params, x, ct


@functools.lru_cache(maxsize=None)
def _jax_moe(cf, group_size=4096, rows=None):
    """Output, aux and the gradients of ``sum(out * ct) + aux`` of the JAX
    ``switch_moe``."""
    params, x, ct = _moe_inputs()
    if rows is not None:
        x, ct = x[:rows], ct[:rows]

    def loss(x, p):
        out, aux = jax_switch_moe(x, p, capacity_factor=cf,
                                  group_size=group_size)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (out, aux)), (gx, gp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                            jax.tree.map(jnp.asarray, params))
    return (np.asarray(out), float(aux), np.asarray(gx),
            {f"moe.{k}.kernel": np.asarray(v["kernel"])
             for k, v in gp.items()})


def _pipe_inputs(seed, s, m, mb, d, bias_scale):
    rng = np.random.RandomState(seed)
    ws = (rng.randn(s, d, d) * 0.3).astype(np.float32)
    bs = (rng.randn(s, d) * bias_scale).astype(np.float32)
    x = rng.randn(m, mb, d).astype(np.float32)
    return ws, bs, x


# the reference tests' data; test_pipeline_grads_flow's biases are zeros
PIPE = (0, 4, 6, 8, 16, 0.1)
PIPE_GRADS = (1, 4, 4, 4, 8, 0.0)


def _jax_stage(p, h):
    w, b = p
    return jnp.tanh(h @ w + b)


@functools.lru_cache(maxsize=None)
def _jax_pipe(spec):
    ws, bs, x = _pipe_inputs(*spec)
    run = jax_pipelined(_jax_stage, jax_make_mesh({"pp": 4, "dp": 2}),
                        axis_name="pp")

    def loss(ws, bs):
        out = run((ws, bs), jnp.asarray(x))
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(jnp.asarray(ws),
                                                       jnp.asarray(bs))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _constrain_inputs():
    rng = np.random.RandomState(7)
    return (rng.randn(4, 8).astype(np.float32),
            rng.randn(4, 8).astype(np.float32))


# ------------------------------------------------------- the rank launch
def _launch(tmp, n):
    tp_model, tp_params, tp_tokens = _flax_init("tp")
    _, moe_model_params, moe_tokens = _flax_init("moe")
    moe_params, x, ct = _moe_inputs()
    pw, pb, px = _pipe_inputs(*PIPE)
    gw, gb, gx = _pipe_inputs(*PIPE_GRADS)
    np.savez(tmp / "data.npz",
             tp_cfg=np.array(TP_CFG, dtype=object),
             tp_params=np.array(flatten_tree(tp_params), dtype=object),
             tp_tokens=tp_tokens,
             moe_cfg=np.array(MOE_CFG, dtype=object),
             moe_model_params=np.array(flatten_tree(moe_model_params),
                                       dtype=object),
             moe_tokens=moe_tokens, moe_group=MOE_GROUP,
             aux_weight=AUX_WEIGHT,
             moe_params=np.array({k: v["kernel"] for k, v in
                                  moe_params.items()}, dtype=object),
             moe_x=x, moe_ct=ct,
             ep_cases=np.array(EP_CASES, dtype=object),
             pipe_ws=pw, pipe_bs=pb, pipe_x=px, pg_ws=gw, pg_bs=gb, pg_x=gx,
             c_x=_constrain_inputs()[0], c_ct=_constrain_inputs()[1])
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
            log, _ = p.communicate(timeout=300)
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
    return {n: _launch(tmp_path_factory.mktemp(f"mp{n}"), n) for n in (4, 8)}


# ------------------------------------------------------------ the specs
@pytest.mark.parametrize("kind,axes", [
    ("tp", {"dp": 2, "tp": 4}), ("moe", {"dp": 2, "tp": 2, "ep": 2}),
    ("moe", {"dp": 2, "ep": 4})])
def test_spec_table_matches_jax_params_shardings(kind, axes):
    _, params, _ = _flax_init(kind)
    want = {k: tuple(v.spec) for k, v in flatten_tree(
        jax_params_shardings(params, jax_make_mesh(axes))).items()}
    cfg = TP_CFG if kind == "tp" else MOE_CFG
    model = Transformer(TransformerConfig(**cfg, dtype=torch.float32),
                        device="cpu")
    got = params_shardings(model, make_mesh(axes, devices=range(8)))
    assert sorted(got) == sorted(want)
    for name, sharding in got.items():
        assert sharding.spec == want[name], name


def test_sharding_rules_split_the_big_matrices():
    model = Transformer(TransformerConfig(**TP_CFG, dtype=torch.float32),
                        device="cpu")
    sh = params_shardings(model, make_mesh({"dp": 2, "tp": 4},
                                           devices=range(8)))
    assert "tp" in sh["block_0.attn.qkv.kernel"].spec
    assert sh["block_0.mlp.up.kernel"].spec[-1] == "tp"
    assert sh["block_0.mlp.down.kernel"].spec[0] == "tp"
    assert all(a is None for a in sh["block_0.ln1.scale"].spec)


def test_mesh_validation_matches_jax():
    for axes in ({"dp": 3}, {"dp": -1, "tp": -1}, {"dp": 0},
                 {"dp": 2.0}, {"dp": 3, "tp": -1}):
        with pytest.raises(ValueError) as want:
            jax_make_mesh(axes, devices=jax.devices()[:8])
        with pytest.raises(ValueError) as got:
            make_mesh(axes, devices=range(8))
        assert str(got.value) == str(want.value)
    mesh = make_mesh({"dp": 2, "tp": -1}, devices=range(8))
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert mesh.coords(6) == {"dp": 1, "tp": 2}


# -------------------------------------------------------- switch routing
@pytest.mark.parametrize("padded", [False, True])
def test_switch_route_matches_jax(padded):
    rng = np.random.RandomState(5)
    logits = rng.randn(96, 6).astype(np.float32)
    valid = np.arange(96) < (90 if padded else 96)
    capacity = 14
    jd, jc, jaux = jax_moe_mod.switch_route(
        jnp.asarray(logits), 6, capacity,
        valid=jnp.asarray(valid) if padded else None)
    route = switch_route(torch.from_numpy(logits), 6, capacity,
                         valid=torch.from_numpy(valid) if padded else None)
    np.testing.assert_array_equal(route.dispatch().numpy(), np.asarray(jd))
    np.testing.assert_allclose(route.combine().numpy(), np.asarray(jc),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(route.aux), float(jaux), rtol=1e-6)
    want_idx = np.asarray(jnp.argmax(jax.nn.softmax(jnp.asarray(logits)),
                                     axis=-1))
    np.testing.assert_array_equal(route.expert.numpy(), want_idx)


@pytest.mark.parametrize("cf,group_size,rows", [
    (2.0, 4096, None),      # test_moe_layer_runs_and_balances' setting
    (1.0, 4096, None),      # capacity drops
    (4.0, 32, 62),          # one full group and one padded
    (4.0, 128, 62),         # the same tokens in one group
    (4.0, 32, 61),          # a prime count
])
def test_switch_moe_matches_jax(cf, group_size, rows):
    params, x, ct = _moe_inputs()
    if rows is not None:
        x, ct = x[:rows], ct[:rows]
    want = _jax_moe(cf, group_size, rows)
    p = {k: {"kernel": torch.tensor(v["kernel"], requires_grad=True)}
         for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = switch_moe(xt, p, capacity_factor=cf, group_size=group_size)
    ((out * torch.from_numpy(ct)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), want[0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), want[1], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want[2], rtol=1e-4,
                               atol=1e-5)
    for k in ("router", "wi", "wo"):
        np.testing.assert_allclose(p[k]["kernel"].grad.numpy(),
                                   want[3][f"moe.{k}.kernel"], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert 0.0 < float(aux) < 16.0


def test_moe_padding_equals_one_group():
    """``test_moe_padding_for_awkward_token_counts``: with no drops,
    routing 62 tokens in a full and a padded group of 32 equals one
    group."""
    params, x, _ = _moe_inputs()
    p = {k: {"kernel": torch.tensor(v["kernel"])} for k, v in params.items()}
    xt = torch.from_numpy(x[:62])
    padded, _ = switch_moe(xt, p, capacity_factor=8.0, group_size=32)
    whole, _ = switch_moe(xt, p, capacity_factor=8.0, group_size=128)
    np.testing.assert_allclose(padded.numpy(), whole.numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------- MoE transformer, one rank
def test_moe_transformer_and_apply_with_aux_match_flax(moe_group):
    want = _flax_lm_routed("moe", AUX_WEIGHT)
    _, params, tokens = _flax_init("moe")
    model = Transformer(TransformerConfig(**MOE_CFG, dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(params_from_flax(params))
    tok = torch.from_numpy(tokens).long()
    logits, aux = apply_with_aux(model, tok)
    loss = lm_loss(logits, tok) + AUX_WEIGHT * aux
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), want["aux"], rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), want["loss"],
                               rtol=1e-5)
    assert {"block_1.moe.router_kernel", "block_1.moe.wi_kernel",
            "block_1.moe.wo_kernel"} <= set(want["grads"])
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want["grads"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_apply_with_aux_without_moe_is_zero():
    model = Transformer(TransformerConfig(**TP_CFG, dtype=torch.float32),
                        device="cpu")
    logits, aux = apply_with_aux(model, torch.zeros(1, 8, dtype=torch.long))
    assert logits.shape == (1, 8, TP_CFG["vocab_size"])
    assert float(aux) == 0.0


# ------------------------------------------------------------ multi-rank
def _mesh_of(n):
    return {"dp": 2, "tp": 2} if n == 4 else {"dp": 2, "tp": 4}


@pytest.mark.parametrize("n", [4, 8])
def test_tensor_parallel_logits_match_flax(port_runs, n):
    want = _flax_lm("tp")
    rows = 2
    mesh = make_mesh(_mesh_of(n), devices=range(n))
    for r, res in enumerate(port_runs[n]):
        dp = mesh.coords(r)["dp"]
        np.testing.assert_allclose(res["tp"]["logits"],
                                   want["logits"][dp * rows:(dp + 1) * rows],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [4, 8])
def test_tensor_parallel_gradients_match_jax_grad(port_runs, n):
    """Each rank's block of the gradients, averaged over dp, is its block
    of ``jax.grad`` of the loss over the whole batch: no replicated
    gradient ``tp`` times too large, no shard's partial."""
    want = _flax_lm("tp")
    mesh = make_mesh(_mesh_of(n), devices=range(n))
    model = Transformer(TransformerConfig(**TP_CFG, dtype=torch.float32),
                        device="cpu")
    shardings = params_shardings(model, mesh)
    for r, res in enumerate(port_runs[n]):
        for k, g in res["tp"]["grads"].items():
            block = shard_tensor(torch.from_numpy(want["grads"][k]),
                                 shardings[k], rank=r).numpy()
            np.testing.assert_allclose(g, block, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} {k}")


def test_tensor_parallel_grid_and_mesh_bitwise(port_runs):
    for res in port_runs[4]:
        assert res["tp_grid_logits"].tobytes() == res["tp"]["logits"].tobytes()


@pytest.mark.parametrize("case", sorted(EP_CASES))
def test_moe_expert_parallel_matches_unsharded(port_runs, case):
    axes, cf = EP_CASES[case]
    out, aux, gx, gp = _jax_moe(cf)
    mesh = make_mesh(axes, devices=range(4))
    shardings = params_shardings(
        {k: v for k, v in gp.items()}, mesh)
    for r, res in enumerate(port_runs[4]):
        got = res[case]
        np.testing.assert_allclose(got["out"], out, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["x"], gx, rtol=1e-4, atol=1e-4)
        for k, g in got["grads"].items():
            block = shard_tensor(torch.from_numpy(gp[k]), shardings[k],
                                 rank=r).numpy()
            assert g.shape == block.shape, k
            np.testing.assert_allclose(g, block, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} {k}")


def test_moe_transformer_expert_parallel_matches_jax_grad(port_runs):
    """``{"dp": 2, "ep": 2}``: logits, aux, and every rank's block of the
    gradients (router and experts included) averaged over dp, against
    ``jax.grad`` of ``lm_loss + 0.01 * aux`` over the whole batch."""
    want = _flax_lm_routed("moe", AUX_WEIGHT)
    mesh = make_mesh({"dp": 2, "ep": 2}, devices=range(4))
    model = Transformer(TransformerConfig(**MOE_CFG, dtype=torch.float32),
                        device="cpu")
    shardings = params_shardings(model, mesh)
    auxes = []
    for r, res in enumerate(port_runs[4]):
        got = res["moe_model"]
        dp = mesh.coords(r)["dp"]
        np.testing.assert_allclose(got["logits"],
                                   want["logits"][dp * 2:(dp + 1) * 2],
                                   rtol=1e-4, atol=1e-4)
        auxes.append(got["aux"])
        assert set(got["grads"]) == set(want["grads"])
        for k, g in got["grads"].items():
            block = shard_tensor(torch.from_numpy(want["grads"][k]),
                                 shardings[k], rank=r).numpy()
            np.testing.assert_allclose(g, block, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} {k}")
    # the JAX aux averages over the whole batch's groups, the port's over
    # the replica's; the replicas' mean is the whole batch's
    np.testing.assert_allclose(np.mean(auxes), want["aux"], rtol=1e-5)


@pytest.mark.parametrize("spec,key", [(PIPE, "pipe"),
                                      (PIPE_GRADS, "pipe_grads")])
def test_pipeline_matches_reference_pipelined(port_runs, spec, key):
    out, (gws, gbs) = _jax_pipe(spec)
    for res in port_runs[8]:
        got = res[key]
        np.testing.assert_allclose(got["out"], out, rtol=1e-5, atol=1e-5)
        stage = res["coords"]["pp"]
        # this rank's stage row carries its gradient, the others none
        np.testing.assert_allclose(got["ws"][stage], gws[stage], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["bs"][stage], gbs[stage], rtol=1e-4,
                                   atol=1e-4)
        others = [i for i in range(4) if i != stage]
        assert not got["ws"][others].any() and not got["bs"][others].any()


def test_pipeline_grid_and_mesh_bitwise(port_runs):
    for res in port_runs[8]:
        assert res["pipe_grid"].tobytes() == res["pipe"]["out"].tobytes()


def test_constrain_cuts_the_block_and_gathers_the_gradient(port_runs):
    """``constrain(x, mesh, None, "tp")``: this rank's columns of a
    replicated ``x`` (the JAX function's value is ``x`` itself, laid out
    over ``tp``), and the gradient of the whole ``x`` back on every rank;
    a mesh without ``tp`` leaves ``x`` as it is."""
    x, ct = _constrain_inputs()
    mesh = make_mesh({"dp": 2, "tp": 2}, devices=range(4))
    for r, res in enumerate(port_runs[4]):
        tp = mesh.coords(r)["tp"]
        got = res["constrain"]
        np.testing.assert_array_equal(got["y"], x[:, tp * 4:(tp + 1) * 4])
        np.testing.assert_array_equal(got["grad"], ct)
        assert got["noop"]


@pytest.fixture
def no_executor_env(monkeypatch):
    monkeypatch.delenv("HVD_TPU_EXECUTOR", raising=False)
    yield monkeypatch


def test_mesh_executor_is_selected_by_env(no_executor_env):
    """``HVD_TPU_EXECUTOR=mesh`` runs the eager plane on ``MeshExecutor``
    (its mesh the ``dp`` axis over the plane's ranks); another value
    raises the reference's text at init."""
    import horovod_tpu_torch as hvd
    from horovod_tpu.common.config import _validated_executor
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.sharding import MeshExecutor

    no_executor_env.setenv("HVD_TPU_EXECUTOR", "bogus")
    with pytest.raises(ValueError) as want:
        _validated_executor("bogus")
    with pytest.raises(ValueError) as got:
        hvd.init(device="cpu")
    assert str(got.value) == str(want.value)
    assert not hvd.is_initialized()
    no_executor_env.setenv("HVD_TPU_EXECUTOR", "mesh")
    hvd.init(device="cpu")
    try:
        ex = basics._get_state().controller._executor
        assert isinstance(ex, MeshExecutor)
        assert ex.mesh.shape == {"dp": 1}
        sharding = ex.named_sharding("dp", None)
        assert sharding.spec == ("dp", None) and sharding.mesh is ex.mesh
        t = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(shard_tensor(t, sharding, rank=0), t)
        assert torch.equal(hvd.allreduce(t, op=hvd.Sum), t)
    finally:
        hvd.shutdown()


def test_data_parallel_and_hierarchical_meshes_match_jax():
    from horovod_tpu.parallel import data_parallel_mesh as jax_dp_mesh
    from horovod_tpu.parallel import hierarchical_mesh as jax_hier_mesh
    from horovod_tpu_torch.parallel import (data_parallel_mesh,
                                            hierarchical_mesh)

    devices = jax.devices()[:8]
    assert data_parallel_mesh(devices=range(8)).shape == dict(
        jax_dp_mesh(devices=devices).shape)
    assert hierarchical_mesh(4, devices=range(8)).shape == dict(
        jax_hier_mesh(4, devices=devices).shape)
    with pytest.raises(ValueError) as want:
        jax_hier_mesh(3, devices=devices)
    with pytest.raises(ValueError) as got:
        hierarchical_mesh(3, devices=range(8))
    assert str(got.value) == str(want.value)
