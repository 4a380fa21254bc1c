"""The port's transformer-LM (``horovod_tpu_torch/models``) against the JAX
package's ``Transformer`` + ``lm_loss`` on the CPU: the JAX model is
initialised, its weights carried across with ``params_from_flax``, and
logits, loss and every gradient compared.  Small config: 2 layers,
d_model 64, 4 heads, vocab 512, T 32.

fp32 tolerances: logits and loss 1e-5 relative (the matrix products sum
in another order), gradients rtol 1e-4 / atol 1e-6.  bf16 is compared
loosely (activations round to bf16 at other places in the two
frameworks): 5e-2 relative to each tensor's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import lm_loss as jax_lm_loss
from horovod_tpu.parallel.ring_attention import \
    reference_attention as jax_attention
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      flatten_tree, lm_loss,
                                      params_from_flax)
from horovod_tpu_torch.parallel.ring_attention import reference_attention

SMALL = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
             max_len=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that this file leaves the
    cores to the test files running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(seed=0, batch=2, t=32):
    return np.random.RandomState(seed).randint(0, 512, (batch, t)).astype(
        np.int32)


def _jax_run(jdtype, tokens):
    cfg = JaxConfig(**SMALL, dtype=jdtype, attn_fn=jax_attention)
    model = JaxTransformer(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SMALL["max_len"]), jnp.int32))["params"]

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return jax_lm_loss(logits, jnp.asarray(tokens)), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    return to_np(params), np.asarray(logits, np.float32), float(loss), \
        flatten_tree(to_np(grads))


def _torch_run(tdtype, params, tokens):
    model = Transformer(TransformerConfig(**SMALL, dtype=tdtype),
                        device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    tok = torch.from_numpy(tokens).long()
    logits = model(tok)
    loss = lm_loss(logits, tok)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return logits.detach().float().numpy(), loss.item(), grads, logits.dtype


@pytest.fixture(scope="module")
def fp32_runs():
    tokens = _tokens()
    params, jlogits, jloss, jgrads = _jax_run(jnp.float32, tokens)
    return params, (jlogits, jloss, jgrads), _torch_run(
        torch.float32, params, tokens)


def test_parameter_names_match_flax(fp32_runs):
    params, _, _ = fp32_runs
    model = Transformer(TransformerConfig(**SMALL), device="cpu")
    names = set(model.state_dict())
    assert names == set(flatten_tree(params))
    assert model.state_dict()["block_0.attn.qkv.kernel"].shape == (64, 3, 4,
                                                                   16)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fp32_logits_and_loss_match(fp32_runs):
    _, (jlogits, jloss, _), (tlogits, tloss, _, _) = fp32_runs
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)


def test_fp32_every_gradient_matches(fp32_runs):
    _, (_, _, jgrads), (_, _, tgrads, _) = fp32_runs
    assert set(tgrads) == set(jgrads)
    for name in sorted(jgrads):
        np.testing.assert_allclose(tgrads[name], jgrads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_bf16_matches_loosely():
    tokens = _tokens(seed=1)
    params, jlogits, jloss, jgrads = _jax_run(jnp.bfloat16, tokens)
    tlogits, tloss, tgrads, dtype = _torch_run(torch.bfloat16, params,
                                               tokens)
    assert dtype == torch.bfloat16
    np.testing.assert_allclose(tlogits, jlogits, rtol=5e-2,
                               atol=5e-2 * np.abs(jlogits).max())
    np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
    for name in sorted(jgrads):
        err = np.linalg.norm(tgrads[name] - jgrads[name])
        assert err <= 5e-2 * np.linalg.norm(jgrads[name]) + 1e-6, name


def test_lm_loss_labels_wrap_to_token_zero():
    """labels = roll(tokens, -1): the last position predicts token 0."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    tokens = rng.randint(0, 11, (2, 5))
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    want = -np.take_along_axis(logp, labels[..., None], -1).mean()
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens))
    jgot = jax_lm_loss(jnp.asarray(logits), jnp.asarray(tokens))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(got), float(jgot), rtol=1e-6)


def test_gelu_is_the_tanh_approximation():
    import flax.linen as nn

    from horovod_tpu_torch.models.transformer import Mlp

    cfg = TransformerConfig(**dict(SMALL, d_ff=64), dtype=torch.float32)
    mlp = Mlp(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        mlp.down.kernel.copy_(torch.eye(64))
        mlp.up.kernel.copy_(torch.eye(64))
    x = np.linspace(-4, 4, 64, dtype=np.float32)[None]
    got = mlp(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,tq,tk", [(True, 16, 16), (False, 16, 16),
                                          (True, 8, 24), (False, 12, 6)])
def test_reference_attention_matches_jax(causal, tq, tk):
    rng = np.random.RandomState(tq + tk)
    q = rng.randn(2, tq, 3, 8).astype(np.float32)
    k = rng.randn(2, tk, 3, 8).astype(np.float32)
    v = rng.randn(2, tk, 3, 8).astype(np.float32)
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
    got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("option", [{"moe_every": 2}])
def test_later_slice_options_raise(option):
    """The options of later slices are ported and raise no more: ``remat``
    (held to flax's ``nn.remat`` in ``tests/test_torch_sequence_parallel.py``)
    and ``moe_every``, whose every second block is a switch-MoE block with
    flax's parameter names (held to flax in
    ``tests/test_torch_model_parallel.py``)."""
    model = Transformer(TransformerConfig(**SMALL, **option), device="cpu")
    names = dict(model.named_parameters())
    assert {"block_1.moe.router_kernel", "block_1.moe.wi_kernel",
            "block_1.moe.wo_kernel"} <= set(names)
    assert "block_0.mlp.up.kernel" in names
    assert not any(n.startswith("block_1.mlp") for n in names)
