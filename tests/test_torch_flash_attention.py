"""The port's flash attention (``horovod_tpu_torch/ops/cuda/flash_attention.py``)
on CPU tensors (its plain versions) against the JAX package's Pallas
flash kernel in interpret mode, forward and gradients, and inside the
transformer.  Inputs come from numpy seeds.

Tolerances are those of ``tests/test_flash_attention.py``: forward 2e-5,
gradients 1e-4, lse 1e-5, the lse gradient 2e-4, bf16 0.1 against the
dense fp32 reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import lm_loss as jax_lm_loss
from horovod_tpu.ops.pallas import flash_attention as jax_flash
from horovod_tpu.parallel import reference_attention as jax_reference
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      flatten_tree, lm_loss,
                                      params_from_flax)
from horovod_tpu_torch.models.transformer import default_attention
from horovod_tpu_torch.ops import cuda as kernels
from horovod_tpu_torch.ops.cuda.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_fwd)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that this file leaves the
    cores to the test files running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(b=2, t=128, h=4, d=32, seed=0, t_kv=None):
    rng = np.random.RandomState(seed)
    t_kv = t if t_kv is None else t_kv
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t_kv, h, d).astype(np.float32),
            rng.randn(b, t_kv, h, d).astype(np.float32))


def _jax_grads(q, k, v, causal):
    def loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, interpret=True)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(q, k, v, causal):
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*qkv, causal=causal)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in qkv]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas(causal):
    q, k, v = _rand()
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                     interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,t,t_kv,h,d,causal", [
    (1, 64, 64, 2, 16, False),
    (1, 64, 64, 2, 16, True),
    (2, 96, 96, 4, 32, True),     # not a multiple of the kernels' tile
    (2, 64, 128, 4, 32, False),   # cross-attention
    (2, 64, 128, 2, 16, True),    # top-left causal, T_q < T_kv
    (1, 128, 64, 2, 16, True),    # T_q > T_kv
])
def test_forward_and_gradients_match_pallas(b, t, t_kv, h, d, causal):
    q, k, v = _rand(b, t, h, d, seed=t + t_kv, t_kv=t_kv)
    jout, jgrads = _jax_grads(q, k, v, causal)
    tout, tgrads = _torch_grads(q, k, v, causal)
    np.testing.assert_allclose(tout, jout, rtol=2e-5, atol=2e-5)
    for got, want, name in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d", [24, 40, 192, 256, 320, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dims_beyond_the_wgmma_kernels_match_pallas(d, causal):
    """The head dims that run the card's generic kernels (not a multiple
    of 16, above 128; above 256 the column split): the plain path against
    the Pallas kernel, forward and gradients, at the tolerances above."""
    q, k, v = _rand(1, 32, 2, d, seed=d + causal)
    jout, jgrads = _jax_grads(q, k, v, causal)
    tout, tgrads = _torch_grads(q, k, v, causal)
    np.testing.assert_allclose(tout, jout, rtol=2e-5, atol=2e-5)
    for got, want, name in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_causal_mask_is_top_left_when_t_q_below_t_kv():
    """q_pos >= k_pos from index 0: query 0 sees key 0 alone, so its
    output is v[0] (bottom-right alignment would let it see 65 keys)."""
    q, k, v = _rand(1, 64, 2, 16, seed=5, t_kv=128)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0], rtol=1e-6,
                               atol=1e-6)
    dense = jax_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(dense), rtol=2e-5,
                               atol=2e-5)


def test_lse_matches_pallas():
    q, k, v = _rand(b=1, t=64, h=2, d=16, seed=3)
    jout, jlse = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                           return_lse=True, interpret=True)
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, return_lse=True)
    assert lse.shape == (1, 2, 64) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)


def test_lse_gradient_matches_pallas():
    """The lse cotangent folds into delta (delta -= g_lse)."""
    q, k, v = _rand(b=1, t=32, h=2, d=16, seed=4)

    def jax_loss(q, k, v):
        out, lse = jax_flash(q, k, v, causal=False, return_lse=True,
                             interpret=True)
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(lse))

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = flash_attention(*qkv, causal=False, return_lse=True)
    ((out ** 2).sum() + lse.sin().sum()).backward()
    for x, want in zip(qkv, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_bf16():
    q, k, v = _rand(t=128)
    want = jax_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    got = flash_attention(*(torch.from_numpy(x).bfloat16()
                            for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0.1, atol=0.1)


def test_fully_masked_rows_get_no_gradient():
    """A row whose lse is -1e30 (every key masked) recomputes p = 0, as
    the reference's guard does, and adds nothing to dq, dk or dv."""
    q, k, v = map(torch.from_numpy, _rand(b=1, t=16, h=1, d=16, seed=6))
    do = torch.ones_like(q)
    out, lse = flash_attention_fwd(q, k, v, True, 0.25)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    lse_masked = lse.clone()
    lse_masked[..., 3] = -1e30
    dq = flash_attention_bwd_dq(q, k, v, do, lse_masked, delta, True, 0.25)
    assert torch.equal(dq[:, 3], torch.zeros_like(dq[:, 3]))
    # only row 3 carries a cotangent (and a delta)
    do_row, delta_row = torch.zeros_like(do), torch.zeros_like(delta)
    do_row[:, 3], delta_row[..., 3] = 1.0, 1.0
    dk, dv = flash_attention_bwd_dkv(q, k, v, do_row, lse_masked, delta_row,
                                     True, 0.25)
    assert not dv.any() and not dk.any()


def test_default_attention_is_flash_and_counts_no_cpu_launch():
    assert default_attention() is flash_attention
    q, k, v = map(torch.from_numpy, _rand(b=1, t=8, h=1, d=16))
    kernels.reset_launch_counts()
    flash_attention(q, k, v, causal=True)
    assert kernels.launch_counts() == dict.fromkeys(
        kernels.launch_counts(), 0)
    assert {"flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv"} <= set(kernels.launch_counts())


@pytest.mark.parametrize("fn", ["fwd", "dq", "dkv"])
def test_wrappers_raise_on_other_devices(fn):
    """A tensor that is neither on the CPU nor on the card is refused,
    never sent to the plain version."""
    x = torch.empty(1, 8, 2, 16, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if fn == "fwd":
            flash_attention_fwd(x, x, x, True, 0.25)
        elif fn == "dq":
            flash_attention_bwd_dq(x, x, x, x, lse, lse, True, 0.25)
        else:
            flash_attention_bwd_dkv(x, x, x, x, lse, lse, True, 0.25)


SMALL = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
             max_len=32)


# head dim 512: the card runs it on the column-split kernels
WIDE_HEADS = dict(vocab_size=512, n_layers=2, d_model=1024, n_heads=2,
                  d_ff=2048, max_len=32)


def test_transformer_matches_jax_with_pallas_flash():
    """The port's model (default attention: flash) against the JAX model
    with ``attn_fn=flash_attention`` (Pallas, interpret mode): logits,
    loss and every gradient, fp32, at the tolerances of
    ``tests/test_torch_transformer.py``."""
    _transformer_matches_jax(SMALL)


def test_wide_head_transformer_matches_jax_with_pallas_flash():
    """As above with two heads of 512 (d_model 1024), past the widest
    single-pass head dim of the card's kernels."""
    _transformer_matches_jax(WIDE_HEADS)


def _transformer_matches_jax(cfg):
    tokens = np.random.RandomState(0).randint(0, 512, (2, 32)).astype(
        np.int32)
    model = JaxTransformer(JaxConfig(**cfg, dtype=jnp.float32,
                                     attn_fn=jax_flash))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 32), jnp.int32))["params"]

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        return jax_lm_loss(logits, jnp.asarray(tokens)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    jgrads = flatten_tree(jax.tree.map(lambda a: np.asarray(a), jgrads))

    tmodel = Transformer(TransformerConfig(**cfg, dtype=torch.float32),
                         device="cpu")
    tmodel.load_state_dict(params_from_flax(
        jax.tree.map(lambda a: np.asarray(a), params)), strict=True)
    tok = torch.from_numpy(tokens).long()
    logits = tmodel(tok)
    loss = lm_loss(logits, tok)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert set(grads) == set(jgrads)
    for name in sorted(jgrads):
        np.testing.assert_allclose(grads[name], jgrads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
