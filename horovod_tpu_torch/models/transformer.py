"""GPT-style decoder-only transformer (port of
``horovod_tpu/models/transformer.py``).

Parameters keep the flax names and layouts — ``Dense`` kernels are
``(in, out)``, the ``qkv`` kernel is ``(d_model, 3, heads, head_dim)`` —
so that :func:`horovod_tpu_torch.models.params_from_flax` carries a JAX
parameter tree across name for name.  Parameters are fp32; activations
and products run in ``cfg.dtype`` (bf16 by default), LayerNorm
statistics and the loss in fp32.

LayerNorm, attention and the loss go through the port's kernels
(``ops/cuda/layer_norm.py``, ``ops/cuda/flash_attention.py``,
``ops/cuda/softmax_xent.py``), which take their plain versions for CPU
tensors.
"""

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops.cuda.flash_attention import flash_attention
from horovod_tpu_torch.ops.cuda.layer_norm import layer_norm
from horovod_tpu_torch.ops.cuda.softmax_xent import softmax_xent


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    max_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # attn_fn(q, k, v, causal=..., scale=...) over [B, T, H, D]
    attn_fn: Optional[Callable] = None
    # switch-MoE FFN every k-th block comes in a later slice
    moe_every: int = 0
    n_experts: int = 8
    # recompute each block's forward in the backward pass (flax's
    # nn.remat(Block)): activation memory of one block instead of all
    remat: bool = False


def default_attention():
    """Flash attention (``ops/cuda/flash_attention.py``): the hand-written
    kernels for CUDA tensors, their plain versions for CPU tensors."""
    return flash_attention


def _normal(shape, std, generator):
    return nn.Parameter(torch.randn(*shape, generator=generator) * std)


class Dense(nn.Module):
    """``x @ kernel`` computed in ``dtype``; the kernel is fp32 ``(in,
    *out)`` as in flax's ``Dense``/``DenseGeneral``."""

    def __init__(self, d_in, out_shape, dtype, generator):
        super().__init__()
        out_shape = tuple(out_shape) if isinstance(
            out_shape, (tuple, list)) else (out_shape,)
        self.out_shape = out_shape
        self.dtype = dtype
        self.kernel = _normal((d_in,) + out_shape, 1.0 / math.sqrt(d_in),
                              generator)

    def forward(self, x):
        w = self.kernel.to(self.dtype).reshape(self.kernel.shape[0], -1)
        y = torch.matmul(x.to(self.dtype), w)
        return y.reshape(x.shape[:-1] + self.out_shape)


class Embed(nn.Module):
    def __init__(self, num, features, dtype, generator):
        super().__init__()
        self.dtype = dtype
        self.embedding = _normal((num, features), 1.0 / math.sqrt(features),
                                 generator)

    def forward(self, ids):
        return self.embedding.to(self.dtype)[ids]


class FusedLayerNorm(nn.Module):
    """LayerNorm through the fused kernel (``ops/cuda/layer_norm.py``).
    Parameter names match flax's ``nn.LayerNorm``."""

    def __init__(self, d, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
        self.qkv = Dense(cfg.d_model, (3, h, d), cfg.dtype, generator)
        self.out = Dense(h * d, cfg.d_model, cfg.dtype, generator)

    def forward(self, x):
        qkv = self.qkv(x)
        q, k, v = qkv.unbind(dim=-3)
        attn = self.cfg.attn_fn or default_attention()
        o = attn(q, k, v, causal=True)
        return self.out(o.reshape(o.shape[:-2] + (-1,)))


class Mlp(nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, generator)
        self.down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, generator)

    def forward(self, x):
        # flax's nn.gelu is the tanh approximation
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.cfg = cfg
        self.ln1 = FusedLayerNorm(cfg.d_model)
        self.attn = Attention(cfg, generator)
        self.ln2 = FusedLayerNorm(cfg.d_model)
        self.mlp = Mlp(cfg, generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x).to(self.cfg.dtype))
        return x + self.mlp(self.ln2(x).to(self.cfg.dtype))


class Transformer(nn.Module):
    """Token ids ``[B, T]`` -> logits ``[B, T, vocab]`` (causal LM).

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and moved to ``device``: the card unless ``device="cpu"``."""

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        if cfg.moe_every:
            raise NotImplementedError(
                "moe_every: switch-MoE blocks are not ported yet")
        from horovod_tpu_torch.common.basics import resolve_device

        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, gen)
        self.pos_embed = Embed(cfg.max_len, cfg.d_model, cfg.dtype, gen)
        for i in range(cfg.n_layers):
            setattr(self, f"block_{i}", Block(cfg, gen))
        self.ln_f = FusedLayerNorm(cfg.d_model)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, gen)
        self.to(device)

    def forward(self, tokens, positions=None):
        """``positions``: the global position of each token, ``[T]`` or
        ``[B, T]`` (default ``arange(T)``).  A rank of a sequence-parallel
        run holds a shard of the sequence (zigzag-reordered under zigzag
        attention) and passes its tokens' places in the whole one, as the
        JAX package's model sees them in its global view."""
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(positions)
        for i in range(self.cfg.n_layers):
            block = getattr(self, f"block_{i}")
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        return self.lm_head(x.to(self.cfg.dtype))


def lm_loss(logits, tokens):
    """Mean next-token cross-entropy over all ``B * T`` rows.  The labels
    are ``roll(tokens, -1)``: the last position wraps to token 0, as in
    the JAX package."""
    labels = torch.roll(tokens, -1, dims=-1)
    return softmax_xent(logits, labels).mean()
