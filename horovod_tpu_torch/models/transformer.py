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

Every ``moe_every``-th block (``cfg.moe_every``) has a switch-MoE FFN
(``MoeMlp``, ``parallel/moe.py``) with flax's parameter names
``moe.router_kernel``, ``moe.wi_kernel`` and ``moe.wo_kernel``; its
balancing loss is what :func:`apply_with_aux` returns beside the logits.

``mesh=`` (a ``parallel.mesh`` mesh or ``hvd.grid(...)``) builds the
model split over the mesh's ``tp`` and ``ep`` axes: every parameter is
drawn at full size from the seed and cut to this rank's block by
``tensor_parallel.transformer_sharding_rules``, and the modules run the
Megatron collectives of ``parallel/tensor_parallel.py`` on the ``tp``
group (heads, ``d_ff`` and the vocabulary split; the ``lm_head``'s logits
all-gathered so that the loss sees whole rows) and the expert split of
``parallel/moe.py`` on the ``ep`` group.  A ``dp`` axis changes nothing in
the model: ``DistributedOptimizer(group=mesh.group("dp"))`` averages the
gradients over it.
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
from horovod_tpu_torch.parallel.mesh import as_mesh
from horovod_tpu_torch.parallel.moe import (moe_kernel_init,
                                            moe_param_shapes, switch_moe)
from horovod_tpu_torch.parallel.tensor_parallel import (axis_torch_group,
                                                        copy_to, gather_from,
                                                        reduce_from,
                                                        shard_params)


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
    # every k-th block uses a switch-MoE FFN (0 = dense only)
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
        self.dtype = dtype
        self.kernel = _normal((d_in,) + out_shape, 1.0 / math.sqrt(d_in),
                              generator)

    def forward(self, x):
        w = self.kernel.to(self.dtype).reshape(self.kernel.shape[0], -1)
        y = torch.matmul(x.to(self.dtype), w)
        # the kernel's own shape: under tensor parallelism a block of it
        return y.reshape(x.shape[:-1] + self.kernel.shape[1:])


class Embed(nn.Module):
    """A lookup table; with a ``group`` (tensor parallelism) it holds
    this rank's block of rows, looks up the ids that fall in it (zeros
    for the others) and sums the blocks' lookups over the group.  Only
    the ids that fall in the block index the table: a clamped index for
    the others would pile their zero gradients onto one row, which the
    indexing backward adds up one by one (8-12 ms a step at tp 2-4 on an
    H100, PERF.md)."""

    def __init__(self, num, features, dtype, generator, group=None):
        super().__init__()
        self.dtype = dtype
        self.group = group
        self.embedding = _normal((num, features), 1.0 / math.sqrt(features),
                                 generator)

    def forward(self, ids):
        table = self.embedding.to(self.dtype)
        if self.group is None:
            return table[ids]
        rows = table.shape[0]
        local = ids - torch.distributed.get_rank(self.group) * rows
        hit = (local >= 0) & (local < rows)
        out = table.new_zeros(ids.shape + table.shape[1:])
        out[hit] = table[local[hit]]
        return reduce_from(out, self.group)


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
    """Self-attention; under tensor parallelism (``tp``, a group) the
    ``qkv`` projection holds this rank's heads (column-parallel) and
    ``out`` their rows (row-parallel)."""

    def __init__(self, cfg, generator, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
        self.qkv = Dense(cfg.d_model, (3, h, d), cfg.dtype, generator)
        self.out = Dense(h * d, cfg.d_model, cfg.dtype, generator)

    def forward(self, x):
        qkv = self.qkv(copy_to(x, self.tp))
        q, k, v = qkv.unbind(dim=-3)
        attn = self.cfg.attn_fn or default_attention()
        o = attn(q, k, v, causal=True)
        return reduce_from(self.out(o.reshape(o.shape[:-2] + (-1,))),
                           self.tp)


class Mlp(nn.Module):
    """The FFN; under tensor parallelism ``up`` holds this rank's columns
    and ``down`` their rows."""

    def __init__(self, cfg, generator, tp=None):
        super().__init__()
        self.tp = tp
        self.up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, generator)
        self.down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, generator)

    def forward(self, x):
        # flax's nn.gelu is the tanh approximation
        h = F.gelu(self.up(copy_to(x, self.tp)), approximate="tanh")
        return reduce_from(self.down(h), self.tp)


class MoeMlp(nn.Module):
    """The switch-MoE FFN (``parallel/moe.py``; flax's parameter names).
    Each forward keeps its balancing loss in ``aux`` (flax's ``sow``) and
    its routing counts in ``stats``."""

    def __init__(self, cfg, generator, mesh=None):
        super().__init__()
        self.mesh = mesh
        for name, shape in moe_param_shapes(cfg.d_model, cfg.d_ff,
                                            cfg.n_experts).items():
            setattr(self, f"{name}_kernel", nn.Parameter(
                moe_kernel_init(generator, shape)))
        self.aux = None
        self.stats = {}

    def forward(self, x):
        params = {name: {"kernel": getattr(self, f"{name}_kernel")}
                  for name in ("router", "wi", "wo")}
        out, self.aux = switch_moe(x, params, mesh=self.mesh,
                                   stats=self.stats)
        return out


class Block(nn.Module):
    def __init__(self, cfg, generator, use_moe=False, mesh=None):
        super().__init__()
        self.cfg = cfg
        tp = axis_torch_group(mesh, "tp")
        self.ln1 = FusedLayerNorm(cfg.d_model)
        self.attn = Attention(cfg, generator, tp)
        self.ln2 = FusedLayerNorm(cfg.d_model)
        if use_moe:
            self.moe = MoeMlp(cfg, generator, mesh)
        else:
            self.mlp = Mlp(cfg, generator, tp)

    def forward(self, x):
        x = x + self.attn(self.ln1(x).to(self.cfg.dtype))
        ff = self.moe if hasattr(self, "moe") else self.mlp
        return x + ff(self.ln2(x).to(self.cfg.dtype))


class Transformer(nn.Module):
    """Token ids ``[B, T]`` -> logits ``[B, T, vocab]`` (causal LM).

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and moved to ``device``: the card unless ``device="cpu"``.
    With ``mesh``, each is then cut to this rank's block (see the module
    docstring); every rank builds the model, in the same order (the
    mesh's process groups are made here)."""

    def __init__(self, cfg, device=None, seed=0, mesh=None):
        super().__init__()
        from horovod_tpu_torch.common.basics import resolve_device

        device = resolve_device(device)
        self.cfg = cfg
        self.mesh = None if mesh is None else as_mesh(mesh)
        self.tp = axis_torch_group(self.mesh, "tp")
        gen = torch.Generator().manual_seed(seed)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, gen,
                           self.tp)
        self.pos_embed = Embed(cfg.max_len, cfg.d_model, cfg.dtype, gen)
        for i in range(cfg.n_layers):
            use_moe = bool(cfg.moe_every) and (i + 1) % cfg.moe_every == 0
            setattr(self, f"block_{i}", Block(cfg, gen, use_moe, self.mesh))
        self.ln_f = FusedLayerNorm(cfg.d_model)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, gen)
        if self.mesh is not None:
            shards = shard_params(self, self.mesh)
            for name, p in self.named_parameters():
                p.data = shards[name]
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
        logits = self.lm_head(copy_to(x.to(self.cfg.dtype), self.tp))
        return gather_from(logits, self.tp, dim=-1)


def apply_with_aux(model, tokens, positions=None):
    """Forward pass returning ``(logits, moe_aux_loss)``: the balancing
    losses of the MoE blocks summed (zero without MoE blocks).  Training
    code for MoE configs adds the aux term to the loss, or the router
    gets no balancing gradient."""
    logits = model(tokens, positions=positions)
    auxes = [m.aux for m in model.modules() if isinstance(m, MoeMlp)]
    aux = sum(auxes) if auxes else torch.zeros((), device=logits.device)
    return logits, aux


def lm_loss(logits, tokens):
    """Mean next-token cross-entropy over all ``B * T`` rows.  The labels
    are ``roll(tokens, -1)``: the last position wraps to token 0, as in
    the JAX package."""
    labels = torch.roll(tokens, -1, dims=-1)
    return softmax_xent(logits, labels).mean()
