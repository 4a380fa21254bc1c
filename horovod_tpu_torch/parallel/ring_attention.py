"""Ring attention: sequence parallelism over the sequence axis (port of
``horovod_tpu/parallel/ring_attention.py``).

Queries stay on their rank while the key/value blocks rotate around the
ring (``_comm.ring_permute``); each rank merges the blocks it sees into
a streaming (online) softmax in fp32, so the result is exact attention
whatever the number of hops.

Shapes per rank: q ``[B, Tq, H, D]``, k and v ``[B, Tkv, H, D]``, the
global sequence split over the ranks in order (rank ``i`` holds queries
``[i*Tq, (i+1)*Tq)``).  Each block is the port's ``flash_attention(...,
return_lse=True)`` (the hand-written kernels on the card, their plain
versions for CPU tensors) or the dense fp32 einsum of :func:`_block_attend`.
``reference_attention`` is the dense single-device oracle.
"""

import math

import torch

from horovod_tpu_torch.parallel._comm import (anchor, axis_index, axis_size,
                                              ring_permute)

_NEG_INF = -1e30


def _block_attend(q, k, v, *, scale, mask=None):
    """One block: (numerator ``[B, Tq, H, D]``, denominator and running max
    ``[B, H, Tq]``), fp32.  ``mask`` broadcasts to ``[B, H, Tq, Tkv]``
    (True: attend)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # fully masked rows have m == -1e30, where exp(s - m) would be 1
    p = torch.where(m[..., None] > _NEG_INF / 2, p, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, l, m


def _combine(o1, l1, m1, o2, l2, m2):
    """Merge two streaming-softmax partial results (the flash rule)."""
    m = torch.maximum(m1, m2)
    a1 = torch.where(m1 > _NEG_INF / 2, torch.exp(m1 - m), 0.0)
    a2 = torch.where(m2 > _NEG_INF / 2, torch.exp(m2 - m), 0.0)
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return o, l1 * a1 + l2 * a2, m


def _flash_block(q, k, v, *, scale, causal):
    """One block through ``flash_attention``: the normalised output with
    denominator 1 in lse units, the form :func:`_combine` merges."""
    from horovod_tpu_torch.ops.cuda.flash_attention import flash_attention

    out, lse = flash_attention(q, k.to(q.dtype), v.to(q.dtype),
                               causal=causal, scale=scale, return_lse=True)
    return out.float(), torch.ones_like(lse), lse


def _finish(o, l, dtype):
    denom = torch.where(l > 0, l, 1.0).transpose(1, 2)[..., None]
    return (o / denom).to(dtype)


def _empty(q):
    b, tq, h, d = q.shape
    return (q.new_zeros((b, tq, h, d), dtype=torch.float32),
            q.new_zeros((b, h, tq), dtype=torch.float32),
            q.new_full((b, h, tq), _NEG_INF, dtype=torch.float32))


def _use_flash(use_flash, q):
    """``None``: on for CUDA tensors, as the reference turns it on for a
    TPU backend."""
    return q.is_cuda if use_flash is None else bool(use_flash)


def ring_attention(q, k, v, *, causal=False, scale=None, use_flash=None,
                   group=None):
    """Exact multi-head attention with K/V blocks rotating over the
    sequence axis; every rank of ``group`` calls it with its shard.

    ``causal``: positions are global.  Blocks wholly ahead of this rank's
    queries are skipped; the diagonal block runs causal, blocks behind it
    unmasked.  The flash route (``use_flash``) is taken only when ``not
    causal or Tq == Tkv``: the kernel's local causal mask is the global
    one only on equal shards; the dense path takes the rest."""
    p_size, my_idx = axis_size(group), axis_index(group)
    b, tq, h, d = q.shape
    tkv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    flash = _use_flash(use_flash, q) and (not causal or tq == tkv)
    q32 = q.float()

    def block(acc, kc, vc, kv_idx):
        if causal and kv_idx * tkv > my_idx * tq + tq - 1:
            return acc   # wholly ahead: merging nothing leaves acc as is
        if flash:
            part = _flash_block(q, kc, vc, scale=scale,
                                causal=causal and kv_idx == my_idx)
        else:
            mask = None
            if causal:
                q_pos = my_idx * tq + torch.arange(tq, device=q.device)
                k_pos = kv_idx * tkv + torch.arange(tkv, device=q.device)
                mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
            part = _block_attend(q32, kc, vc, scale=scale, mask=mask)
        return _combine(*acc, *part)

    # the resident block first, then P - 1 rotations; K and V rotate in
    # their own dtype (bf16 on the main path), cast per block
    acc = block(_empty(q), k, v, my_idx)
    kc, vc = k, v
    for s in range(1, p_size):
        kc, vc = ring_permute(kc, vc, group=group)
        acc = block(acc, kc, vc, (my_idx - s) % p_size)
    o, l, _ = acc
    if p_size > 1:
        o = anchor(o, kc, vc)
    return _finish(o, l, q.dtype)


def _my_shard(x, p_size, rank):
    t = x.shape[1]
    if t % p_size:
        raise ValueError(f"sequence length {t} not divisible by {p_size}")
    c = t // p_size
    return x[:, rank * c:(rank + 1) * c]


def ring_self_attention(q, k, v, *, causal=False, scale=None,
                        use_flash=None, group=None):
    """Every rank holds the global ``[B, T, H, D]`` tensors: it takes its
    own contiguous shard of the sequence, runs :func:`ring_attention` and
    returns its shard of the output."""
    p_size, rank = axis_size(group), axis_index(group)
    q, k, v = (_my_shard(x, p_size, rank) for x in (q, k, v))
    return ring_attention(q, k, v, causal=causal, scale=scale,
                          use_flash=use_flash, group=group)


def reference_attention(q, k, v, *, causal=False, scale=None):
    """Dense single-device attention over ``[B, T, H, D]`` tensors, in
    fp32: the score product, a top-left causal mask ``q_pos >= k_pos``
    filled with -1e30, the softmax and the second product
    (``ring_attention.py:215-228`` of the reference)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        msk = (torch.arange(tq, device=s.device)[:, None]
               >= torch.arange(tk, device=s.device)[None, :])
        s = s.masked_fill(~msk, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
