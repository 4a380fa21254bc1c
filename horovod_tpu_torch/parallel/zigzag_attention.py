"""Zigzag ring attention: load-balanced causal sequence parallelism (port
of ``horovod_tpu/parallel/zigzag_attention.py``).

The global sequence is cut into ``2P`` chunks and rank ``i`` holds the
pair (chunk ``i``, chunk ``2P-1-i``): one early, one late.  When rank
``i`` meets the K/V of rank ``j != i``, exactly two of the four chunk
interactions are causally live, and both are wholly unmasked:

- ``q_hi x kv_lo``, always (chunk ``2P-1-i`` is later than any low chunk);
- ``q_hi x kv_hi`` if ``j > i``, else ``q_lo x kv_lo``: one of the two,
  same shape.  The reference selects the operands with ``jnp.where``; a
  torch rank knows ``j`` and branches in Python, merging the block into
  the accumulator the reference picks (``acc_hi`` when ``j > i``).

So every rank computes two unmasked ``C x C`` attends a hop (and three
resident ones): the ring is balanced.  :func:`zigzag_shard` and
:func:`zigzag_unshard` reorder between the natural and the zigzag
layouts.
"""

import math

import torch

from horovod_tpu_torch.parallel._comm import (axis_index, axis_size,
                                              ring_permute)
from horovod_tpu_torch.parallel.ring_attention import (
    _block_attend, _combine, _empty, _finish, _flash_block, _use_flash)


def zigzag_chunk_order(p_size):
    """Chunk ids in shard order: rank ``i`` gets ``[i, 2P-1-i]``."""
    order = []
    for i in range(p_size):
        order.extend([i, 2 * p_size - 1 - i])
    return order


def _chunk(x, p_size, axis):
    t = x.shape[axis]
    if t % (2 * p_size):
        raise ValueError(
            f"sequence length {t} not divisible by 2*{p_size}")
    return t // (2 * p_size)


def zigzag_shard(x, p_size, axis=1):
    """Reorder a global ``[..., T, ...]`` tensor so that a contiguous
    split over ``p_size`` ranks hands rank ``i`` chunks ``(i, 2P-1-i)``."""
    c = _chunk(x, p_size, axis)
    return torch.cat([x.narrow(axis, k * c, c)
                      for k in zigzag_chunk_order(p_size)], dim=axis)


def zigzag_unshard(x, p_size, axis=1):
    """Inverse of :func:`zigzag_shard`."""
    c = _chunk(x, p_size, axis)
    order = zigzag_chunk_order(p_size)
    inverse = [0] * len(order)
    for pos, chunk in enumerate(order):
        inverse[chunk] = pos
    return torch.cat([x.narrow(axis, pos * c, c) for pos in inverse],
                     dim=axis)


def _attend(q, k, v, *, scale, causal, use_flash):
    """One block attend -> (numerator, denominator, max)."""
    if use_flash:
        return _flash_block(q, k, v, scale=scale, causal=causal)
    mask = None
    if causal:
        mask = (torch.arange(q.shape[1], device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        mask = mask[None, None]
    return _block_attend(q.float(), k, v, scale=scale, mask=mask)


def zigzag_ring_attention(q, k, v, *, scale=None, use_flash=None,
                          group=None):
    """Balanced causal ring attention over the sequence axis.  This
    rank's ``[B, 2C, H, D]`` shard is chunk ``i`` then chunk ``2P-1-i``
    of the global sequence (:func:`zigzag_shard`).  Always causal: the
    non-causal ring is balanced already (``ring_attention``)."""
    p_size, my_idx = axis_size(group), axis_index(group)
    b, t2, h, d = q.shape
    if t2 % 2:
        raise ValueError(f"zigzag shard holds 2 chunks; got T={t2}")
    c = t2 // 2
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    flash = _use_flash(use_flash, q)

    def att(qq, kk, vv, causal):
        return _attend(qq, kk, vv, scale=scale, causal=causal,
                       use_flash=flash)

    q_lo, q_hi = q[:, :c], q[:, c:]
    # resident step: each chunk causal on itself, q_hi over kv_lo in full
    acc_lo = _combine(*_empty(q_lo), *att(q_lo, k[:, :c], v[:, :c], True))
    acc_hi = _combine(*_empty(q_hi), *att(q_hi, k[:, c:], v[:, c:], True))
    acc_hi = _combine(*acc_hi, *att(q_hi, k[:, :c], v[:, :c], False))

    kc, vc = k, v
    for s in range(1, p_size):
        kc, vc = ring_permute(kc, vc, group=group)
        j = (my_idx - s) % p_size            # origin rank of this K/V
        acc_hi = _combine(*acc_hi, *att(q_hi, kc[:, :c], vc[:, :c], False))
        if j > my_idx:
            acc_hi = _combine(*acc_hi, *att(q_hi, kc[:, c:], vc[:, c:],
                                            False))
        else:
            acc_lo = _combine(*acc_lo, *att(q_lo, kc[:, :c], vc[:, :c],
                                            False))
    return torch.cat([_finish(*acc_lo[:2], q.dtype),
                      _finish(*acc_hi[:2], q.dtype)], dim=1)


def zigzag_ring_self_attention(q, k, v, *, scale=None, use_flash=None,
                               group=None):
    """Every rank holds the global ``[B, T, H, D]`` tensors in natural
    order: each zigzag-reorders them, takes its shard, runs
    :func:`zigzag_ring_attention` and returns its shard of the output in
    the zigzag layout (the ranks' shards, concatenated in rank order and
    passed through :func:`zigzag_unshard`, are the natural order)."""
    p_size, rank = axis_size(group), axis_index(group)
    c2 = 2 * _chunk(q, p_size, 1)
    q, k, v = (zigzag_shard(x, p_size)[:, rank * c2:(rank + 1) * c2]
               for x in (q, k, v))
    return zigzag_ring_attention(q, k, v, scale=scale, use_flash=use_flash,
                                 group=group)
