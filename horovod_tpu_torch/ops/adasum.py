"""Adasum: scale-invariant gradient combination (port of
``horovod_tpu/ops/adasum.py``).

Two vectors ``a`` and ``b`` combine as

    a' = (1 - a.b / (2 |a|^2)) * a  +  (1 - a.b / (2 |b|^2)) * b

and ``n`` ranks' vectors combine pairwise along the reference's tree:
rank ``r`` pairs with ``r ^ 2^level`` (``horovod/common/ops/adasum/
adasum.h:194-330``).  An operand whose norm is zero contributes plain
addition, so a joined rank's zeros fall out.

- :func:`adasum_reduce_stacked` reduces a ``[n, ...]`` stack of the
  ranks' contributions (the result of an ``all_gather``) along that
  tree: the flat path of the eager plane and of ``allreduce_gradients``.
- :func:`adasum_vhdd` is the large-tensor path on a ``torch.distributed``
  group: vector halving, distance doubling.  At distance ``d`` each rank
  trades half of its piece with rank ``r ^ d`` (``batch_isend_irecv``);
  the dot product and the two squared norms of the two vectors being
  combined are then spread over the ``2d`` ranks of a block, and one
  ``all_reduce`` over the whole group sums them: each rank writes its
  three partial sums into its block's row of a ``[n / 2d, 3]`` tensor.
  (The reference reduces them over a communicator a level, the JAX
  package over ``axis_index_groups``; one group for every level needs
  no groups made on the fly, which ranks would make in different orders
  and hang.)  Each rank ends with ``1/n`` of the result, in bit-reversed
  order, and one ``all_gather`` puts it back in place.
- :func:`adasum_reduce_hierarchical` is the reference's NCCL + MPI
  Adasum (``adasum_gpu_operations.cc``): a sum ``reduce_scatter`` in the
  local group, VHDD over the cross group with the scalars summed over
  the local group too, an ``all_gather`` back, divided by the local size:
  Adasum of the local groups' averages.

All arithmetic is in fp32; each result is cast back to the input's
dtype, at every level of the tree as the reference's ``adasum_pair``
does.  ``adasum_reference`` is the numpy oracle of the tests (float64).
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common.compression import (all_gather_into,
                                                  reduce_scatter_into)


def _pair_coefficients(dot, norm_a, norm_b):
    """Adasum's pair coefficients; an operand of norm zero takes 1
    (reference: ``_pair_coefficients``, adasum.py:34)."""
    a_coeff = torch.where(norm_a > 0, 1.0 - dot / (2.0 * norm_a), 1.0)
    b_coeff = torch.where(norm_b > 0, 1.0 - dot / (2.0 * norm_b), 1.0)
    return a_coeff, b_coeff


def _combine(a, b):
    """Rows of ``a`` and ``b`` (``[m, k]`` fp32) combined pair by pair."""
    dot = (a * b).sum(dim=1, keepdim=True)
    na = (a * a).sum(dim=1, keepdim=True)
    nb = (b * b).sum(dim=1, keepdim=True)
    ca, cb = _pair_coefficients(dot, na, nb)
    return ca * a + cb * b


def adasum_pair(a, b):
    """Combine two tensors of one shape with the Adasum formula."""
    out = _combine(a.float().reshape(1, -1), b.float().reshape(1, -1))
    return out.reshape(a.shape).to(a.dtype)


def adasum_reduce_stacked(stacked):
    """Reduce ``[n, ...]`` along dim 0 with the pairing tree (rank r with
    r ^ 2^level); ``n`` must be a power of two."""
    n = stacked.shape[0]
    if n & (n - 1):
        raise ValueError(f"Adasum requires a power-of-two rank count, got {n}")
    shape, dtype = stacked.shape[1:], stacked.dtype
    level = stacked.reshape(n, -1)
    while level.shape[0] > 1:
        half = level.shape[0] // 2
        pairs = level.reshape(half, 2, -1)
        level = _combine(pairs[:, 0].float(), pairs[:, 1].float()).to(dtype)
    return level[0].reshape(shape)


def _global_rank(group, r):
    return r if group is None else dist.get_global_rank(group, r)


def adasum_vhdd(x, group=None, scalar_group=None):
    """VHDD Adasum of every rank's ``x`` over ``group`` (a
    ``torch.distributed`` group; None: the default group), whose size
    must be a power of two.  ``scalar_group`` (default ``group``) sums
    each level's dot products and norms: a group over more ranks when
    the vectors are themselves spread over them (the hierarchical mode's
    local chunks).  Each rank writes its row ``r // 2d`` of the level's
    ``[n / 2d, 3]`` tensor, where ``r`` is its rank in ``group``; the
    ranks of ``scalar_group`` outside ``group`` must hold the ranks of
    their own copies of ``group`` in the same order.  -> the combined
    tensor, the same on every rank."""
    n = dist.get_world_size(group)
    if n & (n - 1):
        raise ValueError(f"Adasum VHDD requires power-of-two ranks, got {n}")
    if n == 1:
        return x
    r = dist.get_rank(group)
    size = x.numel()
    padded = -(-size // n) * n
    piece = F.pad(x.float().reshape(-1), (0, padded - size))
    d = 1
    while d < n:
        half = piece.numel() // 2
        low, high = piece[:half], piece[half:]
        keep_low = (r // d) % 2 == 0
        send, mine = (high, low) if keep_low else (low, high)
        recv = torch.empty_like(send)
        peer = _global_rank(group, r ^ d)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send.contiguous(), peer, group),
                dist.P2POp(dist.irecv, recv, peer, group)]):
            req.wait()
        # a is the lower block's vector, b the upper's, on every rank of
        # the block
        a, b = (mine, recv) if keep_low else (recv, mine)
        rows = torch.zeros(n // (2 * d), 3, dtype=torch.float32,
                           device=piece.device)
        rows[r // (2 * d)] = torch.stack([a @ b, a @ a, b @ b])
        dist.all_reduce(rows, group=scalar_group if scalar_group is not None
                        else group)
        dot, na, nb = rows[r // (2 * d)]
        ca, cb = _pair_coefficients(dot, na, nb)
        piece = ca * a + cb * b
        d *= 2
    # rank r holds the chunk at the bit reversal of r (adasum.py:146-155)
    levels = n.bit_length() - 1
    gathered = torch.empty(n, piece.numel(), dtype=piece.dtype,
                           device=piece.device)
    all_gather_into(gathered.view(-1), piece, group=group)
    order = [int(format(i, f"0{levels}b")[::-1], 2) for i in range(n)]
    full = gathered[order].reshape(-1)
    return full[:size].reshape(x.shape).to(x.dtype)


def adasum_reduce_hierarchical(x, local_group, cross_group,
                               scalar_group=None):
    """Hierarchical Adasum: sum ``reduce_scatter`` over ``local_group``,
    :func:`adasum_vhdd` over ``cross_group`` with the scalars summed over
    ``scalar_group`` (a group over the local and the cross ranks, the
    world of the hierarchy; None: the default group), ``all_gather``
    back over ``local_group``, divided by the local size (reference:
    ``adasum_reduce_hierarchical``, adasum.py:158-175)."""
    local_size = dist.get_world_size(local_group)
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % local_size
    flat = F.pad(flat, (0, pad))
    chunk = torch.empty(flat.numel() // local_size, dtype=torch.float32,
                        device=flat.device)
    reduce_scatter_into(chunk, flat, op=dist.ReduceOp.SUM, group=local_group)
    combined = adasum_vhdd(chunk, cross_group,
                           scalar_group=scalar_group if scalar_group
                           is not None else dist.group.WORLD)
    full = torch.empty_like(flat)
    all_gather_into(full, combined, group=local_group)
    if pad:
        full = full[:-pad]
    return (full / local_size).reshape(x.shape).to(x.dtype)


def adasum_reference(tensors):
    """Numpy oracle (float64): the pairing tree over a list of per-rank
    arrays (reference: ``adasum_reference``, adasum.py:178)."""
    level = [np.asarray(t, dtype=np.float64) for t in tensors]
    if len(level) & (len(level) - 1):
        raise ValueError("power-of-two rank count required")
    while len(level) > 1:
        combined = []
        for i in range(0, len(level), 2):
            a, b = level[i].reshape(-1), level[i + 1].reshape(-1)
            dot = float(a @ b)
            norm_a = float(a @ a)
            norm_b = float(b @ b)
            a_coeff = 1.0 - dot / (2.0 * norm_a) if norm_a > 0 else 1.0
            b_coeff = 1.0 - dot / (2.0 * norm_b) if norm_b > 0 else 1.0
            combined.append(
                (a_coeff * a + b_coeff * b).reshape(level[i].shape))
        level = combined
    return level[0]
