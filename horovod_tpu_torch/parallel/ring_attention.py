"""Dense attention (port of ``reference_attention``,
``horovod_tpu/parallel/ring_attention.py:215-228``).

Written out in explicit torch ops, in fp32: the score product, a
top-left causal mask ``q_pos >= k_pos`` filled with ``-1e30``, the
softmax and the second product.  Layout ``[B, T, H, D]`` as in the JAX
package.  The model's attention is the flash kernel
(``ops/cuda/flash_attention.py``); this dense version stays as an oracle.
Ring, zigzag and Ulysses attention are later slices.
"""

import math

import torch

_NEG_INF = -1e30


def reference_attention(q, k, v, *, causal=False, scale=None):
    """Dense single-device attention over ``[B, T, H, D]`` tensors."""
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
