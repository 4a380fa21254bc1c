"""Ulysses (DeepSpeed-style) sequence parallelism through all-to-all
(port of ``horovod_tpu/parallel/ulysses.py``).

Two all-to-alls re-shard the activations instead of rotating K/V: on the
way in the layout flips from sequence-sharded ``[B, T/P, H, D]`` to
head-sharded ``[B, T, H/P, D]``, so that each rank computes exact
full-sequence attention on its share of the heads; on the way out the
flip is undone.  The head count must be divisible by the axis size; for
fewer heads use ring attention.
"""

from horovod_tpu_torch.parallel._comm import all_to_all_4d, axis_index, \
    axis_size
from horovod_tpu_torch.parallel.ring_attention import (_my_shard,
                                                       reference_attention)


def _default_attn(q):
    if q.is_cuda:
        from horovod_tpu_torch.ops.cuda.flash_attention import \
            flash_attention
        return flash_attention
    return reference_attention


def seq_to_heads(x, group=None):
    """``[B, T/P, H, D]`` -> ``[B, T, H/P, D]``."""
    return all_to_all_4d(x, split_axis=2, concat_axis=1, group=group)


def heads_to_seq(x, group=None):
    """``[B, T, H/P, D]`` -> ``[B, T/P, H, D]``, the inverse of
    :func:`seq_to_heads`."""
    return all_to_all_4d(x, split_axis=1, concat_axis=2, group=group)


def ulysses_attention(q, k, v, *, causal=False, scale=None, attn_fn=None,
                      group=None):
    """Exact attention over sequence-sharded ``[B, T/P, H, D]`` inputs
    through head re-sharding; the output has the same layout.
    ``attn_fn(q, k, v, causal=..., scale=...)`` is the full-sequence
    attention on each rank.  ``None``: the flash kernels
    (``ops.cuda.flash_attention.flash_attention``) for CUDA tensors, as
    ``ring_attention`` resolves ``use_flash=None``, and
    ``reference_attention`` for CPU tensors."""
    if attn_fn is None:
        attn_fn = _default_attn(q)
    h = q.shape[2]
    p_size = axis_size(group)
    if h % p_size != 0:
        raise ValueError(
            f"Ulysses needs heads ({h}) divisible by axis size ({p_size}); "
            "use ring_attention for few-head long-context models")
    qh, kh, vh = (seq_to_heads(x, group) for x in (q, k, v))
    return heads_to_seq(attn_fn(qh, kh, vh, causal=causal, scale=scale),
                        group)


def ulysses_self_attention(q, k, v, *, causal=False, scale=None,
                           attn_fn=None, group=None):
    """Every rank holds the global ``[B, T, H, D]`` tensors: it takes its
    contiguous shard, runs :func:`ulysses_attention` and returns its shard
    of the output."""
    p_size, rank = axis_size(group), axis_index(group)
    q, k, v = (_my_shard(x, p_size, rank) for x in (q, k, v))
    return ulysses_attention(q, k, v, causal=causal, scale=scale,
                             attn_fn=attn_fn, group=group)
