"""Gradient compression (port of ``horovod_tpu/common/compression.py``).

The cast compressors (none / bf16 / fp16) narrow a floating tensor
before the collective and restore its dtype after.

Block-scaled int8 (EQuARX, arXiv:2506.17615): each block of
``INT8_BLOCK`` = 256 elements carries one fp32 scale (max-abs / 127),
values travel as int8, and the reduction accumulates in fp32.  Each rank
quantizes against its own scales, so the int8 values cannot ride a plain
sum: :func:`quantized_allreduce` is a quantized reduce-scatter
(``all_to_all`` of int8 blocks and scales, fp32 accumulate) then a
quantized allgather (requantize the reduced chunk, ``all_gather`` int8
and scales, dequantize).  Each element passes through two
quantizations, so its error is at most ``(n + 1) * blockmax / 254`` at
``n`` ranks.  The collectives take a ``torch.distributed`` process group
(``None``: the default group) where the JAX functions take an
``axis_name``.

The numbers are the reference's: the values are divided by the scale
(not multiplied by its reciprocal, which rounds differently), rounded
half to even, clipped to +-127; a zero block gets scale 1.0.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch.common.ops_enum import INT8_BLOCK

# the ``*_single`` collectives where torch has them (the ``*_tensor``
# names are deprecated there)
all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# --------------------------------------------------------- block quantization
def quantize_int8_blocks(x, block=INT8_BLOCK):
    """Quantize ``x`` (float, last dim divisible by ``block``) to (int8
    values of ``x``'s shape, fp32 scales of shape ``x.shape[:-1] +
    (x.shape[-1] // block,)``)."""
    shape = x.shape
    xb = x.float().reshape(shape[:-1] + (shape[-1] // block, block))
    maxabs = xb.abs().amax(dim=-1)
    scale = torch.where(maxabs > 0, maxabs / 127.0,
                        torch.ones_like(maxabs))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(shape), scale


def dequantize_int8_blocks(q, scale, block=INT8_BLOCK):
    """Inverse of :func:`quantize_int8_blocks`; returns fp32."""
    shape = q.shape
    qb = q.float().reshape(shape[:-1] + (shape[-1] // block, block))
    return (qb * scale[..., None]).reshape(shape)


# ------------------------------------------------ quantized collectives
def accumulate_int8(q, scale, block=INT8_BLOCK):
    """The fp32 sum over dim 0 of the dequantized rows of ``q``
    (``[n, chunk]`` int8, ``[n, chunk // block]`` scales).  The rows are
    added in rank order, each as one fused multiply-add of its values and
    scales into the sum (``addcmul``): XLA compiles the reference's
    dequantize-then-sum so, and a sum rounded once more can round a
    requantized value that lies on a tie the other way."""
    n, chunk = q.shape
    qb = q.float().view(n, chunk // block, block)
    sb = scale.view(n, chunk // block, 1)
    acc = qb[0] * sb[0]
    for i in range(1, n):
        acc.addcmul_(qb[i], sb[i])
    return acc.view(chunk)


def quantized_reduce_scatter(x2d, group=None, block=INT8_BLOCK):
    """``x2d``: ``[n, chunk]`` float with ``chunk % block == 0`` and ``n``
    the group's size; row ``j`` is this rank's contribution to rank
    ``j``'s chunk.  -> this rank's reduced ``[chunk]`` chunk, fp32."""
    q, s = quantize_int8_blocks(x2d, block)
    qx, sx = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(qx, q, group=group)
    dist.all_to_all_single(sx, s, group=group)
    return accumulate_int8(qx, sx, block)


def quantized_all_gather(chunk, group=None, block=INT8_BLOCK):
    """Requantize this rank's reduced ``[chunk]`` and gather every rank's:
    -> the ``[n * chunk]`` fp32 vector, the same on every rank."""
    q, s = quantize_int8_blocks(chunk, block)
    n = dist.get_world_size(group)
    qg, sg = q.new_empty(n * q.numel()), s.new_empty(n * s.numel())
    all_gather_into(qg, q, group=group)
    all_gather_into(sg, s, group=group)
    return dequantize_int8_blocks(qg, sg, block)


def int8_chunk(size, n, block=INT8_BLOCK):
    """Elements of each rank's chunk when ``size`` elements are padded to
    ``n`` chunks of whole blocks."""
    return -(-size // (n * block)) * block


def quantized_allreduce(flat, group=None, block=INT8_BLOCK):
    """Block-scaled int8 allreduce of a flat float vector over ``group``:
    -> the fp32 sum."""
    n = dist.get_world_size(group)
    size = flat.numel()
    chunk = int8_chunk(size, n, block)
    x = F.pad(flat.float(), (0, n * chunk - size))
    red = quantized_reduce_scatter(x.view(n, chunk), group, block)
    return quantized_all_gather(red, group, block)[:size]


def int8_wire_bytes(size, n, block=INT8_BLOCK):
    """Bytes one rank sends in :func:`quantized_allreduce` of ``size``
    elements at ``n`` ranks: in each leg, the ``n - 1`` chunks of int8
    values and fp32 scales bound for (or copied to) the other ranks."""
    chunk = int8_chunk(size, n, block)
    return 2 * (n - 1) * (chunk + 4 * (chunk // block))


# ------------------------------------------------------------- compressors
class Compressor:
    """Interface for compressing and decompressing a given tensor."""

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context) for decompression."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Default: no compression."""

    name = "none"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class BF16Compressor(_CastCompressor):
    """Cast floating tensors to bfloat16 before the collective."""

    name = "bf16"
    wire_dtype = torch.bfloat16


class FP16Compressor(_CastCompressor):
    """Cast floating tensors to float16 before the collective."""

    name = "fp16"
    wire_dtype = torch.float16


class Int8Compressor(Compressor):
    """Block-scaled int8 (block 256, fp32 scales).

    Callers that own the collective (the eager plane,
    ``allreduce_gradients``, ``DistributedOptimizer``) see
    ``block_quantized`` and run the quantized decomposition above.  The
    standalone ``compress`` simulates the quantize -> dequantize round
    trip locally, as the reference's does: the numbers of the quantized
    wire, not its bytes.  Non-float tensors and tensors smaller than one
    block pass through exactly."""

    name = "int8"
    block_quantized = True
    block = INT8_BLOCK

    @staticmethod
    def compress(tensor):
        if not is_quantized(tensor):
            return tensor, None
        flat = tensor.reshape(-1).float()
        pad = -flat.numel() % INT8_BLOCK
        q, s = quantize_int8_blocks(F.pad(flat, (0, pad)))
        sim = dequantize_int8_blocks(q, s)[:flat.numel()]
        return sim.to(tensor.dtype).reshape(tensor.shape), None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


def is_quantized(tensor):
    """Whether int8 compression quantizes this tensor: a float tensor of
    at least one block."""
    return tensor.dtype.is_floating_point and tensor.numel() >= INT8_BLOCK


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    bf16 = BF16Compressor
    fp16 = FP16Compressor
    int8 = Int8Compressor


# Canonical names travel in the negotiation (request signatures, fusion
# bucket keys) and in HVD_TPU_COMPRESSION; classes stay the Python API
# surface.
COMPRESSION_NAMES = {
    "none": NoneCompressor,
    "bf16": BF16Compressor,
    "fp16": FP16Compressor,
    "int8": Int8Compressor,
}


def resolve_compression(value, default="none") -> str:
    """Normalize a user-facing compression argument: ``None`` (the job's
    default), a canonical name, or a ``Compressor`` class or instance, to
    its canonical name."""
    if value is None:
        value = default
    if isinstance(value, str):
        name = value.lower()
        if name not in COMPRESSION_NAMES:
            raise ValueError(
                f"unknown compression {value!r}; expected one of "
                f"{sorted(COMPRESSION_NAMES)}")
        return name
    name = getattr(value, "name", None)
    if isinstance(name, str) and name in COMPRESSION_NAMES:
        return name
    raise ValueError(
        f"unknown compression {value!r}; expected one of "
        f"{sorted(COMPRESSION_NAMES)} or a Compression class")


def compressor_for(name):
    """Canonical name -> Compressor class."""
    return COMPRESSION_NAMES[resolve_compression(name)]
