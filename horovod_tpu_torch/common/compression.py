"""Cast-style gradient compression (port of
``horovod_tpu/common/compression.py``'s none / bf16 / fp16 compressors).

A compressor narrows a floating tensor before the collective and
restores its dtype after.  Block-scaled int8 comes in a later slice.
"""

import torch


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


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    bf16 = BF16Compressor
    fp16 = FP16Compressor


# Canonical names travel in the negotiation (request signatures, fusion
# bucket keys); classes stay the Python API surface.
COMPRESSION_NAMES = {
    "none": NoneCompressor,
    "bf16": BF16Compressor,
    "fp16": FP16Compressor,
}


def resolve_compression(value, default="none") -> str:
    """Normalize a user-facing compression argument: ``None`` (the
    default), a canonical name, or a ``Compressor`` class or instance, to
    its canonical name.  ``"int8"`` (block-scaled int8) raises
    ``NotImplementedError``: it is ROADMAP A.6."""
    if value is None:
        value = default
    name = value.lower() if isinstance(value, str) else getattr(
        value, "name", None)
    if name == "int8":
        raise NotImplementedError(
            "int8 block-scaled compression is not ported yet (ROADMAP A.6)")
    if isinstance(name, str) and name in COMPRESSION_NAMES:
        return name
    raise ValueError(
        f"unknown compression {value!r}; expected one of "
        f"{sorted(COMPRESSION_NAMES)} or a Compression class")
