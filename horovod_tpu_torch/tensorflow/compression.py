"""Gradient compression for the TensorFlow binding (port of
``horovod_tpu/tensorflow/compression.py``; reference:
``horovod/tensorflow/compression.py``): casts on the TensorFlow side,
``fp16`` and ``bf16`` on the wire with the source dtype restored after.

Imports without TensorFlow; a compressor raises ``ImportError`` naming
it on first use."""

try:
    import tensorflow as tf
    _TF_ERROR = None
except ImportError as _exc:
    tf = None
    _TF_ERROR = _exc


def _require_tf():
    if tf is None:
        raise ImportError(
            "horovod_tpu_torch.tensorflow.compression requires TensorFlow, "
            "which is not installed in this environment") from _TF_ERROR


class Compressor:
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class NoneCompressor(Compressor):
    pass


class _CastCompressor(Compressor):
    WIRE_DTYPE = None   # a tf.dtypes name

    @classmethod
    def compress(cls, tensor):
        _require_tf()
        wire = tf.as_dtype(cls.WIRE_DTYPE)
        if tensor.dtype.is_floating and tensor.dtype != wire:
            return tf.cast(tensor, wire), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None:
            return tf.cast(tensor, ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    WIRE_DTYPE = "float16"


class BF16Compressor(_CastCompressor):
    WIRE_DTYPE = "bfloat16"


class Compression:
    """The reference's namespace (``Compression.none`` /
    ``Compression.fp16``) and ``bf16``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
