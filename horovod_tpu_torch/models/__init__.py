import numpy as np
import torch

from horovod_tpu_torch.models.inception import InceptionV3  # noqa: F401
from horovod_tpu_torch.models.mlp import MLP  # noqa: F401
from horovod_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    MoeMlp,
    Transformer,
    TransformerConfig,
    apply_with_aux,
    lm_loss,
)
from horovod_tpu_torch.models.vgg import VGG, VGG16, VGG19  # noqa: F401


def flatten_tree(tree, prefix=""):
    """Nested ``{name: {...: array}}`` -> ``{"a.b.c": array}``."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_tree(value, name + "."))
        else:
            flat[name] = value
    return flat


def _is_conv_kernel(name, value):
    """A 4-D ``kernel`` of a module named as flax names convolutions
    (``Conv_<i>``, and ``conv_init``/``conv_proj`` in the reference's
    ResNet).  The transformer's 4-D ``qkv`` kernel is not one."""
    parts = name.split(".")
    return (np.ndim(value) == 4 and parts[-1] == "kernel"
            and len(parts) > 1 and parts[-2].lower().startswith("conv"))


def params_from_flax(tree, batch_stats=None, mesh=None):
    """The JAX package's ``params`` pytree (nested dicts of numpy arrays),
    and a CNN's ``batch_stats``, -> a ``state_dict`` for the port's model
    of the same config.

    The port keeps flax's names, so the conversion is a rename of
    ``a/b/c`` to ``a.b.c``: ``block_0.attn.qkv.kernel``, ``conv_init.kernel``,
    ``BottleneckBlock_0.BatchNorm_0.scale``, ``Dense_0.kernel``, ...
    ``Dense`` kernels keep flax's ``(in, *out)`` layout (the transformer's
    ``qkv`` kernel ``(d_model, 3, h, d)`` too); convolution kernels go
    from flax's HWIO to torch's OIHW; the ``batch_stats``' ``mean`` and
    ``var`` become the BatchNorm buffers of those names.  Every tensor
    comes out fp32.  With ``mesh`` (the transformer's ``mesh=``), each
    parameter is this rank's block (``parallel.tensor_parallel.shard_params``)."""
    flat = flatten_tree(tree)
    out = {}
    for name, value in flat.items():
        value = np.array(value, dtype=np.float32)
        if _is_conv_kernel(name, value):
            value = np.ascontiguousarray(value.transpose(3, 2, 0, 1))
        out[name] = torch.from_numpy(value)
    for name, value in flatten_tree(batch_stats or {}).items():
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    if mesh is not None:
        from horovod_tpu_torch.parallel.tensor_parallel import shard_params
        out = shard_params(out, mesh)
    return out
