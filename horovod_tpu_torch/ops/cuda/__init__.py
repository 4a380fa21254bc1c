"""Hand-written CUDA kernels for the H100 and their wrappers.  Each
wrapper counts its launches in a plain integer attribute, ``launches``.

The differentiable entry points are ``layer_norm.layer_norm``,
``softmax_xent.softmax_xent`` and ``flash_attention.flash_attention`` in
the submodules."""

from horovod_tpu_torch.ops.cuda.flash_attention import (  # noqa: F401
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
)
from horovod_tpu_torch.ops.cuda.layer_norm import (  # noqa: F401
    layer_norm_bwd,
    layer_norm_fwd,
)
from horovod_tpu_torch.ops.cuda.softmax_xent import (  # noqa: F401
    softmax_xent_bwd,
    softmax_xent_fwd,
)

KERNEL_WRAPPERS = (layer_norm_fwd, layer_norm_bwd, softmax_xent_fwd,
                   softmax_xent_bwd, flash_attention_fwd,
                   flash_attention_bwd_dq, flash_attention_bwd_dkv)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
