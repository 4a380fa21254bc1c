"""flax's CNN layers in PyTorch: ``Conv``, ``BatchNorm``, ``Dense``,
``Dropout`` and the pools, with flax's parameter names, padding,
statistics and dtypes, for the port of ``horovod_tpu/models/{resnet,vgg,
inception,mlp}.py``.

Tensors are NCHW, laid out channels-last in memory (the models take NHWC
input, as the reference does, and view it as NCHW), so that cuDNN runs
its NHWC kernels.  Parameters are fp32 and drawn on the CPU from the
caller's ``torch.Generator``; ``Conv`` and ``Dense`` compute in their
``dtype``.

- **Padding.** flax's "SAME" pads ``(total // 2, total - total // 2)``,
  which is asymmetric at stride 2 ((0, 1) for a 3x3/2 on 112 rows, (2,
  3) for the 7x7/2 stem on 224); torch's ``padding=k // 2`` pads (1, 1)
  and (3, 3) and shifts every window.  :func:`same_pads` computes flax's
  pads from the shape; a symmetric pair goes to the op's own ``padding``,
  an asymmetric one through ``F.pad`` (-inf for max pooling).
- **BatchNorm.** flax computes the batch statistics in fp32 with the
  *biased* variance (``E[x^2] - E[x]^2`` clipped at 0) and puts that
  variance into the running average ``m * ra + (1 - m) * batch``
  (``flax.linen.normalization._compute_stats``, flax 0.12.3).
  ``nn.BatchNorm2d`` puts in the unbiased variance, and its momentum is
  ``1 - m``.  The port normalizes with ``native_batch_norm`` (one
  statistics pass, fp32 accumulation) and takes the running update from
  the statistics it returns.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size, window, stride, padding):
    """flax's (low, high) padding of one spatial dim of ``size``:
    ``"VALID"`` pads nothing; ``"SAME"`` pads to ``ceil(size / stride)``
    outputs, the smaller half first (``lax.padtype_to_pads``)."""
    if padding == "VALID":
        return 0, 0
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad(x, window, stride, padding, value=0.0):
    """-> (x padded where flax's pads are asymmetric, the symmetric
    padding left for the op)."""
    ph = same_pads(x.shape[2], window[0], stride[0], padding)
    pw = same_pads(x.shape[3], window[1], stride[1], padding)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def lecun_normal(shape, fan_in, generator):
    """flax's default kernel init: a normal truncated at two standard
    deviations, of variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std,
                                 b=2 * std, generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv``: ``kernel`` fp32 OIHW (flax's HWIO transposed,
    see ``models.params_from_flax``), ``bias`` when ``use_bias``; input
    and kernel cast to ``dtype``."""

    def __init__(self, c_in, features, kernel, strides=(1, 1),
                 padding="SAME", use_bias=True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.window, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.kernel = nn.Parameter(lecun_normal(
            (features, c_in) + self.window,
            c_in * math.prod(self.window), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x):
        x, pad = _pad(x.to(self.dtype), self.window, self.strides,
                      self.padding)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias, self.strides,
                        pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon)`` over dim 1: ``scale``,
    ``bias`` (fp32 parameters) and the running ``mean`` and ``var``
    (fp32 buffers, flax's ``batch_stats``).  ``zero_scale``: the scale
    starts at 0 (the last norm of a residual block).

    In training the batch's statistics (fp32 or wider, the biased
    variance) normalize and, without gradient, update the running ones as
    flax does (the module docstring); in eval the running ones normalize.
    The output has the input's dtype, the layer's compute dtype in these
    models, as flax's ``dtype`` gives it."""

    def __init__(self, features, momentum=0.9, eps=1e-5, zero_scale=False):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.zeros(features) if zero_scale
                                  else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            y, mean, invstd = torch.native_batch_norm(
                x, self.scale, self.bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                # the biased variance the normalization used, from its
                # 1 / sqrt(var + eps), in float64 so that no rounding of
                # this step shows in the fp32 buffer
                var = (invstd.double().reciprocal().square()
                       - self.eps).clamp_(min=0.0)
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
            return y
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            training=False, eps=self.eps)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` fp32 ``(in, out)``, ``bias``;
    ``x @ kernel + bias`` in ``dtype``."""

    def __init__(self, d_in, features, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal((d_in, features), d_in,
                                                generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(),
                        self.bias.to(self.dtype))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, each entry is kept with
    probability ``1 - rate`` and divided by it; the mask is drawn from
    ``generator`` (on the input's device).  Identity in eval."""

    def __init__(self, rate, generator):
        super().__init__()
        self.rate, self.generator = rate, generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def max_pool(x, window, strides, padding="VALID"):
    """flax ``nn.max_pool``: padded entries are -inf."""
    x, pad = _pad(x, window, strides, padding, value=float("-inf"))
    return F.max_pool2d(x, window, strides, pad)


def avg_pool(x, window, strides, padding="VALID"):
    """flax ``nn.avg_pool`` (``count_include_pad=True``): padded entries
    are zeros and count in the mean."""
    x, pad = _pad(x, window, strides, padding)
    return F.avg_pool2d(x, window, strides, pad, count_include_pad=True)
