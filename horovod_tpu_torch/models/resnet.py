"""ResNet v1.5 family (port of ``horovod_tpu/models/resnet.py``).

NHWC input as in the reference (viewed as NCHW, channels-last in
memory), ``dtype`` compute (bf16 by default) with fp32 parameters and
batch statistics, flax's module names (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>.Conv_<j>``, ``.BatchNorm_<j>``, ``conv_proj``,
``norm_proj``, ``Dense_0``) so that ``models.params_from_flax`` carries
a JAX tree across.  ``model.train()`` / ``model.eval()`` take the place
of flax's ``train`` argument: in training the BatchNorm layers normalize
with the batch's statistics and update their running ones.
"""

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import BatchNorm, Conv, Dense, max_pool


class ResNetBlock(nn.Module):
    """Basic two-conv residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, c_in, filters, strides, dtype, generator):
        super().__init__()
        conv = partial(Conv, use_bias=False, dtype=dtype,
                       generator=generator)
        self.Conv_0 = conv(c_in, filters, (3, 3), strides)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        self.project = c_in != filters or tuple(strides) != (1, 1)
        if self.project:
            self.conv_proj = conv(c_in, filters, (1, 1), strides)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50/101/152), v1.5: the stride
    is on the 3x3 conv."""

    expansion = 4

    def __init__(self, c_in, filters, strides, dtype, generator):
        super().__init__()
        conv = partial(Conv, use_bias=False, dtype=dtype,
                       generator=generator)
        out = filters * 4
        self.Conv_0 = conv(c_in, filters, (1, 1))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = conv(filters, out, (1, 1))
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        self.project = c_in != out or tuple(strides) != (1, 1)
        if self.project:
            self.conv_proj = conv(c_in, out, (1, 1), strides)
            self.norm_proj = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Images ``[N, H, W, 3]`` -> fp32 logits ``[N, num_classes]``.

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and moved to ``device``: the card unless ``device="cpu"``."""

    def __init__(self, stage_sizes, block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, device=None, seed=0):
        super().__init__()
        from horovod_tpu_torch.common.basics import resolve_device

        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, (7, 7), (2, 2),
                              use_bias=False, dtype=dtype, generator=gen)
        self.bn_init = BatchNorm(num_filters)
        self.blocks = []
        c_in = num_filters
        for stage, count in enumerate(stage_sizes):
            filters = num_filters * 2 ** stage
            for block in range(count):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                name = f"{block_cls.__name__}_{len(self.blocks)}"
                self.add_module(name, block_cls(c_in, filters, strides,
                                                dtype, gen))
                self.blocks.append(name)
                c_in = filters * block_cls.expansion
        self.Dense_0 = Dense(c_in, num_classes, torch.float32, gen)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)
