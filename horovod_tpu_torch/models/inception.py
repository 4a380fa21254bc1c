"""Inception V3 (port of ``horovod_tpu/models/inception.py``): the
mixed 35/17/8 blocks with factorized convolutions, without the auxiliary
head, every conv followed by a BatchNorm (eps 1e-3) and ReLU.

NHWC input viewed as NCHW (channels-last in memory), ``dtype`` compute
with fp32 parameters and batch statistics, flax's names (``ConvBN_<i>``
with ``Conv_0`` and ``BatchNorm_0`` inside, ``MixedA_<i>``, ...,
``Dense_0``).  "SAME" and "VALID" padding as flax pads them; the 3x3
average pools count the padding, as flax's ``avg_pool`` does.  Input
299x299x3 for the published model.
"""

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                             Dropout, avg_pool, max_pool)


class ConvBN(nn.Module):
    def __init__(self, c_in, features, kernel, strides=(1, 1),
                 padding="SAME", dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.Conv_0 = Conv(c_in, features, kernel, strides, padding,
                           use_bias=False, dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Block(nn.Module):
    """A block's ``ConvBN_<i>``, numbered in the order they are made."""

    def __init__(self, dtype, generator):
        super().__init__()
        self._conv = partial(ConvBN, dtype=dtype, generator=generator)
        self._n = 0

    def conv(self, *args, **kwargs):
        name = f"ConvBN_{self._n}"
        self.add_module(name, self._conv(*args, **kwargs))
        self._n += 1
        return getattr(self, name)


class MixedA(_Block):  # 35x35 blocks
    def __init__(self, c_in, pool_features, dtype, generator):
        super().__init__(dtype, generator)
        self.b1 = [self.conv(c_in, 64, (1, 1))]
        self.b5 = [self.conv(c_in, 48, (1, 1)), self.conv(48, 64, (5, 5))]
        self.b3 = [self.conv(c_in, 64, (1, 1)), self.conv(64, 96, (3, 3)),
                   self.conv(96, 96, (3, 3))]
        self.bp = [self.conv(c_in, pool_features, (1, 1))]
        self.features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        bp = _chain(self.bp, avg_pool(x, (3, 3), (1, 1), "SAME"))
        return torch.cat([_chain(self.b1, x), _chain(self.b5, x),
                          _chain(self.b3, x), bp], dim=1)


class ReductionA(_Block):  # 35 -> 17
    def __init__(self, c_in, dtype, generator):
        super().__init__(dtype, generator)
        self.b3 = [self.conv(c_in, 384, (3, 3), (2, 2), "VALID")]
        self.bd = [self.conv(c_in, 64, (1, 1)), self.conv(64, 96, (3, 3)),
                   self.conv(96, 96, (3, 3), (2, 2), "VALID")]
        self.features = 384 + 96 + c_in

    def forward(self, x):
        bp = max_pool(x, (3, 3), (2, 2), "VALID")
        return torch.cat([_chain(self.b3, x), _chain(self.bd, x), bp], dim=1)


class MixedB(_Block):  # 17x17 blocks, factorized 7x7
    def __init__(self, c_in, channels_7x7, dtype, generator):
        super().__init__(dtype, generator)
        c = channels_7x7
        self.b1 = [self.conv(c_in, 192, (1, 1))]
        self.b7 = [self.conv(c_in, c, (1, 1)), self.conv(c, c, (1, 7)),
                   self.conv(c, 192, (7, 1))]
        self.bd = [self.conv(c_in, c, (1, 1)), self.conv(c, c, (7, 1)),
                   self.conv(c, c, (1, 7)), self.conv(c, c, (7, 1)),
                   self.conv(c, 192, (1, 7))]
        self.bp = [self.conv(c_in, 192, (1, 1))]
        self.features = 4 * 192

    def forward(self, x):
        bp = _chain(self.bp, avg_pool(x, (3, 3), (1, 1), "SAME"))
        return torch.cat([_chain(self.b1, x), _chain(self.b7, x),
                          _chain(self.bd, x), bp], dim=1)


class ReductionB(_Block):  # 17 -> 8
    def __init__(self, c_in, dtype, generator):
        super().__init__(dtype, generator)
        self.b3 = [self.conv(c_in, 192, (1, 1)),
                   self.conv(192, 320, (3, 3), (2, 2), "VALID")]
        self.b7 = [self.conv(c_in, 192, (1, 1)), self.conv(192, 192, (1, 7)),
                   self.conv(192, 192, (7, 1)),
                   self.conv(192, 192, (3, 3), (2, 2), "VALID")]
        self.features = 320 + 192 + c_in

    def forward(self, x):
        bp = max_pool(x, (3, 3), (2, 2), "VALID")
        return torch.cat([_chain(self.b3, x), _chain(self.b7, x), bp], dim=1)


class MixedC(_Block):  # 8x8 blocks, expanded filter bank
    def __init__(self, c_in, dtype, generator):
        super().__init__(dtype, generator)
        # lists, so that each conv is registered once, as ConvBN_<i>
        self.b1 = [self.conv(c_in, 320, (1, 1))]
        self.b3 = [self.conv(c_in, 384, (1, 1))]
        self.b3ab = [self.conv(384, 384, (1, 3)), self.conv(384, 384, (3, 1))]
        self.bd = [self.conv(c_in, 448, (1, 1)), self.conv(448, 384, (3, 3))]
        self.bdab = [self.conv(384, 384, (1, 3)), self.conv(384, 384, (3, 1))]
        self.bp = [self.conv(c_in, 192, (1, 1))]
        self.features = 320 + 4 * 384 + 192

    def forward(self, x):
        b3 = _chain(self.b3, x)
        bd = _chain(self.bd, x)
        bp = _chain(self.bp, avg_pool(x, (3, 3), (1, 1), "SAME"))
        return torch.cat([_chain(self.b1, x)] + [c(b3) for c in self.b3ab]
                         + [c(bd) for c in self.bdab] + [bp], dim=1)


def _chain(convs, x):
    for conv in convs:
        x = conv(x)
    return x


class InceptionV3(nn.Module):
    """Images ``[N, H, W, 3]`` -> fp32 logits ``[N, num_classes]``.
    Parameters are drawn on the CPU from ``seed`` and moved to ``device``
    (the card unless ``device="cpu"``); dropout draws from a generator on
    ``device`` seeded with ``seed``."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 dropout_rate=0.5, device=None, seed=0):
        super().__init__()
        from horovod_tpu_torch.common.basics import resolve_device

        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        stem = _Block(dtype, gen)
        # stem: 299 -> 35
        self.stem = [stem.conv(3, 32, (3, 3), (2, 2), "VALID"),
                     stem.conv(32, 32, (3, 3), padding="VALID"),
                     stem.conv(32, 64, (3, 3))]
        self.stem2 = [stem.conv(64, 80, (1, 1), padding="VALID"),
                      stem.conv(80, 192, (3, 3), padding="VALID")]
        for i in range(stem._n):   # flax names the stem's at the top
            self.add_module(f"ConvBN_{i}", getattr(stem, f"ConvBN_{i}"))
        c, self.body, made = 192, [], {}
        for kind, *args in [(MixedA, 32), (MixedA, 64), (MixedA, 64),
                            (ReductionA,), (MixedB, 128), (MixedB, 160),
                            (MixedB, 160), (MixedB, 192), (ReductionB,),
                            (MixedC,), (MixedC,)]:
            block = kind(c, *args, dtype, gen)
            i = made[kind] = made.get(kind, -1) + 1
            self.body.append(f"{kind.__name__}_{i}")
            self.add_module(self.body[-1], block)
            c = block.features
        self.Dropout_0 = Dropout(dropout_rate, torch.Generator(
            device=device).manual_seed(seed))
        self.Dense_0 = Dense(c, num_classes, torch.float32, gen)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = max_pool(_chain(self.stem, x), (3, 3), (2, 2), "VALID")
        x = max_pool(_chain(self.stem2, x), (3, 3), (2, 2), "VALID")
        for name in self.body:
            x = getattr(self, name)(x)
        return self.Dense_0(self.Dropout_0(x.mean(dim=(2, 3))))
