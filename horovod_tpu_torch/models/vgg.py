"""VGG family (port of ``horovod_tpu/models/vgg.py``).

NHWC input viewed as NCHW (channels-last in memory), ``dtype`` compute
with fp32 parameters, flax's names (``Conv_<i>``, ``Dense_<i>``).  The
2x2/2 pools have no padding.  The classifier flattens in NHWC order, as
the reference's ``reshape`` does, so the first ``Dense`` kernel keeps
flax's layout.  Dropout draws its masks from a generator on ``device``
seeded with ``seed``; ``model.train()`` / ``model.eval()`` take the
place of flax's ``train`` argument.
"""

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Conv, Dense, Dropout, max_pool

# Configuration "D" (VGG-16) / "E" (VGG-19): numbers are conv widths,
# "M" is a 2x2 max-pool.
_CFG_16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M")
_CFG_19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(nn.Module):
    """Images ``[N, H, W, 3]`` -> fp32 logits ``[N, num_classes]``; ``H``
    and ``W`` as the model is built for (``image``, 224 by default),
    since the first ``Dense`` takes the flattened last feature map."""

    def __init__(self, cfg, num_classes=1000, dtype=torch.bfloat16,
                 classifier_width=4096, dropout_rate=0.5, image=224,
                 device=None, seed=0):
        super().__init__()
        from horovod_tpu_torch.common.basics import resolve_device

        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg, self.dtype = tuple(cfg), dtype
        c_in, side, convs = 3, image, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                setattr(self, f"Conv_{convs}",
                        Conv(c_in, v, (3, 3), dtype=dtype, generator=gen))
                c_in, convs = v, convs + 1
        d_in = side * side * c_in
        drop = torch.Generator(device=device).manual_seed(seed)
        for i in range(2):
            setattr(self, f"Dense_{i}",
                    Dense(d_in, classifier_width, dtype, gen))
            setattr(self, f"Dropout_{i}", Dropout(dropout_rate, drop))
            d_in = classifier_width
        self.Dense_2 = Dense(d_in, num_classes, torch.float32, gen)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        convs = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool(x, (2, 2), (2, 2))
            else:
                x = F.relu(getattr(self, f"Conv_{convs}")(x))
                convs += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(2):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            x = getattr(self, f"Dropout_{i}")(x)
        return self.Dense_2(x)


VGG16 = partial(VGG, cfg=_CFG_16)
VGG19 = partial(VGG, cfg=_CFG_19)
