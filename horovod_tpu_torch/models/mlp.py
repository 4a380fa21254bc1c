"""Small MLP (port of ``horovod_tpu/models/mlp.py``): flatten, then
``Dense_<i>`` layers in fp32 with ReLU between them."""

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Dense


class MLP(nn.Module):
    """``[N, ...]`` -> ``[N, features[-1]]``; ``in_features`` is the
    flattened input's width (flax infers it at ``init``)."""

    def __init__(self, in_features, features=(128, 64, 10), device=None,
                 seed=0):
        super().__init__()
        from horovod_tpu_torch.common.basics import resolve_device

        gen = torch.Generator().manual_seed(seed)
        self.n = len(features)
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", Dense(in_features, f, torch.float32,
                                              gen))
            in_features = f
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x
