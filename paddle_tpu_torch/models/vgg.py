"""VGG-11/13/16/19 (``paddle_tpu/models/vgg.py``, PaddleCV's ``vgg.py``
over ``img_conv_group``): 3x3 conv stages, optional BatchNorm, global
average pooling before three fully connected layers, dropout between
them drawn from an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel, classification_loss
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import (BatchNorm, Conv2D, Linear, Pool2D,
                                        dropout)

__all__ = ["VGG", "VGG16"]

_CFGS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


class _ConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, reps, batch_norm):
        super().__init__()
        convs, bns = [], []
        prev = in_ch
        for _ in range(reps):
            convs.append(Conv2D(prev, out_ch, 3, padding=1,
                                bias=not batch_norm))
            if batch_norm:
                bns.append(BatchNorm(out_ch))
            prev = out_ch
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns) if batch_norm else None
        self.pool = Pool2D(2, stride=2, pool_type="max")

    def forward(self, x):
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.bns is not None:
                x = self.bns[i](x)
            x = torch.relu(x)
        return self.pool(x)


class VGG(ZooModel):
    """``width`` scales the channels (64 standard)."""

    def __init__(self, depth=16, num_classes=1000, width=64, in_ch=3,
                 batch_norm=True, fc_dim=4096, dropout=0.5, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        if depth not in _CFGS:
            raise ValueError(f"depth must be one of {sorted(_CFGS)}")
        blocks = []
        prev = in_ch
        for stage, reps in enumerate(_CFGS[depth]):
            out = width * (2 ** min(stage, 3))
            blocks.append(_ConvBlock(prev, out, reps, batch_norm))
            prev = out
        self.blocks = nn.ModuleList(blocks)
        self.out_ch = prev
        self.fc1 = Linear(prev, fc_dim, sharding=None)
        self.fc2 = Linear(fc_dim, fc_dim, sharding=None)
        self.fc3 = Linear(fc_dim, num_classes,
                          weight_init=I.msra_uniform(fan_in=fc_dim),
                          sharding=None)
        self.dropout = dropout
        self._finish(device, seed)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for block in self.blocks:
            x = block(x)
        x = torch.relu(self.fc1(x.mean(dim=(1, 2))))   # GAP, not 7x7
        drop = self.training and generator is not None and self.dropout > 0
        if drop:
            x = dropout(x, self.dropout, generator=generator)
        x = torch.relu(self.fc2(x))
        if drop:
            x = dropout(x, self.dropout, generator=generator)
        return self.fc3(x)

    def loss(self, image, label, generator: Optional[torch.Generator] = None):
        return classification_loss(self.forward(image, generator), label)


def VGG16(num_classes=1000, **kw):
    return VGG(16, num_classes=num_classes, **kw)
