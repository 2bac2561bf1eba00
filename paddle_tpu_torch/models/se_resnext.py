"""SE-ResNeXt-50/101/152 (``paddle_tpu/models/se_resnext.py``, the
reference's distributed-test model ``dist_se_resnext.py`` and PaddleCV's
``se_resnext.py``): grouped-conv bottlenecks with squeeze-and-excitation
channel gating."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel, classification_loss
from paddle_tpu_torch.models.resnet import ConvBNLayer
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import Linear, Pool2D

__all__ = ["SEBlock", "SEBottleneck", "SEResNeXt", "SEResNeXt50"]


class SEBlock(nn.Module):
    """GAP -> fc / ratio -> relu -> fc -> sigmoid, scaling the channels."""

    def __init__(self, ch, ratio=16):
        super().__init__()
        mid = max(ch // ratio, 4)
        self.down = Linear(ch, mid, sharding=None)
        self.up = Linear(mid, ch, sharding=None)

    def forward(self, x):
        s = torch.relu(self.down(x.mean(dim=(1, 2))))
        s = torch.sigmoid(self.up(s))
        return x * s[:, None, None, :]


class SEBottleneck(nn.Module):
    def __init__(self, in_ch, ch, stride=1, cardinality=32, ratio=16,
                 downsample=False):
        super().__init__()
        self.conv0 = ConvBNLayer(in_ch, ch, 1, act="relu")
        self.conv1 = ConvBNLayer(ch, ch, 3, stride=stride,
                                 groups=cardinality, act="relu")
        self.conv2 = ConvBNLayer(ch, ch * 2, 1)
        self.se = SEBlock(ch * 2, ratio=ratio)
        self.has_short = downsample
        if downsample:
            self.short = ConvBNLayer(in_ch, ch * 2, 1, stride=stride)

    def forward(self, x):
        y = self.se(self.conv2(self.conv1(self.conv0(x))))
        return torch.relu(y + (self.short(x) if self.has_short else x))


_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class SEResNeXt(ZooModel):
    """``width`` scales the channels (128 for the 32x4d trunk);
    ``cardinality`` is the group count."""

    def __init__(self, depth=50, num_classes=1000, width=128, cardinality=32,
                 ratio=16, in_ch=3, *, device="cuda", seed: int = 0):
        super().__init__()
        if depth not in _DEPTHS:
            raise ValueError(f"depth must be one of {sorted(_DEPTHS)}")
        stem_ch = width // 2
        self.stem = ConvBNLayer(in_ch, stem_ch, 7, stride=2, act="relu")
        self.pool = Pool2D(3, stride=2, padding=1, pool_type="max")
        blocks = []
        ch_in = stem_ch
        for stage, n in enumerate(_DEPTHS[depth]):
            ch = width * (2 ** stage)
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                downsample = i == 0 and (stride != 1 or ch_in != ch * 2)
                blocks.append(SEBottleneck(
                    ch_in, ch, stride=stride, cardinality=cardinality,
                    ratio=ratio, downsample=downsample))
                ch_in = ch * 2
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(ch_in, num_classes,
                         weight_init=I.msra_uniform(fan_in=ch_in),
                         sharding=None)
        self._finish(device, seed)

    def forward(self, x):
        x = self.pool(self.stem(x))
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean(dim=(1, 2)))

    def loss(self, image, label):
        return classification_loss(self.forward(image), label)


def SEResNeXt50(num_classes=1000, **kw):
    return SEResNeXt(50, num_classes=num_classes, **kw)
