"""The rest of PaddleCV's classification zoo (``paddle_tpu/models/
legacy_cv.py``): AlexNet, GoogLeNet (Inception v1), ShuffleNetV2,
DarkNet53 (YOLOv3's backbone), SqueezeNet 1.1 and DenseNet-121, NHWC.
Dropout draws from an explicit ``torch.Generator`` and is off without
one."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel, classification_loss
from paddle_tpu_torch.models.resnet import ConvBNLayer
from paddle_tpu_torch.nn.layers import Conv2D, Linear, Pool2D, dropout
from paddle_tpu_torch.ops import nn as F

__all__ = ["AlexNet", "GoogLeNet", "ShuffleNetV2", "DarkNet53",
           "SqueezeNet", "DenseNet121", "channel_shuffle"]


def _drop(x, rate, training, generator):
    return dropout(x, rate, training=training and generator is not None,
                   generator=generator)


class _Classifier(ZooModel):
    def loss(self, image, label, generator: Optional[torch.Generator] = None):
        return classification_loss(self.forward(image, generator), label)


class AlexNet(_Classifier):
    """5 convs (plain conv + relu, no LRN) and 3 fully connected layers."""

    def __init__(self, num_classes=1000, in_ch=3, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.conv1 = Conv2D(in_ch, 64, 11, stride=4, padding=2)
        self.conv2 = Conv2D(64, 192, 5, padding=2)
        self.conv3 = Conv2D(192, 384, 3, padding=1)
        self.conv4 = Conv2D(384, 256, 3, padding=1)
        self.conv5 = Conv2D(256, 256, 3, padding=1)
        self.pool = Pool2D(3, stride=2, pool_type="max")
        self.fc1 = Linear(256 * 6 * 6, 4096, sharding=None)
        self.fc2 = Linear(4096, 4096, sharding=None)
        self.fc3 = Linear(4096, num_classes, sharding=None)
        self._finish(device, seed)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for conv in (self.conv1, self.conv2):
            x = self.pool(torch.relu(conv(x)))
        for conv in (self.conv3, self.conv4, self.conv5):
            x = torch.relu(conv(x))
        x = self.pool(x)
        # the canonical head's 6 x 6 (no-op at 224 pixels): average pooling
        # where it divides, else ``jax.image.resize``'s linear resample
        if tuple(x.shape[1:3]) != (6, 6):
            if x.shape[1] % 6 == 0 and x.shape[2] % 6 == 0:
                x = F.adaptive_pool2d(x, 6, pool_type="avg")
            else:
                x = F.interpolate(x, (6, 6), method="linear")
        x = x.reshape(x.shape[0], -1)
        x = _drop(torch.relu(self.fc1(x)), 0.5, self.training, generator)
        x = _drop(torch.relu(self.fc2(x)), 0.5, self.training, generator)
        return self.fc3(x)


class _Inception(nn.Module):
    """1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1, concatenated."""

    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, cp):
        super().__init__()
        self.b1 = ConvBNLayer(in_ch, c1, 1, act="relu")
        self.b3r = ConvBNLayer(in_ch, c3r, 1, act="relu")
        self.b3 = ConvBNLayer(c3r, c3, 3, act="relu")
        self.b5r = ConvBNLayer(in_ch, c5r, 1, act="relu")
        self.b5 = ConvBNLayer(c5r, c5, 5, act="relu")
        self.bp = ConvBNLayer(in_ch, cp, 1, act="relu")
        self.pool = Pool2D(3, stride=1, padding=1, pool_type="max")
        self.out_ch = c1 + c3 + c5 + cp

    def forward(self, x):
        return torch.cat([self.b1(x), self.b3(self.b3r(x)),
                          self.b5(self.b5r(x)), self.bp(self.pool(x))], -1)


class GoogLeNet(_Classifier):
    """Inception v1 without the auxiliary heads."""

    CFG = [  # (c1, c3r, c3, c5r, c5, cp)
        (64, 96, 128, 16, 32, 32),      # 3a
        (128, 128, 192, 32, 96, 64),    # 3b
        (192, 96, 208, 16, 48, 64),     # 4a
        (160, 112, 224, 24, 64, 64),    # 4b
        (128, 128, 256, 24, 64, 64),    # 4c
        (112, 144, 288, 32, 64, 64),    # 4d
        (256, 160, 320, 32, 128, 128),  # 4e
        (256, 160, 320, 32, 128, 128),  # 5a
        (384, 192, 384, 48, 128, 128),  # 5b
    ]
    POOL_AFTER = {1, 6}                 # max pool after 3b and 4e

    def __init__(self, num_classes=1000, in_ch=3, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.stem1 = ConvBNLayer(in_ch, 64, 7, stride=2, act="relu")
        self.stem2 = ConvBNLayer(64, 64, 1, act="relu")
        self.stem3 = ConvBNLayer(64, 192, 3, act="relu")
        self.pool = Pool2D(3, stride=2, padding=1, pool_type="max")
        blocks = []
        ch = 192
        for cfg in self.CFG:
            blk = _Inception(ch, *cfg)
            blocks.append(blk)
            ch = blk.out_ch
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(ch, num_classes, sharding=None)
        self._finish(device, seed)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.pool(self.stem1(x))
        x = self.pool(self.stem3(self.stem2(x)))
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.POOL_AFTER:
                x = self.pool(x)
        x = _drop(x.mean(dim=(1, 2)), 0.4, self.training, generator)
        return self.fc(x)


def channel_shuffle(x, groups: int):
    """(B, H, W, C) channel shuffle (``shuffle_channel_op``): interleave
    the groups' channels."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, groups, c // groups)
    return x.transpose(3, 4).reshape(b, h, w, c)


class _ShuffleUnit(nn.Module):
    """Split-transform-concat-shuffle (stride 1) or the two-branch
    downsample (stride 2)."""

    def __init__(self, in_ch, out_ch, stride):
        super().__init__()
        self.stride = stride
        half = out_ch // 2
        branch_in = in_ch if stride == 2 else in_ch // 2
        self.r1 = ConvBNLayer(branch_in, half, 1, act="relu")
        self.rd = ConvBNLayer(half, half, 3, stride=stride, groups=half)
        self.r2 = ConvBNLayer(half, half, 1, act="relu")
        if stride == 2:
            self.ld = ConvBNLayer(branch_in, branch_in, 3, stride=2,
                                  groups=branch_in)
            self.l1 = ConvBNLayer(branch_in, half, 1, act="relu")

    def forward(self, x):
        if self.stride == 1:
            left, right = x.chunk(2, dim=-1)
        else:
            left = self.l1(self.ld(x))
            right = x
        right = self.r2(self.rd(self.r1(right)))
        return channel_shuffle(torch.cat([left, right], -1), 2)


class ShuffleNetV2(_Classifier):
    """ShuffleNetV2 1.0x."""

    STAGES = [(4, 116), (8, 232), (4, 464)]

    def __init__(self, num_classes=1000, in_ch=3, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.stem = ConvBNLayer(in_ch, 24, 3, stride=2, act="relu")
        self.pool = Pool2D(3, stride=2, padding=1, pool_type="max")
        units = []
        ch = 24
        for reps, out in self.STAGES:
            units.append(_ShuffleUnit(ch, out, stride=2))
            for _ in range(reps - 1):
                units.append(_ShuffleUnit(out, out, stride=1))
            ch = out
        self.units = nn.ModuleList(units)
        self.tail = ConvBNLayer(ch, 1024, 1, act="relu")
        self.fc = Linear(1024, num_classes, sharding=None)
        self._finish(device, seed)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.pool(self.stem(x))
        for u in self.units:
            x = u(x)
        return self.fc(self.tail(x).mean(dim=(1, 2)))


class _DarkResidual(nn.Module):
    """1x1 squeeze + 3x3 expand (leaky), additive skip."""

    def __init__(self, ch):
        super().__init__()
        self.c1 = ConvBNLayer(ch, ch // 2, 1, act="leaky")
        self.c2 = ConvBNLayer(ch // 2, ch, 3, act="leaky")

    def forward(self, x):
        return x + self.c2(self.c1(x))


class DarkNet53(_Classifier):
    """Conv-BN-leaky trunk of (1, 2, 8, 8, 4) residual stages, with
    MobileNetV1's ``features(x, endpoints=)`` / ``block_channels``
    contract; the stride-8/16/32 endpoints are blocks 13, 22 and 27."""

    STAGE_REPS = (1, 2, 8, 8, 4)

    def __init__(self, num_classes=1000, in_ch=3, scale=1.0, *,
                 device="cuda", seed: int = 0):
        super().__init__()

        def c(n):
            return max(8, int(n * scale))

        self.stem = ConvBNLayer(in_ch, c(32), 3, act="leaky")
        blocks, widths = [], []
        ch = c(32)
        for i, reps in enumerate(self.STAGE_REPS):
            out = c(64 * (2 ** i))
            blocks.append(ConvBNLayer(ch, out, 3, stride=2, act="leaky"))
            widths.append(out)
            for _ in range(reps):
                blocks.append(_DarkResidual(out))
                widths.append(out)
            ch = out
        self.blocks = nn.ModuleList(blocks)
        self.block_channels = widths
        self.fc = Linear(ch, num_classes, sharding=None)
        self._finish(device, seed)

    def features(self, x, *, endpoints=()):
        """The trunk: ``(final, {block index: feature})``."""
        x = self.stem(x)
        feats = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in endpoints:
                feats[i] = x
        return x, feats

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x, _ = self.features(x)
        return self.fc(x.mean(dim=(1, 2)))


class _Fire(nn.Module):
    """1x1 squeeze -> parallel 1x1 and 3x3 expands, concatenated."""

    def __init__(self, in_ch, s1, e1, e3):
        super().__init__()
        self.squeeze = Conv2D(in_ch, s1, 1)
        self.e1 = Conv2D(s1, e1, 1)
        self.e3 = Conv2D(s1, e3, 3, padding=1)
        self.out_ch = e1 + e3

    def forward(self, x):
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.e1(s)), torch.relu(self.e3(s))], -1)


class SqueezeNet(_Classifier):
    """SqueezeNet 1.1: conv stem, 8 fire modules, a per-class 1x1 conv
    head and global average pooling."""

    CFG = [(16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
           (48, 192, 192), (48, 192, 192), (64, 256, 256),
           (64, 256, 256)]
    POOL_AFTER = {1, 3}

    def __init__(self, num_classes=1000, in_ch=3, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.stem = Conv2D(in_ch, 64, 3, stride=2, padding=1)
        self.pool = Pool2D(3, stride=2, padding=1, pool_type="max")
        fires = []
        ch = 64
        for cfg in self.CFG:
            f = _Fire(ch, *cfg)
            fires.append(f)
            ch = f.out_ch
        self.fires = nn.ModuleList(fires)
        self.head = Conv2D(ch, num_classes, 1)
        self._finish(device, seed)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.pool(torch.relu(self.stem(x)))
        for i, f in enumerate(self.fires):
            x = f(x)
            if i in self.POOL_AFTER:
                x = self.pool(x)
        x = _drop(x, 0.5, self.training, generator)
        return torch.relu(self.head(x)).mean(dim=(1, 2))


class _DenseBlock(nn.Module):
    """``reps`` bottleneck pairs (1x1 then 3x3 conv-BN-relu), each over
    the concatenation of every earlier feature (post-activation
    ConvBNLayers, as the reference's)."""

    def __init__(self, in_ch, growth, reps):
        super().__init__()
        layers = []
        ch = in_ch
        for _ in range(reps):
            layers.append(nn.ModuleList([
                ConvBNLayer(ch, 4 * growth, 1, act="relu"),
                ConvBNLayer(4 * growth, growth, 3, act="relu")]))
            ch += growth
        self.layers = nn.ModuleList(layers)
        self.out_ch = ch

    def forward(self, x):
        for pair in self.layers:
            x = torch.cat([x, pair[1](pair[0](x))], -1)
        return x


class DenseNet121(_Classifier):
    """DenseNet-121: growth 32, blocks 6/12/24/16, 0.5x transitions."""

    BLOCKS = (6, 12, 24, 16)

    def __init__(self, num_classes=1000, in_ch=3, growth=32, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.stem = ConvBNLayer(in_ch, 2 * growth, 7, stride=2, act="relu")
        self.pool = Pool2D(3, stride=2, padding=1, pool_type="max")
        self.avg = Pool2D(2, stride=2, pool_type="avg")
        blocks, trans = [], []
        ch = 2 * growth
        for i, reps in enumerate(self.BLOCKS):
            blk = _DenseBlock(ch, growth, reps)
            blocks.append(blk)
            ch = blk.out_ch
            if i < len(self.BLOCKS) - 1:
                trans.append(ConvBNLayer(ch, ch // 2, 1, act="relu"))
                ch //= 2
        self.blocks = nn.ModuleList(blocks)
        self.trans = nn.ModuleList(trans)
        self.fc = Linear(ch, num_classes, sharding=None)
        self._finish(device, seed)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.pool(self.stem(x))
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i < len(self.trans):
                x = self.avg(self.trans[i](x))
        return self.fc(x.mean(dim=(1, 2)))
