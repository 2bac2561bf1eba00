"""ResNet-18/34/50/101/152 (``paddle_tpu/models/resnet.py``, PaddleCV's
image-classification ResNet): NHWC images, conv + BatchNorm blocks whose
running statistics move through the train step's state tape, and the
space-to-depth stem.

The reference's conv weights are HWIO; :class:`~paddle_tpu_torch.nn.
layers.Conv2D` and :class:`S2DStemConv` hold OIHW and ``from_jax``
transposes (``jax_layouts``). Models are :class:`~paddle_tpu_torch.
models.common.ZooModel`: built from ``seed`` on the CPU, moved to
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.models.common import ZooModel, classification_loss
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import BatchNorm, Conv2D, Linear, Pool2D

__all__ = ["ConvBNLayer", "BottleneckBlock", "BasicBlock", "ResNet",
           "ResNet50", "S2DStem", "S2DStemConv", "space_to_depth",
           "stem_weights_to_s2d"]


def activation(x, act: Optional[str]):
    """The zoo's activations by name: relu, relu6, leaky (slope 0.1, the
    darknet convention) or None."""
    if act == "relu":
        return torch.relu(x)
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    if act is None:
        return x
    raise ValueError(f"unknown activation {act!r}")


class ConvBNLayer(nn.Module):
    """Conv (no bias, ``(k - 1) // 2`` padding) -> BatchNorm -> act."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, act=None):
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=(kernel - 1) // 2, groups=groups,
                           bias=False)
        self.bn = BatchNorm(out_ch)
        self.act = act

    def forward(self, x):
        return activation(self.bn(self.conv(x)), self.act)


def space_to_depth(x, block: int = 2):
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C); channel order (r, s, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               block * block * c)


class S2DStemConv(nn.Module):
    """The 7x7 / stride-2 stem conv as a 4x4 / stride-1 conv over the 2x2
    space-to-depth blocks (the same function; padding ``((2, 1), (2,
    1))``). The weight is held blocked, OIHW ``(out, 4 * in, 4, 4)``;
    :func:`stem_weights_to_s2d` converts a 7x7 one."""

    jax_layouts = {"weight": "HWIO"}

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.in_ch = in_ch
        self.weight = nn.Parameter(torch.empty(out_ch, 4 * in_ch, 4, 4))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        # the fan-in of the 7x7 conv it replaces (49 taps)
        I.msra_normal(fan_in=self.in_ch * 49)(self.weight, generator)

    def forward(self, x):
        xb = space_to_depth(x, 2).permute(0, 3, 1, 2)
        xb = F.pad(xb, (2, 1, 2, 1))
        out = F.conv2d(xb, self.weight.to(xb.dtype))
        return out.permute(0, 2, 3, 1)


def stem_weights_to_s2d(w7):
    """OIHW ``(O, C, 7, 7)`` stem weights -> the blocked ``(O, 4C, 4, 4)``
    computing the same function (pixel ``(2a + r, 2b + s)`` lives in
    blocked channel ``(2r + s) * C + c``; kernel tap ``i = 2 * ka + r -
    1``)."""
    o, c, k, k2 = w7.shape
    if (k, k2) != (7, 7):
        raise ValueError(f"expected 7x7 stem weights, got {tuple(w7.shape)}")
    wb = w7.new_zeros((o, 4 * c, 4, 4))
    for ka in range(4):
        for r in range(2):
            i = 2 * ka + r - 1
            if not 0 <= i <= 6:
                continue
            for kb in range(4):
                for s in range(2):
                    j = 2 * kb + s - 1
                    if not 0 <= j <= 6:
                        continue
                    sl = (r * 2 + s) * c
                    wb[:, sl:sl + c, ka, kb] = w7[:, :, i, j]
    return wb


class S2DStem(nn.Module):
    """``{conv, bn}`` like the 7x7 stem's ConvBNLayer (only the conv
    weight's shape differs), then relu."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = S2DStemConv(in_ch, out_ch)
        self.bn = BatchNorm(out_ch)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch, ch, stride=1, downsample=False):
        super().__init__()
        self.conv0 = ConvBNLayer(in_ch, ch, 1, act="relu")
        self.conv1 = ConvBNLayer(ch, ch, 3, stride=stride, act="relu")
        self.conv2 = ConvBNLayer(ch, ch * 4, 1)
        self.has_short = downsample
        if downsample:
            self.short = ConvBNLayer(in_ch, ch * 4, 1, stride=stride)

    def forward(self, x):
        y = self.conv2(self.conv1(self.conv0(x)))
        return torch.relu(y + (self.short(x) if self.has_short else x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, ch, stride=1, downsample=False):
        super().__init__()
        self.conv0 = ConvBNLayer(in_ch, ch, 3, stride=stride, act="relu")
        self.conv1 = ConvBNLayer(ch, ch, 3)
        self.has_short = downsample
        if downsample:
            self.short = ConvBNLayer(in_ch, ch, 1, stride=stride)

    def forward(self, x):
        y = self.conv1(self.conv0(x))
        return torch.relu(y + (self.short(x) if self.has_short else x))


_DEPTHS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (BottleneckBlock, (3, 4, 6, 3)),
    101: (BottleneckBlock, (3, 4, 23, 3)),
    152: (BottleneckBlock, (3, 8, 36, 3)),
}


class ResNet(ZooModel):
    """NHWC ResNet; ``width`` scales the channels (64 standard)."""

    def __init__(self, depth=50, num_classes=1000, width=64, in_ch=3,
                 stem="conv7", *, device="cuda", seed: int = 0):
        super().__init__()
        if depth not in _DEPTHS:
            raise ValueError(f"depth must be one of {sorted(_DEPTHS)}")
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"stem must be 'conv7' or 's2d', got {stem!r}")
        block_cls, counts = _DEPTHS[depth]
        self.stem = (S2DStem(in_ch, width) if stem == "s2d" else
                     ConvBNLayer(in_ch, width, 7, stride=2, act="relu"))
        self.pool = Pool2D(3, stride=2, padding=1, pool_type="max")
        blocks = []
        ch_in = width
        for stage, n in enumerate(counts):
            ch = width * (2 ** stage)
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                downsample = (i == 0 and (
                    stride != 1 or ch_in != ch * block_cls.expansion))
                blocks.append(block_cls(ch_in, ch, stride=stride,
                                        downsample=downsample))
                ch_in = ch * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(ch_in, num_classes,
                         weight_init=I.msra_uniform(fan_in=ch_in),
                         sharding=None)
        self._finish(device, seed)

    def forward(self, x):
        """x (B, H, W, C) -> (B, num_classes) logits."""
        x = self.pool(self.stem(x))
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean(dim=(1, 2)))

    def loss(self, image, label):
        return classification_loss(self.forward(image), label)


def ResNet50(num_classes=1000, **kw):
    return ResNet(50, num_classes=num_classes, **kw)
