"""MobileNet V1 and V2 (``paddle_tpu/models/mobilenet.py``, PaddleCV's
classification zoo): depthwise stages as grouped convs (``groups = C``),
relu (V1) and relu6 (V2). V1's ``features(x, endpoints=)`` feeds the
detectors (SSD, YOLOv3, Faster R-CNN)."""

from __future__ import annotations

from torch import nn

from paddle_tpu_torch.models.common import ZooModel, classification_loss
from paddle_tpu_torch.models.resnet import ConvBNLayer
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import Linear

__all__ = ["MobileNetV1", "MobileNetV2"]


class _DepthwiseSeparable(nn.Module):
    """3x3 depthwise then 1x1 pointwise, each conv-BN-relu."""

    def __init__(self, in_ch, out_ch, stride=1):
        super().__init__()
        self.dw = ConvBNLayer(in_ch, in_ch, 3, stride=stride, groups=in_ch,
                              act="relu")
        self.pw = ConvBNLayer(in_ch, out_ch, 1, act="relu")

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(ZooModel):
    """``scale`` is the width multiplier; ``block_channels`` the output
    width of each block (for the detectors' heads)."""

    CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]

    def __init__(self, num_classes=1000, scale=1.0, in_ch=3, *,
                 device="cuda", seed: int = 0):
        super().__init__()

        def c(ch):
            return max(8, int(ch * scale))

        self.stem = ConvBNLayer(in_ch, c(32), 3, stride=2, act="relu")
        blocks = []
        prev = c(32)
        self.block_channels = []
        for out, stride in self.CFG:
            blocks.append(_DepthwiseSeparable(prev, c(out), stride))
            prev = c(out)
            self.block_channels.append(prev)
        self.blocks = nn.ModuleList(blocks)
        self.out_ch = prev
        self.fc = Linear(prev, num_classes,
                         weight_init=I.msra_uniform(fan_in=prev),
                         sharding=None)
        self._finish(device, seed)

    def features(self, x, *, endpoints=()):
        """The conv trunk: ``(final, {block index: feature})``."""
        x = self.stem(x)
        feats = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in endpoints:
                feats[i] = x
        return x, feats

    def forward(self, x):
        x, _ = self.features(x)
        return self.fc(x.mean(dim=(1, 2)))

    def loss(self, image, label):
        return classification_loss(self.forward(image), label)


class _InvertedResidual(nn.Module):
    """1x1 expand -> 3x3 depthwise -> 1x1 project, residual when the
    shape allows."""

    def __init__(self, in_ch, out_ch, stride, expand):
        super().__init__()
        mid = in_ch * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand = ConvBNLayer(in_ch, mid, 1, act="relu6")
        self.dw = ConvBNLayer(mid, mid, 3, stride=stride, groups=mid,
                              act="relu6")
        self.project = ConvBNLayer(mid, out_ch, 1)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = self.expand(x) if self.has_expand else x
        y = self.project(self.dw(y))
        return x + y if self.residual else y


class MobileNetV2(ZooModel):
    CFG = [  # expand, out, repeats, stride
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, num_classes=1000, scale=1.0, in_ch=3, *,
                 device="cuda", seed: int = 0):
        super().__init__()

        def c(ch):
            return max(8, int(ch * scale))

        self.stem = ConvBNLayer(in_ch, c(32), 3, stride=2, act="relu6")
        blocks = []
        prev = c(32)
        for expand, out, reps, stride in self.CFG:
            for i in range(reps):
                blocks.append(_InvertedResidual(
                    prev, c(out), stride if i == 0 else 1, expand))
                prev = c(out)
        self.blocks = nn.ModuleList(blocks)
        last = max(1280, int(1280 * scale))
        self.head = ConvBNLayer(prev, last, 1, act="relu6")
        self.out_ch = last
        self.fc = Linear(last, num_classes,
                         weight_init=I.msra_uniform(fan_in=last),
                         sharding=None)
        self._finish(device, seed)

    def forward(self, x):
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        return self.fc(self.head(x).mean(dim=(1, 2)))

    def loss(self, image, label):
        return classification_loss(self.forward(image), label)
