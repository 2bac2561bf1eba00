"""Video models (``paddle_tpu/models/video.py``, PaddleCV's video zoo):
TSN (a 2-D backbone per segment frame, the segments folded into the
batch, logits averaged) and a C3D-style volumetric convnet over NDHWC
clips (``ops.nn.conv3d`` / ``pool3d``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel, classification_loss
from paddle_tpu_torch.models.mobilenet import MobileNetV1
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import BatchNorm, Linear
from paddle_tpu_torch.ops import nn as ops_nn

__all__ = ["TSN", "C3D"]


class TSN(ZooModel):
    """Temporal Segment Network over MobileNetV1; ``x`` (B, S, H, W, C)."""

    def __init__(self, num_classes=400, num_segments=3, scale=0.25, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.num_segments = num_segments
        self.backbone = MobileNetV1(num_classes=num_classes, scale=scale,
                                    device="cpu")
        self._finish(device, seed)

    def forward(self, x):
        b, s, h, w, c = x.shape
        logits = self.backbone(x.reshape(b * s, h, w, c))
        return logits.reshape(b, s, -1).mean(dim=1)    # segment consensus

    def loss(self, video, label):
        return classification_loss(self.forward(video), label)


class _Conv3DBN(nn.Module):
    """3x3x3 conv (the reference's DHWIO weight, shape-preserving
    padding) -> BatchNorm over the channels -> relu."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1):
        super().__init__()
        kd = kernel if isinstance(kernel, tuple) else (kernel,) * 3
        self.fan_in = in_ch * kd[0] * kd[1] * kd[2]
        self.weight = nn.Parameter(torch.empty(kd + (in_ch, out_ch)))
        self.bn = BatchNorm(out_ch)
        self.stride = stride
        self.padding = tuple(k // 2 for k in kd)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        I.msra_normal(fan_in=self.fan_in)(self.weight, generator)

    def forward(self, x):
        y = ops_nn.conv3d(x, self.weight, stride=self.stride,
                          padding=self.padding)
        # the depth axis folds into the spatial axes BatchNorm averages over
        b, d, h, w, c = y.shape
        y = self.bn(y.reshape(b, d * h, w, c)).reshape(b, d, h, w, c)
        return torch.relu(y)


class C3D(ZooModel):
    """Stacked conv-BN-relu 3-D blocks with spatio-temporal max pooling;
    ``x`` (B, D, H, W, C)."""

    CFG = [(64, (1, 2, 2)), (128, (2, 2, 2)), (256, (2, 2, 2)),
           (256, (2, 2, 2))]

    def __init__(self, num_classes=101, in_ch=3, width_scale=1.0, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        blocks = []
        prev = in_ch
        self._pools = []
        for ch, pool in self.CFG:
            ch = max(8, int(ch * width_scale))
            blocks.append(_Conv3DBN(prev, ch))
            self._pools.append(pool)
            prev = ch
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(prev, num_classes,
                         weight_init=I.msra_uniform(fan_in=prev),
                         sharding=None)
        self._finish(device, seed)

    def forward(self, x):
        for block, pool in zip(self.blocks, self._pools):
            x = ops_nn.pool3d(block(x), pool, pool_type="max")
        return self.fc(x.mean(dim=(1, 2, 3)))

    def loss(self, video, label):
        return classification_loss(self.forward(video), label)
