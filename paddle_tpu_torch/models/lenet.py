"""LeNet-5 for MNIST (``paddle_tpu/models/lenet.py``, the book's
``recognize_digits`` convolutional network): two ``simple_img_conv_pool``
stages, then two fully connected layers."""

from __future__ import annotations

import torch

from paddle_tpu_torch.models.common import ZooModel
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.nn.nets import SimpleImgConvPool

__all__ = ["LeNet"]


class LeNet(ZooModel):
    def __init__(self, num_classes=10, *, device="cuda", seed: int = 0):
        super().__init__()
        self.conv_pool1 = SimpleImgConvPool(1, 20, 5, pool_size=2,
                                            pool_stride=2, act="relu")
        self.conv_pool2 = SimpleImgConvPool(20, 50, 5, pool_size=2,
                                            pool_stride=2, act="relu")
        self.fc1 = Linear(4 * 4 * 50, 500, sharding=None)
        self.fc2 = Linear(500, num_classes, sharding=None)
        self._finish(device, seed)

    def forward(self, x):
        """x (N, 28, 28, 1) NHWC -> (N, num_classes) logits."""
        h = self.conv_pool2(self.conv_pool1(x))           # (N, 4, 4, 50)
        h = torch.relu(self.fc1(h.reshape(h.shape[0], -1)))
        return self.fc2(h)
