"""MobileNetV1-SSD (``paddle_tpu/models/ssd.py``, PaddleCV's
object_detection over ``multi_box_head`` + ``ssd_loss`` +
``detection_output``): an NHWC trunk with extra stride-2 levels, 3x3
location and confidence heads per level, prior boxes built from the
feature shapes at the first forward, the multibox loss and per-class NMS
(``ops.detection``: static shapes, validity masks)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel, eval_mode
from paddle_tpu_torch.models.mobilenet import MobileNetV1
from paddle_tpu_torch.models.resnet import ConvBNLayer
from paddle_tpu_torch.nn.layers import Conv2D
from paddle_tpu_torch.ops import detection as D

__all__ = ["SSD", "SSDConfig"]


@dataclasses.dataclass
class SSDConfig:
    num_classes: int = 21            # background = 0 included
    image_size: int = 300
    backbone_scale: float = 1.0
    #: backbone endpoints (block index, -1 the last) per feature level
    endpoints: Tuple[int, ...] = (10, -1)
    #: extra stride-2 levels after the backbone
    extra_channels: Tuple[int, ...] = (512, 256)
    min_ratio: float = 0.2
    max_ratio: float = 0.95
    aspect_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5)
    variances: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)

    @classmethod
    def tiny(cls, num_classes=4, image_size=64):
        return cls(num_classes=num_classes, image_size=image_size,
                   backbone_scale=0.125, endpoints=(5, -1),
                   extra_channels=(32,))


class SSD(ZooModel):
    """``forward`` -> (loc (B, P, 4) deltas, conf (B, P, C) logits);
    ``loss`` the multibox loss; ``detect`` decoding and per-class NMS."""

    def __init__(self, cfg: SSDConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.backbone = MobileNetV1(num_classes=1, scale=cfg.backbone_scale,
                                    device="cpu")
        self._endpoints = tuple(i if i >= 0 else len(self.backbone.blocks) - 1
                                for i in cfg.endpoints)
        level_ch = [self.backbone.block_channels[i] for i in self._endpoints]
        extras = []
        prev = level_ch[-1]
        for ch in cfg.extra_channels:
            extras.append(ConvBNLayer(prev, ch, 3, stride=2, act="relu"))
            level_ch.append(ch)
            prev = ch
        self.extras = nn.ModuleList(extras)
        n_levels = len(level_ch)
        ratios = np.linspace(cfg.min_ratio, cfg.max_ratio, n_levels + 1)
        self._sizes = [(float(ratios[i] * cfg.image_size),
                        float(ratios[i + 1] * cfg.image_size))
                       for i in range(n_levels)]
        # one min-size box, one per aspect ratio != 1, one sqrt(min * max)
        a_per_cell = 1 + sum(1 for ar in cfg.aspect_ratios
                             if abs(ar - 1.0) >= 1e-6) + 1
        self.loc_heads = nn.ModuleList([
            Conv2D(ch, a_per_cell * 4, 3, padding=1) for ch in level_ch])
        self.conf_heads = nn.ModuleList([
            Conv2D(ch, a_per_cell * cfg.num_classes, 3, padding=1)
            for ch in level_ch])
        self._anchors = None
        self._finish(device, seed)

    def _feature_maps(self, x):
        out, feats = self.backbone.features(x, endpoints=self._endpoints)
        levels = [feats[i] for i in self._endpoints]
        y = out
        for extra in self.extras:
            y = extra(y)
            levels.append(y)
        return levels

    def anchors(self, feature_shapes=None):
        """(P, 4) normalised xyxy prior boxes over every level (built from
        the first forward's feature shapes)."""
        if feature_shapes is None:
            if self._anchors is None:
                raise ValueError("first call needs feature_shapes")
            return self._anchors
        s = self.cfg.image_size
        self._anchors = torch.cat([D.prior_box(
            h, w, s, s, min_sizes=(mn,), max_sizes=(mx,),
            aspect_ratios=self.cfg.aspect_ratios, device=self.device)
            for (h, w), (mn, mx) in zip(feature_shapes, self._sizes)])
        return self._anchors

    def forward(self, image):
        levels = self._feature_maps(image)
        locs, confs, shapes = [], [], []
        for feat, loc_head, conf_head in zip(levels, self.loc_heads,
                                             self.conf_heads):
            b, h, w, _ = feat.shape
            shapes.append((h, w))
            locs.append(loc_head(feat).reshape(b, -1, 4))
            confs.append(conf_head(feat).reshape(b, -1,
                                                 self.cfg.num_classes))
        self.anchors(shapes)
        return torch.cat(locs, 1), torch.cat(confs, 1)

    def loss(self, image, gt_boxes, gt_labels, gt_mask):
        loc, conf = self.forward(image)
        return D.ssd_loss(loc, conf, self._anchors, gt_boxes, gt_labels,
                          gt_mask, variances=self.cfg.variances), {}

    def detect_from(self, loc, conf, *, score_threshold=0.01,
                    nms_threshold=0.45, max_per_class=20):
        """:meth:`detect` on head outputs: (boxes (B, K, 4) normalised
        xyxy, cls (B, K), scores (B, K), valid (B, K)), K = (C - 1) *
        max_per_class."""
        boxes = D.box_decode(loc, self._anchors, self.cfg.variances)
        probs = torch.softmax(conf, -1)[..., 1:]     # the background out
        cls_ids, idxs, valid = D.multiclass_nms_batched(
            boxes, probs, iou_threshold=nms_threshold,
            score_threshold=score_threshold, max_per_class=max_per_class)
        sel = torch.where(valid, D.score_at(probs, idxs, cls_ids), 0.0)
        return (D.take_rows(boxes, idxs), (cls_ids + 1).expand_as(idxs),
                sel, valid)

    def detect(self, image, **kw):
        """Eval-mode forward, then :meth:`detect_from`."""
        with torch.no_grad(), eval_mode(self):
            loc, conf = self.forward(image)
        return self.detect_from(loc, conf, **kw)
