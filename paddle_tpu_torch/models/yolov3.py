"""YOLOv3 (``paddle_tpu/models/yolov3.py``, PaddleCV's yolov3 and
PaddleDetection's ``yolov3_darknet``): per-scale anchor-masked heads over
a MobileNetV1 or DarkNet53 trunk, trained with ``ops.detection.
yolov3_loss`` and decoded with ``yolo_box`` and per-class NMS."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel, eval_mode
from paddle_tpu_torch.models.mobilenet import MobileNetV1
from paddle_tpu_torch.models.resnet import ConvBNLayer
from paddle_tpu_torch.nn.layers import Conv2D
from paddle_tpu_torch.ops import detection as D

__all__ = ["YOLOv3", "YOLOv3Config"]


@dataclasses.dataclass
class YOLOv3Config:
    num_classes: int = 80
    #: advisory: the loss and detection take every scale from the input
    image_size: int = 416
    backbone_scale: float = 1.0
    #: COCO anchors (w, h) in pixels; the masks pick 3 a scale, big first
    anchors: Tuple[Tuple[int, int], ...] = (
        (10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
        (116, 90), (156, 198), (373, 326))
    anchor_masks: Tuple[Tuple[int, ...], ...] = ((6, 7, 8), (3, 4, 5),
                                                (0, 1, 2))
    #: "mobilenet" (V1) or "darknet53" (the canonical backbone)
    backbone: str = "mobilenet"
    #: endpoints for strides (32, 16, 8); None: mobilenet (-1, 10, 4),
    #: darknet53 (-1, 22, 13)
    endpoints: Optional[Tuple[int, ...]] = None
    ignore_thresh: float = 0.7

    @classmethod
    def tiny(cls, num_classes=4, image_size=64):
        return cls(num_classes=num_classes, image_size=image_size,
                   backbone_scale=0.125,
                   anchors=((8, 8), (16, 16), (32, 32), (48, 48)),
                   anchor_masks=((2, 3), (0, 1)), endpoints=(-1, 10))


class YOLOv3(ZooModel):
    """Heads are NCHW (B, A * (5 + C), H, W), the layout ``yolov3_loss``
    and ``yolo_box`` read."""

    def __init__(self, cfg: YOLOv3Config, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        if cfg.backbone == "darknet53":
            from paddle_tpu_torch.models.legacy_cv import DarkNet53
            self.backbone = DarkNet53(num_classes=1, scale=cfg.backbone_scale,
                                      device="cpu")
            endpoints = cfg.endpoints or (-1, 22, 13)
        elif cfg.backbone == "mobilenet":
            self.backbone = MobileNetV1(num_classes=1,
                                        scale=cfg.backbone_scale,
                                        device="cpu")
            endpoints = cfg.endpoints or (-1, 10, 4)
        else:
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        n_blocks = len(self.backbone.blocks)
        self._endpoints = tuple(i if i >= 0 else n_blocks - 1
                                for i in endpoints)
        widths = self.backbone.block_channels
        heads, necks = [], []
        for lvl, ep in enumerate(self._endpoints):
            a = len(cfg.anchor_masks[lvl])
            necks.append(ConvBNLayer(widths[ep], widths[ep], 3, act="relu"))
            heads.append(Conv2D(widths[ep], a * (5 + cfg.num_classes), 1))
        self.necks = nn.ModuleList(necks)
        self.heads = nn.ModuleList(heads)
        self._finish(device, seed)

    def forward(self, image):
        """-> the per-scale raw heads, NCHW."""
        _, feats = self.backbone.features(image, endpoints=self._endpoints)
        return [head(neck(feats[ep])).permute(0, 3, 1, 2)
                for ep, neck, head in zip(self._endpoints, self.necks,
                                          self.heads)]

    def loss(self, image, gt_boxes, gt_labels, gt_mask):
        """gt_boxes (B, G, 4) normalised (cx, cy, w, h), the reference's
        layout."""
        cfg = self.cfg
        total = 0.0
        for lvl, head in enumerate(self.forward(image)):
            total = total + D.yolov3_loss(
                head, gt_boxes, gt_labels, gt_mask, anchors=cfg.anchors,
                anchor_mask=cfg.anchor_masks[lvl], class_num=cfg.num_classes,
                ignore_thresh=cfg.ignore_thresh,
                downsample_ratio=image.shape[2] // head.shape[-1])
        return total, {}

    def detect_from(self, heads, image_hw, *, score_threshold=0.01,
                    nms_threshold=0.45, max_per_class=20):
        """:meth:`detect` on the raw heads of an ``image_hw`` (h, w) batch:
        (boxes (B, K, 4) pixel xyxy, cls, scores, valid), K = C *
        max_per_class."""
        cfg = self.cfg
        img_h, img_w = image_hw
        b = heads[0].shape[0]
        dev = heads[0].device
        img_size = torch.stack([
            torch.full((b,), img_h, dtype=torch.int32, device=dev),
            torch.full((b,), img_w, dtype=torch.int32, device=dev)], -1)
        all_boxes, all_scores = [], []
        for lvl, head in enumerate(heads):
            anchors = [cfg.anchors[i] for i in cfg.anchor_masks[lvl]]
            boxes, scores = D.yolo_box(
                head, img_size, anchors, cfg.num_classes,
                conf_thresh=score_threshold,
                downsample_ratio=img_w // head.shape[-1])
            all_boxes.append(boxes)
            all_scores.append(scores)
        boxes = torch.cat(all_boxes, 1)
        scores = torch.cat(all_scores, 1)
        cls_ids, idxs, valid = D.multiclass_nms_batched(
            boxes, scores, iou_threshold=nms_threshold,
            score_threshold=score_threshold, max_per_class=max_per_class)
        sel = torch.where(valid, D.score_at(scores, idxs, cls_ids), 0.0)
        return D.take_rows(boxes, idxs), cls_ids.expand_as(idxs), sel, valid

    def detect(self, image, **kw):
        """Eval-mode forward, then :meth:`detect_from`."""
        with torch.no_grad(), eval_mode(self):
            heads = self.forward(image)
        return self.detect_from(heads, tuple(image.shape[1:3]), **kw)
