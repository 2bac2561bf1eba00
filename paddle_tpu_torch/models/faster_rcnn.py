"""Faster and Mask R-CNN (``paddle_tpu/models/faster_rcnn.py``, PaddleCV's
rcnn family) over ``ops.detection``: anchors, RPN targets, proposals,
proposal sampling, RoIAlign and the box head (and the mask branch), every
stage of static shape so one captured graph serves every image. The
images of a batch go through the per-image stages one after another (the
reference ``vmap``s them)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from paddle_tpu_torch.models.common import ZooModel, eval_mode
from paddle_tpu_torch.models.mobilenet import MobileNetV1
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import Conv2D, Linear
from paddle_tpu_torch.ops import detection as D
from paddle_tpu_torch.ops import nn as ops_nn

__all__ = ["FasterRCNN", "FasterRCNNConfig", "MaskRCNN"]


@dataclasses.dataclass
class FasterRCNNConfig:
    num_classes: int = 21                 # background = 0 included
    image_size: int = 224
    backbone_scale: float = 1.0
    anchor_sizes: Tuple[int, ...] = (32, 64, 128)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    pre_nms_top_n: int = 256
    post_nms_top_n: int = 64              # proposals kept an image
    roi_batch: int = 32                   # sampled RoIs for the head
    fg_fraction: float = 0.25
    roi_size: int = 7
    head_dim: int = 256
    rpn_batch: int = 64

    @classmethod
    def tiny(cls, num_classes=4, image_size=64):
        return cls(num_classes=num_classes, image_size=image_size,
                   backbone_scale=0.125, anchor_sizes=(16, 32),
                   aspect_ratios=(1.0,), pre_nms_top_n=32,
                   post_nms_top_n=16, roi_batch=16, head_dim=32,
                   rpn_batch=16)


def _safe_div(num, count):
    return num / torch.clamp(count, min=1)


class FasterRCNN(ZooModel):
    """Backbone (stride 16) -> RPN -> proposals -> RoIAlign -> box head."""

    def __init__(self, cfg: FasterRCNNConfig, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        self._build(cfg)
        self._finish(device, seed)

    def _build(self, cfg):
        self.cfg = cfg
        self.backbone = MobileNetV1(num_classes=1, scale=cfg.backbone_scale,
                                    device="cpu")
        self._endpoint = 10               # the stride-16 map
        feat_ch = self.backbone.block_channels[self._endpoint]
        a = len(cfg.anchor_sizes) * len(cfg.aspect_ratios)
        self.num_anchors = a
        self.rpn_conv = Conv2D(feat_ch, cfg.head_dim, 3, padding=1)
        self.rpn_cls = Conv2D(cfg.head_dim, a, 1)
        self.rpn_reg = Conv2D(cfg.head_dim, 4 * a, 1)
        self.fc1 = Linear(feat_ch * cfg.roi_size * cfg.roi_size,
                          cfg.head_dim, sharding=None)
        self.fc2 = Linear(cfg.head_dim, cfg.head_dim, sharding=None)
        self.cls_head = Linear(cfg.head_dim, cfg.num_classes,
                               weight_init=I.normal(std=0.01), sharding=None)
        self.reg_head = Linear(cfg.head_dim, 4 * cfg.num_classes,
                               weight_init=I.normal(std=0.001),
                               sharding=None)

    @property
    def im_shape(self):
        return (float(self.cfg.image_size), float(self.cfg.image_size))

    # -- stages --------------------------------------------------------------

    def features(self, image):
        _, feats = self.backbone.features(image, endpoints=(self._endpoint,))
        return feats[self._endpoint]

    def rpn(self, feat):
        """-> (scores (B, H W A), deltas (B, H W A, 4), anchors (H W A,
        4))."""
        h = torch.relu(self.rpn_conv(feat))
        scores = self.rpn_cls(h)
        deltas = self.rpn_reg(h)
        b, fh, fw, _ = scores.shape
        stride = float(self.cfg.image_size // fh)
        anchors, _ = D.anchor_generator(
            fh, fw, anchor_sizes=self.cfg.anchor_sizes,
            aspect_ratios=self.cfg.aspect_ratios, stride=(stride, stride),
            device=feat.device)
        return scores.reshape(b, -1), deltas.reshape(b, -1, 4), anchors

    def _pool(self, feat_i, rois):
        return D.roi_align(feat_i, rois,
                           output_size=(self.cfg.roi_size,) * 2,
                           spatial_scale=feat_i.shape[0] / self.cfg.image_size)

    def _head_pooled(self, pooled):
        h = torch.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))
        h = torch.relu(self.fc2(h))
        return self.cls_head(h), self.reg_head(h)

    def head(self, feat_i, rois):
        """The box head on one image's RoIs -> (cls logits, deltas)."""
        return self._head_pooled(self._pool(feat_i, rois))

    # -- training -------------------------------------------------------------

    def _stage_losses(self, feat_i, score_i, delta_i, anchors, gt_b, gt_l,
                      gt_m):
        """One image's RPN and RoI-head losses, and the sampled RoIs'
        auxiliaries (for the mask branch)."""
        cfg = self.cfg
        labels, tgt, fg, _ = D.rpn_target_assign(
            anchors, gt_b, gt_m, im_shape=self.im_shape,
            batch_size_per_im=cfg.rpn_batch)
        obj = ops_nn.sigmoid_cross_entropy_with_logits(
            score_i, (labels == 1).to(score_i.dtype))
        used = labels >= 0
        rpn_cls_l = _safe_div((obj * used).sum(), used.sum())
        rpn_reg_l = _safe_div((ops_nn.smooth_l1(delta_i, tgt.detach())
                               .sum(-1) * fg).sum(), fg.sum())
        # proposals: the gradient stops at the sampled boxes
        rois, _, valid = D.generate_proposals(
            score_i.detach(), delta_i.detach(), anchors, self.im_shape,
            pre_nms_top_n=cfg.pre_nms_top_n,
            post_nms_top_n=cfg.post_nms_top_n, min_size=4.0)
        # the ground truths join as proposals of sure quality
        rois = torch.cat([rois.detach(), gt_b])
        valid = torch.cat([valid, gt_m])
        roi_labels, roi_tgt, roi_fg, roi_bg, roi_match = \
            D.generate_proposal_labels(
                rois, valid, gt_b, gt_l, gt_m,
                batch_size_per_im=cfg.roi_batch,
                fg_fraction=cfg.fg_fraction, return_matches=True)
        # the head on a fixed roi_batch: the sampled first, stably
        sampled = roi_fg | roi_bg
        pick = torch.argsort((~sampled).to(torch.uint8), stable=True)[
            :cfg.roi_batch]
        rois_s, lab_s = rois[pick], roi_labels[pick]
        tgt_s, use_s = roi_tgt[pick], sampled[pick]
        pooled = self._pool(feat_i, rois_s)
        cls_logits, reg = self._head_pooled(pooled)
        logp = torch.log_softmax(cls_logits.float(), -1)
        lab = torch.clamp(lab_s, min=0).long()
        ce = -torch.gather(logp, -1, lab[:, None])[:, 0]
        head_cls_l = _safe_div((ce * use_s).sum(), use_s.sum())
        reg = reg.reshape(cfg.roi_batch, cfg.num_classes, 4)
        reg_sel = torch.gather(reg, 1, lab[:, None, None].expand(-1, 1, 4))[
            :, 0]
        fg_s = use_s & (lab_s > 0)
        head_reg_l = _safe_div((ops_nn.smooth_l1(reg_sel, tgt_s.detach())
                                .sum(-1) * fg_s).sum(), fg_s.sum())
        total = rpn_cls_l + rpn_reg_l + head_cls_l + head_reg_l
        aux = dict(rois=rois_s, labels=lab_s, use=use_s, fg=fg_s,
                   match=roi_match[pick], pooled=pooled)
        return total, aux

    def loss(self, image, gt_boxes, gt_labels, gt_mask):
        """gt_boxes (B, G, 4) pixel xyxy; gt_labels (B, G) in [1, C)."""
        feat = self.features(image)
        scores, deltas, anchors = self.rpn(feat)
        losses = [self._stage_losses(feat[i], scores[i], deltas[i], anchors,
                                     gt_boxes[i], gt_labels[i],
                                     gt_mask[i])[0]
                  for i in range(image.shape[0])]
        return torch.stack(losses).mean(), {}

    # -- inference ------------------------------------------------------------

    def proposals(self, score_i, delta_i, anchors):
        """One image's proposals -> (rois (post, 4), valid)."""
        cfg = self.cfg
        rois, _, valid = D.generate_proposals(
            score_i, delta_i, anchors, self.im_shape,
            pre_nms_top_n=cfg.pre_nms_top_n,
            post_nms_top_n=cfg.post_nms_top_n, min_size=4.0)
        return rois, valid

    def final_detections(self, rois, valid, cls_logits, reg, *,
                         score_threshold=0.05, nms_threshold=0.5,
                         max_per_class=10):
        """One image's box head outputs -> (boxes (K, 4), cls (K,), scores,
        valid): per-class boxes decoded and clipped, each RoI's box of its
        best foreground class, per-class NMS over those."""
        cfg = self.cfg
        probs = torch.softmax(cls_logits.float(), -1) * valid[:, None]
        reg = reg.reshape(rois.shape[0], cfg.num_classes, 4)
        boxes_c = D.box_clip(D.box_decode(reg, rois[:, None, :]),
                             self.im_shape)
        best_c = torch.argmax(probs[:, 1:], dim=-1) + 1
        cand = torch.gather(boxes_c, 1, best_c[:, None, None].expand(
            -1, 1, 4))[:, 0]
        cls_ids, idxs, ok = D.multiclass_nms(
            cand, probs[:, 1:], iou_threshold=nms_threshold,
            score_threshold=score_threshold, max_per_class=max_per_class)
        sel = torch.where(ok, probs[idxs, cls_ids + 1], 0.0)
        return cand[idxs], cls_ids + 1, sel, ok

    def detect(self, image, *, feat=None, **kw):
        """Eval-mode detection -> (boxes (B, K, 4), cls, scores, valid);
        ``feat`` shares precomputed backbone features."""
        with torch.no_grad(), eval_mode(self):
            if feat is None:
                feat = self.features(image)
            scores, deltas, anchors = self.rpn(feat)
            outs = []
            for i in range(feat.shape[0]):
                rois, valid = self.proposals(scores[i], deltas[i], anchors)
                cls_logits, reg = self.head(feat[i], rois)
                outs.append(self.final_detections(rois, valid, cls_logits,
                                                  reg, **kw))
        return tuple(torch.stack(x) for x in zip(*outs))


class MaskRCNN(FasterRCNN):
    """Faster R-CNN and a per-class mask branch on the same sampled RoIs:
    RoIAlign at ``roi_size``, a 3x3 conv, one stride-2 transposed conv
    (its weight in the reference's HWIO layout), a 1x1 conv; masks of
    ``2 * roi_size``."""

    def __init__(self, cfg: FasterRCNNConfig, *, device="cuda",
                 seed: int = 0):
        ZooModel.__init__(self)
        self._build(cfg)
        feat_ch = self.backbone.block_channels[self._endpoint]
        d = cfg.head_dim
        self.mask_conv = Conv2D(feat_ch, d, 3, padding=1)
        self.mask_deconv = torch.nn.Parameter(torch.empty(2, 2, d, d))
        self.mask_pred = Conv2D(d, cfg.num_classes, 1,
                                weight_init=I.normal(std=0.01))
        self.mask_resolution = 2 * cfg.roi_size
        self._finish(device, seed)

    def reset_parameters(self, generator=None):
        I.msra_normal(fan_in=self.cfg.head_dim * 4)(self.mask_deconv,
                                                    generator)

    def _mask_head(self, feat_i, rois, pooled=None):
        """RoIs -> per-class mask logits (R, 2s, 2s, C)."""
        if pooled is None:
            pooled = self._pool(feat_i, rois)
        h = torch.relu(self.mask_conv(pooled))
        h = torch.relu(ops_nn.conv2d_transpose(
            h, self.mask_deconv.to(h.dtype), stride=2))
        return self.mask_pred(h)

    def loss(self, image, gt_boxes, gt_labels, gt_mask, gt_inst_masks):
        """As :meth:`FasterRCNN.loss`, plus ``gt_inst_masks`` (B, G, Hm,
        Hm) binary instance rasters at image scale."""
        cfg = self.cfg
        feat = self.features(image)
        scores, deltas, anchors = self.rpn(feat)
        totals, mask_ls = [], []
        for i in range(image.shape[0]):
            det_l, aux = self._stage_losses(feat[i], scores[i], deltas[i],
                                            anchors, gt_boxes[i],
                                            gt_labels[i], gt_mask[i])
            targets, w = D.generate_mask_labels(
                aux["rois"], aux["match"], aux["fg"], gt_inst_masks[i],
                resolution=self.mask_resolution, im_size=cfg.image_size)
            logits = self._mask_head(feat[i], aux["rois"],
                                     pooled=aux["pooled"])
            cls = torch.clamp(aux["labels"], min=0).long()
            sel = torch.gather(logits, -1, cls[:, None, None, None].expand(
                -1, *logits.shape[1:3], 1))[..., 0]
            bce = ops_nn.sigmoid_cross_entropy_with_logits(
                sel, targets.detach()).mean(dim=(1, 2))
            mask_l = (bce * w).sum() / torch.clamp(w.sum(), min=1.0)
            totals.append(det_l + mask_l)
            mask_ls.append(mask_l)
        return torch.stack(totals).mean(), {
            "mask_loss": torch.stack(mask_ls).mean()}

    def segment(self, image, *, binarize_threshold=0.5, **kw):
        """:meth:`detect` plus a binary instance mask per kept detection:
        (boxes, classes, scores, valid, masks (B, K, 2s, 2s))."""
        with torch.no_grad(), eval_mode(self):
            feat = self.features(image)
            boxes, classes, scores, ok = self.detect(image, feat=feat, **kw)
            masks = []
            for i in range(feat.shape[0]):
                logits = self._mask_head(feat[i], boxes[i])
                sel = torch.gather(logits, -1, classes[i][:, None, None, None]
                                   .expand(-1, *logits.shape[1:3], 1))[..., 0]
                masks.append(torch.sigmoid(sel))
            masks = (torch.stack(masks) >= binarize_threshold).float()
        return boxes, classes, scores, ok, masks * ok[:, :, None, None]
