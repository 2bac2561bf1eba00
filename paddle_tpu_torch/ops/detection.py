"""Detection ops (``paddle_tpu/ops/detection.py``, the reference's
``operators/detection/``) under the reference's 34 registered names: box
IoU and coding, prior and anchor generation, YOLOv3's head decoding,
greedy / multiclass / matrix NMS, RoI pooling and alignment, matching,
target assignment and sampling, and the SSD, YOLOv3 and focal losses.

Every shape is static and no op reads a value back to the host, so a
loss or a detection can be captured in a CUDA graph: ground truths come
padded with a row mask, dynamic counts ride validity masks, and the
reference's ``lax`` loops over a static count are Python loops here.
Ties break as the reference's do: ``jax.lax.top_k`` and ``jnp.argsort``
keep the lower index first among equal keys, so the port sorts stably
(:func:`_top_k`, :func:`topk_mask`); ``torch.argmax`` and ``jnp.argmax``
both take the first maximum. The samplers (RoI align and pool, the
deformable and perspective ops) gather by hand, by the reference's rules:
``F.grid_sample`` and torchvision's ``roi_align`` do not give its
numbers. The random subsampling of ``rpn_target_assign`` and
``generate_proposal_labels`` draws from a ``torch.Generator`` where the
reference takes a key; without one both keep the hardest candidates
deterministically, as the reference does without a key.

The ops take the reference's single-image shapes; the internal helpers
they are built on also take leading batch axes, which the detectors use
in place of the reference's ``vmap`` over images and classes.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.registry import register_op

_NEG_INF = float("-inf")
_CONSTS: dict = {}


def _const(values, device, dtype=torch.float32):
    """A small constant tensor (anchors, variances) on ``device``, made
    once and kept: a copy from the host cannot run inside a CUDA graph's
    capture, so a step's eager warm-up call makes the constants its
    capture then reuses."""
    key = (repr(values), str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def _top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest, ties to the
    lower index (a stable descending sort)."""
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def take_rows(x, idx):
    """``x[..., idx, :]`` per leading index: ``x`` (..., N, K), ``idx``
    (..., M) -> (..., M, K)."""
    return torch.gather(x, -2, idx[..., None].expand(
        *idx.shape, x.shape[-1]))


def _pad_last(x, n: int, value):
    """Pad the last axis of ``x`` to ``n`` with ``value``."""
    pad = n - x.shape[-1]
    if pad <= 0:
        return x
    return torch.cat([x, torch.full(x.shape[:-1] + (pad,), value,
                                    dtype=x.dtype, device=x.device)], -1)


def _vars(variances, ref):
    if isinstance(variances, torch.Tensor):
        return variances.to(ref.dtype)
    return _const(tuple(float(v) for v in variances), ref.device, ref.dtype)


@register_op("iou_similarity")
def box_iou(boxes1, boxes2):
    """IoU matrix: xyxy boxes (..., N, 4), (..., M, 4) -> (..., N, M)."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3]
                                                 - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3]
                                                 - boxes2[..., 1])
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area1[..., :, None] + area2[..., None, :]
                               - inter, min=1e-10)


@register_op("box_coder")
def box_encode(boxes, anchors, variances=(0.1, 0.1, 0.2, 0.2)):
    """``encode_center_size`` (``box_coder_op``): ground-truth xyxy against
    anchor xyxy (broadcast over leading axes) -> deltas."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    bx = boxes[..., 0] + 0.5 * bw
    by = boxes[..., 1] + 0.5 * bh
    v = _vars(variances, boxes)
    return torch.stack([
        (bx - ax) / aw / v[0], (by - ay) / ah / v[1],
        torch.log(torch.clamp(bw / aw, min=1e-10)) / v[2],
        torch.log(torch.clamp(bh / ah, min=1e-10)) / v[3]], dim=-1)


def box_decode(deltas, anchors, variances=(0.1, 0.1, 0.2, 0.2)):
    """The inverse of :func:`box_encode`: deltas -> xyxy."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    v = _vars(variances, deltas)
    cx = deltas[..., 0] * v[0] * aw + ax
    cy = deltas[..., 1] * v[1] * ah + ay
    w = torch.exp(deltas[..., 2] * v[2]) * aw
    h = torch.exp(deltas[..., 3] * v[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _centers(feature_h, feature_w, step_h, step_w, offset, device):
    """(H * W, 1, 2) cell centres (x, y), row-major, float32."""
    cy = (torch.arange(feature_h, dtype=torch.float32, device=device)
          + offset) * step_h
    cx = (torch.arange(feature_w, dtype=torch.float32, device=device)
          + offset) * step_w
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    return torch.stack([cx, cy], -1).reshape(-1, 1, 2)


@register_op("prior_box")
def prior_box(feature_h, feature_w, image_h, image_w, min_sizes,
              max_sizes=(), aspect_ratios=(1.0,), step=None, offset=0.5,
              clip=True, *, device="cuda"):
    """SSD anchors of one feature map (``prior_box_op``): (H * W * A, 4)
    normalised xyxy, per cell each min size's aspect-ratio boxes (ratio 1
    first) then its ``sqrt(min * max)`` box (the reference's default
    order)."""
    device = resolve_device(device)
    step_h = step or image_h / feature_h
    step_w = step or image_w / feature_w
    whs = []
    for i, ms in enumerate(min_sizes):
        whs.append((ms, ms))
        for ar in aspect_ratios:
            if abs(ar - 1.0) < 1e-6:
                continue
            whs.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
        if i < len(max_sizes):
            whs.append(((ms * max_sizes[i]) ** 0.5,) * 2)
    whs = _const(whs, device)
    centers = _centers(feature_h, feature_w, step_h, step_w, offset, device)
    half = whs[None, :, :] / 2.0
    boxes = torch.cat([centers - half, centers + half], -1).reshape(-1, 4)
    boxes = boxes / _const([image_w, image_h, image_w, image_h], device)
    return torch.clamp(boxes, 0.0, 1.0) if clip else boxes


@register_op("yolo_box")
def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, scale_x_y=1.0, clip_bbox=True):
    """Decode a YOLOv3 head (``yolo_box_op``). ``x`` (B, A * (5 + C), H,
    W) NCHW; ``img_size`` (B, 2) = (h, w); ``anchors`` [(w, h), ...]
    pixels. Returns (boxes (B, H * W * A, 4) pixel xyxy, scores (B, H * W
    * A, C))."""
    b, _, h, w = x.shape
    a, c = len(anchors), class_num
    x = x.reshape(b, a, 5 + c, h, w).permute(0, 3, 4, 1, 2)
    grid_x = torch.arange(w, dtype=torch.float32,
                          device=x.device)[None, None, :, None]
    grid_y = torch.arange(h, dtype=torch.float32,
                          device=x.device)[None, :, None, None]
    anc = _const([tuple(a) for a in anchors], x.device)
    bias = 0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(x[..., 0]) * scale_x_y - bias + grid_x) / w
    cy = (torch.sigmoid(x[..., 1]) * scale_x_y - bias + grid_y) / h
    bw = torch.exp(x[..., 2]) * anc[:, 0] / (downsample_ratio * w)
    bh = torch.exp(x[..., 3]) * anc[:, 1] / (downsample_ratio * h)
    conf = torch.sigmoid(x[..., 4])
    probs = torch.sigmoid(x[..., 5:]) * conf[..., None]
    probs = torch.where(conf[..., None] >= conf_thresh, probs, 0.0)
    img_wh = img_size.flip(-1)[:, None, :].float()        # (B, 1, 2) w, h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2], -1)
    boxes = boxes.reshape(b, -1, 4) * img_wh.repeat(1, 1, 2)
    if clip_bbox:
        # yolo_box_op's CalcDetectionBox: x1/y1 at least 0, x2/y2 at most
        # img_w - 1 / img_h - 1
        boxes = torch.cat([torch.clamp(boxes[..., :2], min=0.0),
                           torch.minimum(boxes[..., 2:], img_wh - 1.0)], -1)
    return boxes, probs.reshape(b, -1, c)


def _greedy_nms(iou, scores, score_threshold, iou_threshold, steps: int):
    """Greedy NMS by repeated argmax over ``scores`` (..., K, N) sharing
    the IoU matrix ``iou`` (..., N, N) of each leading index: each step
    picks the best available box (the first on ties) and retires it and
    every box whose IoU with it reaches ``iou_threshold``. Returns
    (indices (..., K, steps), valid)."""
    n = scores.shape[-1]
    ar = torch.arange(n, device=scores.device)
    avail = torch.where(scores >= score_threshold, scores, _NEG_INF)
    rows = iou.unsqueeze(-3).expand(*iou.shape[:-2], scores.shape[-2], n, n)
    idxs, valids = [], []
    for _ in range(steps):
        idx = torch.argmax(avail, dim=-1)
        best = torch.gather(avail, -1, idx[..., None])[..., 0]
        valid = best > _NEG_INF
        row = torch.gather(rows, -2, idx[..., None, None].expand(
            *idx.shape, 1, n))[..., 0, :]
        suppress = (row >= iou_threshold) | (ar == idx[..., None])
        avail = torch.where(valid[..., None] & suppress, _NEG_INF, avail)
        idxs.append(torch.where(valid, idx, 0))
        valids.append(valid)
    return torch.stack(idxs, -1), torch.stack(valids, -1)


def _pad_outputs(idxs, valid, n: int):
    return (_pad_last(idxs, n, 0), _pad_last(valid, n, False))


@register_op("nms")
def nms(boxes, scores, *, iou_threshold=0.5, score_threshold=0.0,
        max_outputs=100):
    """Static-shape greedy NMS: boxes (N, 4), scores (N,) -> (indices
    (max_outputs,), valid (max_outputs,) bool)."""
    idxs, valid = _greedy_nms(box_iou(boxes, boxes), scores[None],
                              score_threshold, iou_threshold,
                              min(max_outputs, boxes.shape[0]))
    return _pad_outputs(idxs[0], valid[0], max_outputs)


def score_at(scores, idxs, cls_ids):
    """``scores[..., idxs, cls_ids]`` per leading index: scores (..., N,
    C), idxs (..., K), cls_ids (K,) -> (..., K)."""
    flat = scores.reshape(*scores.shape[:-2], -1)
    return torch.gather(flat, -1, idxs * scores.shape[-1] + cls_ids)


def multiclass_nms_batched(boxes, scores, *, iou_threshold=0.45,
                           score_threshold=0.01, max_per_class=100):
    """:func:`multiclass_nms` over leading axes: boxes (..., N, 4), scores
    (..., N, C) -> (cls_ids (C * max_per_class,), indices and valid
    (..., C * max_per_class))."""
    n, c = scores.shape[-2:]
    idxs, valid = _greedy_nms(box_iou(boxes, boxes), scores.transpose(-1, -2),
                              score_threshold, iou_threshold,
                              min(max_per_class, n))
    idxs, valid = _pad_outputs(idxs, valid, max_per_class)
    cls_ids = torch.arange(c, device=scores.device).repeat_interleave(
        max_per_class)
    return (cls_ids, idxs.reshape(*idxs.shape[:-2], -1),
            valid.reshape(*valid.shape[:-2], -1))


@register_op("multiclass_nms")
def multiclass_nms(boxes, scores, *, iou_threshold=0.45,
                   score_threshold=0.01, max_per_class=100):
    """Per-class NMS (``multiclass_nms_op``): boxes (N, 4), scores (N, C)
    -> (cls_ids, indices, valid), each (C * max_per_class,)."""
    return multiclass_nms_batched(boxes, scores, iou_threshold=iou_threshold,
                                  score_threshold=score_threshold,
                                  max_per_class=max_per_class)


def multiclass_nms2(boxes, scores, *, iou_threshold=0.45,
                    score_threshold=0.01, max_per_class=100):
    """``multiclass_nms2_op``: :func:`multiclass_nms` with the input-box
    indices as a fourth output."""
    cls_ids, idxs, valid = multiclass_nms(
        boxes, scores, iou_threshold=iou_threshold,
        score_threshold=score_threshold, max_per_class=max_per_class)
    return cls_ids, idxs, valid, idxs


@register_op("box_clip")
def box_clip(boxes, im_shape):
    """Clip xyxy boxes into the image (``box_clip_op``); ``im_shape`` (h,
    w), or (..., 2) broadcastable."""
    if isinstance(im_shape, torch.Tensor):
        im_shape = im_shape.to(boxes.dtype)
    else:
        im_shape = _const([float(v) for v in im_shape], boxes.device,
                          boxes.dtype)
    h = im_shape[..., 0:1]
    w = im_shape[..., 1:2]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return torch.cat([
        torch.minimum(torch.maximum(boxes[..., 0:1], zero), w - 1),
        torch.minimum(torch.maximum(boxes[..., 1:2], zero), h - 1),
        torch.minimum(torch.maximum(boxes[..., 2:3], zero), w - 1),
        torch.minimum(torch.maximum(boxes[..., 3:4], zero), h - 1)], -1)


@register_op("matrix_nms")
def matrix_nms(boxes, scores, *, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0):
    """Matrix NMS (``matrix_nms_op``, SOLOv2): each box's score decays by
    its worst overlap with a higher-scored box, compensated by how
    suppressed that box is. boxes (N, 4), scores (N,) -> (indices
    (keep_top_k,), new scores, valid)."""
    n = boxes.shape[0]
    k = min(nms_top_k, n)
    top_scores, order = _top_k(
        torch.where(scores >= score_threshold, scores, _NEG_INF), k)
    cand = boxes[order]
    iou = box_iou(cand, cand)
    higher = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                   device=boxes.device), 1)
    iou_h = torch.where(higher.T, iou, 0.0)       # (i, j): j scores higher
    comp_j = iou_h.amax(dim=1)[None, :]
    if use_gaussian:
        decay = torch.exp(-(iou_h ** 2 - comp_j ** 2) / gaussian_sigma)
    else:
        decay = (1.0 - iou_h) / torch.clamp(1.0 - comp_j, min=1e-10)
    decay = torch.where(iou_h > 0.0, decay, 1.0).amin(dim=1)
    new_scores = torch.where(torch.isfinite(top_scores), top_scores * decay,
                             _NEG_INF)
    new_scores = torch.where(new_scores >= post_threshold, new_scores,
                             _NEG_INF)
    kept_scores, kept = _top_k(new_scores, min(keep_top_k, k))
    idxs = _pad_last(order[kept], keep_top_k, 0)
    kept_scores = _pad_last(kept_scores, keep_top_k, _NEG_INF)
    valid = torch.isfinite(kept_scores)
    return idxs, torch.where(valid, kept_scores, 0.0), valid


@register_op("density_prior_box")
def density_prior_box(feature_h, feature_w, image_h, image_w, *,
                      fixed_sizes, fixed_ratios=(1.0,), densities=(1,),
                      step=None, offset=0.5, clip=True, device="cuda"):
    """Density prior boxes (``density_prior_box_op``): each (fixed size,
    density) pair tiles density^2 shifted centres per cell. Returns (H *
    W * A, 4) normalised xyxy, A = sum(d^2) * len(fixed_ratios)."""
    if len(fixed_sizes) != len(densities):
        raise ValueError(
            f"fixed_sizes ({len(fixed_sizes)}) and densities "
            f"({len(densities)}) must pair up one-to-one")
    device = resolve_device(device)
    step_h = step or image_h / feature_h
    step_w = step or image_w / feature_w
    rows = []
    # the reference truncates the averaged step and each shift to int
    step_avg = int((step_h + step_w) * 0.5)
    for size, density in zip(fixed_sizes, densities):
        shift = int(step_avg / density)
        for ratio in fixed_ratios:
            w = size * (ratio ** 0.5)
            h = size / (ratio ** 0.5)
            for di in range(density):
                for dj in range(density):
                    rows.append(((dj + 0.5) * shift - step_avg / 2.0,
                                 (di + 0.5) * shift - step_avg / 2.0, w, h))
    offs = _const(rows, device)
    centers = _centers(feature_h, feature_w, step_h, step_w, offset, device)
    ctr = centers + offs[None, :, :2]
    half = offs[None, :, 2:] / 2.0
    boxes = torch.cat([ctr - half, ctr + half], -1).reshape(-1, 4)
    boxes = boxes / _const([image_w, image_h, image_w, image_h], device)
    return torch.clamp(boxes, 0.0, 1.0) if clip else boxes


@register_op("anchor_generator")
def anchor_generator(feature_h, feature_w, *, anchor_sizes=(64, 128, 256),
                     aspect_ratios=(0.5, 1.0, 2.0), stride=(16.0, 16.0),
                     offset=0.5, variances=(0.1, 0.1, 0.2, 0.2),
                     device="cuda"):
    """RPN anchors of one feature map (``anchor_generator_op``): pixel xyxy
    (H * W * A, 4) and the variances broadcast to (H * W * A, 4)."""
    device = resolve_device(device)
    whs = []
    for size in anchor_sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = (area / ar) ** 0.5
            whs.append((w, w * ar))
    whs = _const(whs, device)
    centers = _centers(feature_h, feature_w, stride[0], stride[1], offset,
                       device)
    half = whs[None, :, :] / 2.0
    anchors = torch.cat([centers - half, centers + half], -1).reshape(-1, 4)
    var = _const(list(variances), device).expand(anchors.shape[0], 4)
    return anchors, var


@register_op("roi_pool")
def roi_pool(features, rois, *, output_size=(7, 7), spatial_scale=1.0):
    """RoI max pooling (``roi_pool_op``, Fast R-CNN's quantised bins):
    features (H, W, C), rois (R, 4) xyxy image coordinates -> (R, oh, ow,
    C); an empty bin gives 0."""
    h, w, _ = features.shape
    oh, ow = output_size
    dev = features.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    x1, y1, x2, y2 = torch.round(rois * spatial_scale).unbind(-1)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    by = torch.arange(oh, dtype=torch.float32, device=dev)
    bx = torch.arange(ow, dtype=torch.float32, device=dev)
    y_lo = y1[:, None] + torch.floor(by * rh[:, None] / oh)
    y_hi = y1[:, None] + torch.ceil((by + 1) * rh[:, None] / oh)
    x_lo = x1[:, None] + torch.floor(bx * rw[:, None] / ow)
    x_hi = x1[:, None] + torch.ceil((bx + 1) * rw[:, None] / ow)
    in_y = (ys >= y_lo[..., None]) & (ys < y_hi[..., None])   # (R, oh, H)
    in_x = (xs >= x_lo[..., None]) & (xs < x_hi[..., None])   # (R, ow, W)
    m = in_y[:, :, None, :, None] & in_x[:, None, :, None, :]
    neg = torch.finfo(features.dtype).min
    out = torch.where(m[..., None], features, neg).amax(dim=(3, 4))
    return torch.where(m.any(dim=(3, 4))[..., None], out, 0.0)


def _bilinear_clamped(feat_flat, h, w, ys, xs):
    """RoIAlign's bilinear read: coordinates clamped into the map, the
    upper neighbour clamped to the edge. ``feat_flat`` (G, H * W, C) with
    G 1 or the leading size of ``ys`` (G, Hs, Ws) / ``xs``."""
    y = torch.clamp(ys, 0.0, h - 1.0)
    x = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]

    def at(yi, xi):
        idx = (yi * w + xi).reshape(yi.shape[0], -1)
        g = feat_flat.expand(idx.shape[0], -1, -1)
        out = torch.gather(g, 1, idx[..., None].expand(*idx.shape,
                                                       g.shape[-1]))
        return out.reshape(*yi.shape, g.shape[-1])

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def roi_align_flat(feat_flat, h, w, rois, output_size, spatial_scale,
                   sampling_ratio):
    """:func:`roi_align` over a flattened map ``feat_flat`` (1 or R, H *
    W, C): (R, oh, ow, C)."""
    oh, ow = output_size
    sr = sampling_ratio
    dev = rois.device
    r = rois * spatial_scale
    x1, y1, x2, y2 = r.unbind(-1)
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w = rw / ow
    bin_h = rh / oh
    ys = y1[:, None] + (torch.arange(oh * sr, dtype=torch.float32,
                                     device=dev) + 0.5) * bin_h[:, None] / sr
    xs = x1[:, None] + (torch.arange(ow * sr, dtype=torch.float32,
                                     device=dev) + 0.5) * bin_w[:, None] / sr
    gy = ys[:, :, None].expand(-1, -1, ow * sr)
    gx = xs[:, None, :].expand(-1, oh * sr, -1)
    samples = _bilinear_clamped(feat_flat, h, w, gy, gx)
    return samples.reshape(rois.shape[0], oh, sr, ow, sr, -1).mean(dim=(2, 4))


@register_op("roi_align")
def roi_align(features, rois, *, output_size=(7, 7), spatial_scale=1.0,
              sampling_ratio=2):
    """RoIAlign (``roi_align_op``): features (H, W, C) one image NHWC, rois
    (R, 4) xyxy image coordinates -> (R, oh, ow, C); ``sampling_ratio``^2
    bilinear samples a bin, averaged."""
    h, w, c = features.shape
    return roi_align_flat(features.reshape(1, h * w, c), h, w, rois,
                          output_size, spatial_scale, sampling_ratio)


# -- matching, target assignment, losses -----------------------------------


def bipartite_match_batched(dist, row_mask=None):
    """:func:`bipartite_match` over leading axes: dist (..., G, P)."""
    g, p = dist.shape[-2:]
    if row_mask is not None:
        dist = torch.where(row_mask[..., :, None], dist, -1.0)
    dev = dist.device
    rows = torch.arange(g, device=dev)
    cols = torch.arange(p, device=dev)
    col_to_row = torch.full(dist.shape[:-2] + (p,), -1, dtype=torch.int32,
                            device=dev)
    col_dist = torch.zeros(dist.shape[:-2] + (p,), dtype=dist.dtype,
                           device=dev)
    d = dist
    for _ in range(g):
        idx = torch.argmax(d.reshape(*d.shape[:-2], g * p), dim=-1)
        r, c = idx // p, idx % p
        best = torch.gather(d.reshape(*d.shape[:-2], g * p), -1,
                            idx[..., None])[..., 0]
        ok = (best > 0.0)[..., None]
        at_c = ok & (cols == c[..., None])
        col_to_row = torch.where(at_c, r[..., None].to(torch.int32),
                                 col_to_row)
        col_dist = torch.where(at_c, best[..., None], col_dist)
        retire = (rows == r[..., None])[..., :, None] | \
            (cols == c[..., None])[..., None, :]
        d = torch.where(ok[..., None] & retire, -1.0, d)
    return col_to_row, col_dist


@register_op("bipartite_match")
def bipartite_match(dist, row_mask=None):
    """Greedy bipartite matching (``bipartite_match_op``): dist (G, P)
    similarity of ground-truth rows to prior columns, ``row_mask`` (G,)
    the real rows. Repeatedly matches the globally best (row, column)
    pair (the first in row-major order on ties) and retires both.
    Returns (match_indices (P,) int32, -1 where unmatched; match_dist
    (P,))."""
    return bipartite_match_batched(dist, row_mask)


def match_boxes(iou, row_mask=None, *, match_type="per_prediction",
                overlap_threshold=0.5):
    """SSD matching over leading axes: bipartite seeds, then (per
    prediction) every unmatched prior whose best ground truth reaches
    ``overlap_threshold`` matches it too."""
    m_idx, m_dist = bipartite_match_batched(iou, row_mask)
    if match_type == "per_prediction":
        masked = iou if row_mask is None else torch.where(
            row_mask[..., :, None], iou, -1.0)
        best_iou = masked.amax(dim=-2)
        best_row = torch.argmax(masked, dim=-2).to(torch.int32)
        extra = (m_idx < 0) & (best_iou >= overlap_threshold)
        m_idx = torch.where(extra, best_row, m_idx)
        m_dist = torch.where(extra, best_iou, m_dist)
    return m_idx, m_dist


@register_op("target_assign")
def target_assign(x, match_indices, mismatch_value=0.0):
    """Per-prior targets gathered from ground-truth rows
    (``target_assign_op``): x (G, K), match_indices (P,) -> (out (P, K),
    out_weight (P,), 1.0 where matched), unmatched rows
    ``mismatch_value``."""
    matched = match_indices >= 0
    out = take_rows(x, torch.clamp(match_indices, min=0).long())
    out = torch.where(matched[..., None], out, float(mismatch_value))
    return out, matched.float()


def _stable_bce(logits, targets):
    """``max(x, 0) - x t + log1p(exp(-|x|))``, the overflow-safe sigmoid
    BCE of the focal and YOLOv3 losses."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def topk_mask(mask, score, limit):
    """Keep at most ``limit`` (a tensor or int, per leading index) True
    entries of ``mask`` along the last axis, those of highest ``score``
    (ties to the lower index): the dynamic count as a rank threshold."""
    p = score.shape[-1]
    order = torch.argsort(-torch.where(mask, score, _NEG_INF), dim=-1,
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(p, device=score.device).expand_as(order))
    if isinstance(limit, torch.Tensor) and limit.ndim:
        limit = limit[..., None]
    return mask & (rank < limit)


def mine_hard_examples_batched(neg_loss, match_indices, *, neg_pos_ratio=3.0,
                               sample_size=None):
    """:func:`mine_hard_examples` over leading axes."""
    p = neg_loss.shape[-1]
    pos = match_indices >= 0
    num_pos = pos.sum(-1)
    cap = sample_size if sample_size is not None else p
    num_neg = torch.clamp((neg_pos_ratio * num_pos).to(torch.int32),
                          max=cap)
    return topk_mask(~pos & torch.isfinite(neg_loss), neg_loss, num_neg)


@register_op("mine_hard_examples")
def mine_hard_examples(neg_loss, match_indices, *, neg_pos_ratio=3.0,
                       sample_size=None):
    """Hard-negative mining, ``max_negative`` mode
    (``mine_hard_examples_op``): the ``neg_pos_ratio * num_pos`` unmatched
    priors of highest candidate loss. Returns bool (P,)."""
    return mine_hard_examples_batched(neg_loss, match_indices,
                                      neg_pos_ratio=neg_pos_ratio,
                                      sample_size=sample_size)


@register_op("ssd_loss")
def ssd_loss(loc_pred, conf_pred, anchors, gt_boxes, gt_labels, gt_mask, *,
             background_label=0, overlap_threshold=0.5, neg_pos_ratio=3.0,
             loc_weight=1.0, conf_weight=1.0,
             variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBox SSD loss (``layers/detection.py`` ``ssd_loss``): match,
    encode, smooth-L1 on the positives plus softmax CE on the positives
    and the mined hard negatives, over the matched count per image.
    loc_pred (B, P, 4), conf_pred (B, P, C) (class 0 the background),
    anchors (P, 4) normalised xyxy, gt_boxes (B, G, 4) normalised xyxy
    (padded), gt_labels (B, G), gt_mask (B, G). Returns the mean over
    images."""
    from paddle_tpu_torch.ops.nn import smooth_l1
    iou = box_iou(gt_boxes, anchors)                         # (B, G, P)
    m_idx, _ = match_boxes(iou, gt_mask, overlap_threshold=overlap_threshold)
    pos = m_idx >= 0
    safe = torch.clamp(m_idx, min=0).long()
    tgt_boxes, _ = target_assign(gt_boxes, m_idx)
    loc_t = box_encode(tgt_boxes, anchors, variances).detach()
    loc_l = smooth_l1(loc_pred, loc_t).sum(-1) * pos
    cls_t = torch.where(pos, torch.gather(gt_labels.long(), -1, safe),
                        background_label)
    logp = torch.log_softmax(conf_pred.float(), -1)
    ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
    neg = mine_hard_examples_batched(-logp[..., background_label], m_idx,
                                     neg_pos_ratio=neg_pos_ratio)
    conf_l = ce * (pos | neg)
    n_match = torch.clamp(pos.sum(-1), min=1)
    per_image = (loc_weight * loc_l.sum(-1)
                 + conf_weight * conf_l.sum(-1)) / n_match
    return per_image.mean()


@register_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logits, labels, *, gamma=2.0, alpha=0.25,
                       normalizer=None):
    """Focal loss (``sigmoid_focal_loss_op``, RetinaNet): logits (N, C),
    labels (N,) in [0, C] with 0 the background and class k in column k -
    1. Returns the (N, C) loss, over ``normalizer`` where given."""
    c = logits.shape[1]
    t = (labels[:, None] == torch.arange(1, c + 1, device=logits.device)
         [None, :]).to(logits.dtype)
    p = torch.sigmoid(logits)
    bce = _stable_bce(logits, t)
    p_t = p * t + (1.0 - p) * (1.0 - t)
    a_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = a_t * (1.0 - p_t) ** gamma * bce
    if isinstance(normalizer, torch.Tensor):
        loss = loss / torch.clamp(normalizer, min=1.0)
    elif normalizer is not None:
        loss = loss / max(float(normalizer), 1.0)
    return loss


def _wh_iou(wh1, wh2):
    inter = torch.minimum(wh1[..., 0], wh2[..., 0]) * \
        torch.minimum(wh1[..., 1], wh2[..., 1])
    return inter / torch.clamp(
        wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter,
        min=1e-10)


@register_op("yolov3_loss")
def yolov3_loss(x, gt_boxes, gt_labels, gt_mask, *, anchors, anchor_mask,
                class_num, ignore_thresh=0.7, downsample_ratio=32):
    """YOLOv3 loss of one head (``yolov3_loss_op``): x (B, A * (5 + C), H,
    W) NCHW, A = len(anchor_mask); ``anchors`` the full pixel anchor list;
    gt_boxes (B, G, 4) normalised (cx, cy, w, h); gt_labels (B, G);
    gt_mask (B, G). Each ground truth's cell is (floor(cx W), floor(cy
    H)) and its anchor the best wh-IoU of the full set, counted only if
    this head owns it (a later ground truth in the same cell and anchor
    overwrites an earlier one, as the reference's loop does);
    objectness negatives are the cells whose best predicted-box IoU with
    any ground truth stays below ``ignore_thresh``. Returns the mean
    over images."""
    b, _, h, w = x.shape
    a, c = len(anchor_mask), class_num
    g = gt_boxes.shape[1]
    dev = x.device
    full = _const([tuple(a) for a in anchors], dev)
    own = _const(list(anchor_mask), dev, torch.long)
    head_wh = full[own]
    in_w, in_h = w * downsample_ratio, h * downsample_ratio
    head = x.reshape(b, a, 5 + c, h, w).permute(0, 3, 4, 1, 2)

    # predicted boxes (normalised) for the ignore mask
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
    px = (torch.sigmoid(head[..., 0]) + grid_x) / w
    py = (torch.sigmoid(head[..., 1]) + grid_y) / h
    pw = torch.exp(torch.clamp(head[..., 2], -10, 10)) * head_wh[:, 0] / in_w
    ph = torch.exp(torch.clamp(head[..., 3], -10, 10)) * head_wh[:, 1] / in_h
    pred = torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2],
                       -1)
    gt_xyxy = torch.cat([gt_boxes[..., :2] - gt_boxes[..., 2:] / 2,
                         gt_boxes[..., :2] + gt_boxes[..., 2:] / 2], -1)
    ious = box_iou(pred.reshape(b, -1, 4), gt_xyxy)          # (B, HWA, G)
    ious = torch.where(gt_mask[:, None, :], ious, 0.0)
    ignore = (ious.amax(-1) >= ignore_thresh).reshape(b, h, w, a)

    # per ground truth, its (cell, anchor) targets, in order
    cells = h * w * a
    ar = torch.arange(cells, device=dev)
    t_obj = torch.zeros(b, cells, device=dev)
    t_xy = torch.zeros(b, cells, 2, device=dev)
    t_wh = torch.zeros(b, cells, 2, device=dev)
    t_cls = torch.zeros(b, cells, c, device=dev)
    t_scale = torch.zeros(b, cells, device=dev)
    in_wh = _const([float(in_w), float(in_h)], dev)
    classes = torch.arange(c, device=dev)
    for i in range(g):
        box = gt_boxes[:, i]
        gi = torch.clamp((box[:, 0] * w).to(torch.int32), 0, w - 1)
        gj = torch.clamp((box[:, 1] * h).to(torch.int32), 0, h - 1)
        gt_wh_pix = box[:, 2:] * in_wh
        best = torch.argmax(_wh_iou(full[None], gt_wh_pix[:, None]), dim=-1)
        owned = own[None, :] == best[:, None]
        ai = torch.argmax(owned.to(torch.int32), dim=-1)
        use = gt_mask[:, i] & owned.any(-1) & (box[:, 2] > 0) & \
            (box[:, 3] > 0)
        tx = box[:, 0] * w - gi
        ty = box[:, 1] * h - gj
        twh = torch.log(torch.clamp(
            gt_wh_pix / torch.clamp(full[best], min=1e-10), min=1e-10))
        scale = 2.0 - box[:, 2] * box[:, 3]
        onehot = (classes[None, :] == gt_labels[:, i, None]).float()
        cell = (gj.long() * w + gi.long()) * a + ai
        sel = (ar[None, :] == cell[:, None]) & use[:, None]    # (B, cells)
        t_obj = torch.where(sel, 1.0, t_obj)
        t_xy = torch.where(sel[..., None], torch.stack([tx, ty], -1)
                           [:, None, :], t_xy)
        t_wh = torch.where(sel[..., None], twh[:, None, :], t_wh)
        t_cls = torch.where(sel[..., None], onehot[:, None, :], t_cls)
        t_scale = torch.where(sel, scale[:, None], t_scale)

    head = head.reshape(b, cells, 5 + c)
    pos = t_obj > 0
    sc = t_scale * pos
    loss_xy = (_stable_bce(head[..., 0:2], t_xy).sum(-1) * sc).sum(-1)
    loss_wh = ((head[..., 2:4] - t_wh).abs().sum(-1) * sc).sum(-1)
    obj = head[..., 4]
    loss_obj = (_stable_bce(obj, 1.0) * pos).sum(-1) + (
        _stable_bce(obj, 0.0) * (~pos & ~ignore.reshape(b, cells))).sum(-1)
    loss_cls = (_stable_bce(head[..., 5:], t_cls).sum(-1) * pos).sum(-1)
    return (loss_xy + loss_wh + loss_obj + loss_cls).mean()


def _forced_and_best(iou, gt_mask):
    """Per anchor its best ground truth and IoU, and the anchors forced to
    foreground as some ground truth's best (ties included; only for a
    ground truth that overlaps something)."""
    best_iou = iou.amax(dim=0)
    best_gt = torch.argmax(iou, dim=0)
    gt_best = torch.where(gt_mask[:, None], iou, _NEG_INF).amax(dim=1)
    forced = ((iou >= gt_best[:, None]) & gt_mask[:, None]
              & (gt_best[:, None] > 0)).any(0)
    return best_gt, best_iou, forced


def _uniform(p, generator, device):
    if generator is None:
        return torch.zeros(p, device=device)
    return torch.rand(p, generator=generator, device=device)


@register_op("rpn_target_assign")
def rpn_target_assign(anchors, gt_boxes, gt_mask, *, im_shape=None,
                      pos_threshold=0.7, neg_threshold=0.3,
                      batch_size_per_im=256, fg_fraction=0.5,
                      variances=(1.0, 1.0, 1.0, 1.0), generator=None):
    """RPN anchor labelling (``rpn_target_assign_op``): 1 at IoU >=
    ``pos_threshold`` or as a ground truth's best anchor, 0 below
    ``neg_threshold``, -1 between; anchors straddling the image (with
    ``im_shape``) stay -1. At most ``fg_fraction * batch_size_per_im``
    foregrounds and the rest backgrounds, the hardest first, or at random
    with ``generator``. Returns (labels (P,) int32, bbox_targets (P, 4),
    fg, bg)."""
    p = anchors.shape[0]
    inside = None
    if im_shape is not None:
        h, w = im_shape[0], im_shape[1]
        inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
                  & (anchors[:, 2] <= w - 1) & (anchors[:, 3] <= h - 1))
    iou = box_iou(gt_boxes, anchors)
    iou = torch.where(gt_mask[:, None], iou, -1.0)
    if inside is not None:
        iou = torch.where(inside[None, :], iou, -1.0)
    best_gt, best_iou, forced = _forced_and_best(iou, gt_mask)
    fg = forced | (best_iou >= pos_threshold)
    bg = (~fg) & (best_iou < neg_threshold)
    rand = _uniform(p, generator, anchors.device)
    if inside is not None:
        fg = fg & inside
        bg = bg & inside
    fg = topk_mask(fg, best_iou + rand, int(batch_size_per_im * fg_fraction))
    bg = topk_mask(bg, -best_iou + rand, batch_size_per_im - fg.sum())
    labels = torch.where(fg, 1, torch.where(bg, 0, -1)).to(torch.int32)
    tgt = box_encode(gt_boxes[best_gt], anchors, variances)
    tgt = torch.where(fg[:, None], tgt, 0.0)
    return labels, tgt, fg, bg


@register_op("generate_proposals")
def generate_proposals(scores, deltas, anchors, im_shape, *,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.7, min_size=0.0,
                       variances=(1.0, 1.0, 1.0, 1.0)):
    """RPN proposals of one image (``generate_proposals_op``): decode,
    clip, drop the tiny, top-k before NMS, NMS, top-k after. scores (P,),
    deltas (P, 4), anchors (P, 4) pixel xyxy, im_shape (h, w). Returns
    (rois (post, 4), scores (post,), -inf where invalid, valid)."""
    p = scores.shape[0]
    boxes = box_clip(box_decode(deltas, anchors, variances), im_shape)
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    keep = (ws >= min_size) & (hs >= min_size)
    s = torch.where(keep, scores, _NEG_INF)
    k = min(pre_nms_top_n, p)
    top_s, order = _top_k(s, k)
    cand = boxes[order]
    idxs, valid = nms(cand, top_s, iou_threshold=nms_thresh,
                      score_threshold=_NEG_INF,
                      max_outputs=min(post_nms_top_n, k))
    rois = cand[idxs]
    roi_scores = torch.where(valid, top_s[idxs], _NEG_INF)
    valid = valid & torch.isfinite(roi_scores)
    pad = post_nms_top_n - idxs.shape[0]
    if pad > 0:
        rois = torch.cat([rois, rois.new_zeros(pad, 4)])
        roi_scores = _pad_last(roi_scores, post_nms_top_n, _NEG_INF)
        valid = _pad_last(valid, post_nms_top_n, False)
    return rois, torch.where(valid, roi_scores, _NEG_INF), valid


@register_op("distribute_fpn_proposals")
def distribute_fpn_proposals(rois, *, min_level=2, max_level=5,
                             refer_level=4, refer_scale=224):
    """RoIs to FPN levels (``distribute_fpn_proposals_op``): level =
    clip(floor(refer_level + log2(sqrt(area) / refer_scale))). Returns
    (level (N,) int32, masks (L, N) bool)."""
    ws = torch.clamp(rois[:, 2] - rois[:, 0], min=0.0)
    hs = torch.clamp(rois[:, 3] - rois[:, 1], min=0.0)
    scale = torch.sqrt(ws * hs)
    lvl = torch.floor(refer_level + torch.log2(
        torch.clamp(scale, min=1e-6) / refer_scale))
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    levels = torch.arange(min_level, max_level + 1, device=rois.device)
    return lvl, lvl[None, :] == levels[:, None]


@register_op("collect_fpn_proposals")
def collect_fpn_proposals(rois_list, scores_list, valid_list=None, *,
                          post_nms_top_n=1000):
    """Merge per-level proposals and keep the global top-k by score
    (``collect_fpn_proposals_op``). Returns (rois (k, 4), scores (k,),
    valid (k,))."""
    rois = torch.cat(list(rois_list), 0)
    scores = torch.cat(list(scores_list), 0)
    if valid_list is not None:
        scores = torch.where(torch.cat(list(valid_list), 0), scores,
                             _NEG_INF)
    k = min(post_nms_top_n, scores.shape[0])
    top_s, order = _top_k(scores, k)
    out_r = rois[order]
    pad = post_nms_top_n - k
    if pad > 0:
        out_r = torch.cat([out_r, out_r.new_zeros(pad, 4)])
        top_s = _pad_last(top_s, post_nms_top_n, _NEG_INF)
    return out_r, top_s, torch.isfinite(top_s)


@register_op("polygon_box_transform")
def polygon_box_transform(x):
    """EAST's quad offsets to absolute coordinates
    (``polygon_box_transform_op``): x (B, 8, H, W) on a 4x-downsampled
    grid; even channels ``4 * w_index - x``, odd ``4 * h_index - x``."""
    b, c, h, w = x.shape
    xi = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    yi = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return torch.where(is_x, xi * 4.0 - x, yi * 4.0 - x)


@register_op("retinanet_detection_output")
def retinanet_detection_output(boxes_list, scores_list, anchors_list,
                               im_shape, *, score_threshold=0.05,
                               nms_top_k=1000, keep_top_k=100,
                               nms_threshold=0.5,
                               variances=(1.0, 1.0, 1.0, 1.0)):
    """RetinaNet decoding and multiclass NMS across FPN levels
    (``retinanet_detection_output_op``), one image. Returns (boxes (K, 4),
    cls (K,), scores (K,), valid (K,)), K = keep_top_k."""
    decoded = [box_clip(box_decode(d, a, variances), im_shape)
               for d, a in zip(boxes_list, anchors_list)]
    boxes = torch.cat(decoded, 0)
    scores = torch.cat(list(scores_list), 0)
    k = min(nms_top_k, scores.shape[0])
    _, sel = _top_k(scores.amax(dim=1), k)
    boxes, scores = boxes[sel], scores[sel]
    cls_ids, idxs, valid = multiclass_nms(
        boxes, scores, iou_threshold=nms_threshold,
        score_threshold=score_threshold, max_per_class=max(1, keep_top_k))
    sel_scores = torch.where(valid, scores[idxs, cls_ids], _NEG_INF)
    top_s, order = _top_k(sel_scores, min(keep_top_k, sel_scores.shape[0]))
    ok = torch.isfinite(top_s)
    return (boxes[idxs[order]], cls_ids[order], torch.where(ok, top_s, 0.0),
            ok)


@register_op("detection_output")
def detection_output(loc, conf, anchors, *, score_threshold=0.01,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     variances=(0.1, 0.1, 0.2, 0.2), background_label=0):
    """SSD post-processing (``layers.detection_output``): decode, per-class
    NMS (each class capped at ``nms_top_k``), global top-k. loc (B, P,
    4), conf (B, P, C) logits. Returns per image (boxes (B, K, 4), cls,
    scores, valid)."""
    boxes = box_decode(loc, anchors, variances)
    probs = torch.softmax(conf.float(), -1)
    fg = torch.cat([probs[..., :background_label],
                    probs[..., background_label + 1:]], -1)
    per = max(1, min(nms_top_k, boxes.shape[1]))
    cls_ids, idxs, valid = multiclass_nms_batched(
        boxes, fg, iou_threshold=nms_threshold,
        score_threshold=score_threshold, max_per_class=per)
    sel = torch.where(valid, score_at(fg, idxs, cls_ids), _NEG_INF)
    top_s, order = _top_k(sel, min(keep_top_k, sel.shape[-1]))
    ok = torch.isfinite(top_s)
    cls = cls_ids[order]
    cls = torch.where(cls >= background_label, cls + 1, cls)
    out_boxes = take_rows(boxes, torch.gather(idxs, -1, order))
    return out_boxes, cls, torch.where(ok, top_s, 0.0), ok


@register_op("box_decoder_and_assign")
def box_decoder_and_assign(prior_box, deltas, scores, *,
                           variances=(0.1, 0.1, 0.2, 0.2),
                           box_clip_value=4.135):
    """``box_decoder_and_assign_op`` (Cascade R-CNN): decode per-class
    deltas (P, C * 4) against ``prior_box`` (P, 4) and pick each prior's
    best-scoring class box. Returns (decoded (P, C, 4), assigned (P,
    4))."""
    p, c4 = deltas.shape
    c = c4 // 4
    d = deltas.reshape(p, c, 4)
    d = torch.cat([d[..., :2], torch.clamp(d[..., 2:], -box_clip_value,
                                           box_clip_value)], -1)
    decoded = box_decode(d, prior_box[:, None, :], variances)
    best = torch.argmax(scores[:, :c], dim=-1)
    assigned = torch.gather(decoded, 1, best[:, None, None].expand(
        -1, 1, 4))[:, 0]
    return decoded, assigned


@register_op("retinanet_target_assign")
def retinanet_target_assign(anchors, gt_boxes, gt_labels, gt_mask, *,
                            positive_overlap=0.5, negative_overlap=0.4,
                            variances=(1.0, 1.0, 1.0, 1.0)):
    """``retinanet_target_assign_op``: the ground truth's class (>= 1) at
    IoU >= ``positive_overlap`` or as a ground truth's best anchor, 0
    below ``negative_overlap``, -1 between. Returns (cls_targets (P,),
    bbox_targets (P, 4), fg, fg count)."""
    iou = torch.where(gt_mask[:, None], box_iou(gt_boxes, anchors), -1.0)
    best_gt, best_iou, forced = _forced_and_best(iou, gt_mask)
    fg = forced | (best_iou >= positive_overlap)
    bg = (~fg) & (best_iou < negative_overlap)
    cls = torch.where(fg, gt_labels[best_gt].long(),
                      torch.where(bg, 0, -1)).to(torch.int32)
    tgt = box_encode(gt_boxes[best_gt], anchors, variances)
    tgt = torch.where(fg[:, None], tgt, 0.0)
    return cls, tgt, fg, fg.sum()


def _bilinear_sample(img, ys, xs):
    """``img`` (H, W, C) or (B, H, W, C) read at float coordinates ``ys``
    / ``xs`` (any shape, with the batch axis in front for a batched
    image): bilinear, zero outside the map."""
    batched = img.ndim == 4
    if not batched:
        img, ys, xs = img[None], ys[None], xs[None]
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    yi0 = y0.long()
    xi0 = x0.long()

    def at(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (torch.clamp(yi, 0, h - 1) * w
               + torch.clamp(xi, 0, w - 1)).reshape(b, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        v = v.reshape(*yi.shape, c)
        return torch.where(inb[..., None], v, 0.0)

    out = (at(yi0, xi0) * ((1 - wy) * (1 - wx))[..., None]
           + at(yi0, xi0 + 1) * ((1 - wy) * wx)[..., None]
           + at(yi0 + 1, xi0) * (wy * (1 - wx))[..., None]
           + at(yi0 + 1, xi0 + 1) * (wy * wx)[..., None])
    return out if batched else out[0]


@register_op("psroi_pool")
def psroi_pool(features, rois, *, output_size=7, spatial_scale=1.0,
               output_channels=None):
    """Position-sensitive RoI pooling (``psroi_pool_op``, R-FCN): the
    channels are k * k groups of D and bin (i, j) average-pools only its
    own group. features (H, W, k * k * D), rois (R, 4) -> (R, k, k, D)."""
    k = output_size
    h, w, c = features.shape
    d = output_channels or c // (k * k)
    dev = features.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    x1, y1, x2, y2 = (rois * spatial_scale).unbind(-1)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    ii = torch.arange(k, dtype=torch.float32, device=dev)
    y_lo = y1[:, None] + ii * rh[:, None] / k
    y_hi = y1[:, None] + (ii + 1) * rh[:, None] / k
    x_lo = x1[:, None] + ii * rw[:, None] / k
    x_hi = x1[:, None] + (ii + 1) * rw[:, None] / k
    in_y = (ys >= y_lo[..., None]) & (ys < y_hi[..., None])    # (R, k, H)
    in_x = (xs >= x_lo[..., None]) & (xs < x_hi[..., None])    # (R, k, W)
    m = in_y[:, :, None, :, None] & in_x[:, None, :, None, :]  # R,k,k,H,W
    grp = features[..., :k * k * d].reshape(h, w, k, k, d).permute(
        2, 3, 0, 1, 4)                                          # k,k,H,W,D
    s = (grp[None] * m[..., None]).sum(dim=(3, 4))
    return s / torch.clamp(m.sum(dim=(3, 4)), min=1.0)[..., None]


@register_op("prroi_pool")
def prroi_pool(features, rois, *, output_size=(7, 7), spatial_scale=1.0,
               samples_per_bin=4):
    """Precise RoI pooling (``prroi_pool_op``), the bin's integral of the
    bilinear feature approximated, as the reference does, by a
    ``samples_per_bin``^2 grid of bilinear samples (zero outside the
    map); differentiable in the RoI's corners too."""
    oh, ow = output_size
    sp = samples_per_bin
    dev = features.device
    x1, y1, x2, y2 = (rois * spatial_scale).unbind(-1)
    bw = (x2 - x1) / ow
    bh = (y2 - y1) / oh
    ys = y1[:, None] + (torch.arange(oh * sp, dtype=torch.float32,
                                     device=dev) + 0.5) * bh[:, None] / sp
    xs = x1[:, None] + (torch.arange(ow * sp, dtype=torch.float32,
                                     device=dev) + 0.5) * bw[:, None] / sp
    r = rois.shape[0]
    gy = ys[:, :, None] * torch.ones_like(xs)[:, None, :]
    gx = torch.ones_like(ys)[:, :, None] * xs[:, None, :]
    grid = _bilinear_sample(features.expand(r, *features.shape), gy, gx)
    return grid.reshape(r, oh, sp, ow, sp, -1).mean(dim=(2, 4))


@register_op("deformable_conv")
def deformable_conv(x, offset, weight, *, stride=1, padding=0, mask=None):
    """Deformable conv v1/v2 (``deformable_conv_op``): each kernel tap
    reads the input at its grid position plus a learned (dy, dx),
    bilinear; v2 scales each tap by ``mask``. x (B, H, W, Cin), offset
    (B, Ho, Wo, 2 * kh * kw), weight HWIO (kh, kw, Cin, Cout), mask (B,
    Ho, Wo, kh * kw) or None; one group, NHWC."""
    kh, kw, _, _ = weight.shape
    s = stride if isinstance(stride, tuple) else (stride, stride)
    p = padding if isinstance(padding, tuple) else (padding, padding)
    _, h, w, _ = x.shape
    ho = (h + 2 * p[0] - kh) // s[0] + 1
    wo = (w + 2 * p[1] - kw) // s[1] + 1
    base_y = (torch.arange(ho, device=x.device) * s[0] - p[0]).to(x.dtype)
    base_x = (torch.arange(wo, device=x.device) * s[1] - p[1]).to(x.dtype)
    out = 0
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            ys = base_y[:, None] + i + offset[..., 2 * t]
            xs = base_x[None, :] + j + offset[..., 2 * t + 1]
            v = _bilinear_sample(x, ys, xs)
            if mask is not None:
                v = v * mask[..., t][..., None]
            out = out + v @ weight[i, j]
    return out


@register_op("generate_proposal_labels")
def generate_proposal_labels(rois, roi_valid, gt_boxes, gt_labels,
                             gt_mask, *, batch_size_per_im=64,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             variances=(0.1, 0.1, 0.2, 0.2), generator=None,
                             return_matches=False):
    """R-CNN second-stage sampling (``generate_proposal_labels_op``), one
    image: label each proposal by its best ground truth, keep
    ``batch_size_per_im`` with ``fg_fraction`` foregrounds (the hardest,
    or at random with ``generator``), targets for the kept. Returns
    (labels (P,) int32, -1 not sampled; bbox_targets (P, 4); fg; bg), and
    the matched ground truth per proposal with ``return_matches``."""
    p = rois.shape[0]
    iou = box_iou(gt_boxes, rois)
    iou = torch.where(gt_mask[:, None] & roi_valid[None, :], iou, -1.0)
    best_iou = iou.amax(dim=0)
    best_gt = torch.argmax(iou, dim=0)
    fg = best_iou >= fg_thresh
    bg = (~fg) & (best_iou < bg_thresh_hi) & (best_iou >= bg_thresh_lo) \
        & roi_valid
    rand = _uniform(p, generator, rois.device)
    fg = topk_mask(fg, best_iou + rand, int(batch_size_per_im * fg_fraction))
    bg = topk_mask(bg, -best_iou + rand, batch_size_per_im - fg.sum())
    labels = torch.where(fg, gt_labels[best_gt].long(),
                         torch.where(bg, 0, -1)).to(torch.int32)
    tgt = box_encode(gt_boxes[best_gt], rois, variances)
    tgt = torch.where(fg[:, None], tgt, 0.0)
    if return_matches:
        return labels, tgt, fg, bg, best_gt
    return labels, tgt, fg, bg


@register_op("roi_perspective_transform")
def roi_perspective_transform(features, rois, *, output_size=(8, 8),
                              spatial_scale=1.0):
    """``roi_perspective_transform_op`` (EAST OCR): quadrilateral RoIs
    (R, 8), corners clockwise from the top left, rectified into (oh, ow)
    patches by a homography per RoI (solved with a 1e-6 Tikhonov guard)
    and bilinear sampling; differentiable in the features and corners."""
    oh, ow = output_size
    dev = features.device
    r = rois.shape[0]
    src = _const([[0.0, 0.0], [ow - 1.0, 0.0], [ow - 1.0, oh - 1.0],
                  [0.0, oh - 1.0]], dev)
    dst = (rois * spatial_scale).reshape(r, 4, 2)
    zeros = torch.zeros(r, device=dev)
    ones = torch.ones(r, device=dev)
    rows, rhs = [], []
    for k in range(4):
        sx, sy = src[k, 0].expand(r), src[k, 1].expand(r)
        dx, dy = dst[:, k, 0], dst[:, k, 1]
        rows.append(torch.stack([sx, sy, ones, zeros, zeros, zeros,
                                 -sx * dx, -sy * dx], -1))
        rows.append(torch.stack([zeros, zeros, zeros, sx, sy, ones,
                                 -sx * dy, -sy * dy], -1))
        rhs.extend([dx, dy])
    a = torch.stack(rows, 1) + 1e-6 * torch.eye(8, device=dev)
    hom = torch.linalg.solve(a, torch.stack(rhs, -1))
    hom = torch.cat([hom, ones[:, None]], -1).reshape(r, 3, 3)
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], -1)      # (oh, ow, 3)
    mapped = grid @ hom.transpose(1, 2)[:, None]                # R,oh,ow,3
    den = torch.clamp(mapped[..., 2].abs(), min=1e-8)
    sign = torch.sign(mapped[..., 2])
    xs = mapped[..., 0] / den * sign
    ys = mapped[..., 1] / den * sign
    return _bilinear_sample(features.expand(r, *features.shape), ys, xs)


@register_op("generate_mask_labels")
def generate_mask_labels(rois, match_gt, fg_mask, gt_masks, *,
                         resolution=14, im_size):
    """Mask R-CNN's mask targets (``generate_mask_labels_op``): each
    foreground RoI's matched instance mask (G, Hm, Hm binary rasters at
    image scale) cropped to the RoI by RoIAlign to (resolution,
    resolution) and thresholded at 0.5. Returns (targets (R, res, res),
    zero rows for non-foreground; weights (R,))."""
    _, mh, mw = gt_masks.shape
    if mh != mw:
        raise ValueError(
            f"gt_masks must be square rasters, got {(mh, mw)}; "
            "resample masks (or store at image aspect) upstream")
    picked = gt_masks[torch.clamp(match_gt, min=0).long()].float()
    patch = roi_align_flat(picked.reshape(-1, mh * mw, 1), mh, mw, rois,
                           (resolution, resolution), mh / im_size, 2)[..., 0]
    targets = torch.where(fg_mask[:, None, None], (patch >= 0.5).float(),
                          torch.zeros_like(patch))
    return targets, fg_mask.float()


@register_op("deformable_roi_pooling")
def deformable_roi_pooling(features, rois, offsets=None, *,
                           output_size=(7, 7), spatial_scale=1.0,
                           gamma=0.1):
    """Deformable RoI pooling (``deformable_roi_pooling_op``): each bin's
    centre, read bilinearly (zero outside), moves by a learned normalised
    offset times ``gamma`` and the RoI's size. features (H, W, C), rois
    (R, 4), offsets (R, oh, ow, 2) [dy, dx] or None -> (R, oh, ow, C)."""
    oh, ow = output_size
    dev = features.device
    r = rois.shape[0]
    x1, y1, x2, y2 = (rois * spatial_scale).unbind(-1)
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    cy = y1[:, None] + (torch.arange(oh, dtype=torch.float32, device=dev)
                        + 0.5) * (rh / oh)[:, None]
    cx = x1[:, None] + (torch.arange(ow, dtype=torch.float32, device=dev)
                        + 0.5) * (rw / ow)[:, None]
    gy = cy[:, :, None].expand(r, oh, ow)
    gx = cx[:, None, :].expand(r, oh, ow)
    if offsets is not None:
        gy = gy + gamma * rh[:, None, None] * offsets[..., 0]
        gx = gx + gamma * rw[:, None, None] * offsets[..., 1]
    return _bilinear_sample(features.expand(r, *features.shape), gy, gx)

