"""Streaming metrics (``paddle_tpu/metrics.py``, fluid ``metrics.py``):
``Accuracy``, ``Auc``, ``MeanMetric``, ``ChunkEvaluator``,
``PrecisionRecall``, ``EditDistance``, ``DetectionMAP`` and
``CompositeMetric``.

The accumulators live on the host in float64, as the reference's. An
``update`` takes tensors on any device (or numpy arrays) and reads from
the device once: where the reference computes its statistics in a form
that traces (``Accuracy``'s and ``PrecisionRecall``'s counts, ``Auc``'s
histogram over the thresholds), the port computes them on the tensor's
own device and copies the small result back; the sequence and detection
metrics, whose work is per-sequence or per-image Python in the reference
too, copy their inputs to the host once and run there. ``eval`` gives
the reference's numbers up to float64 rounding.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, a numpy array or a list) as a numpy
    array: one copy from the device for a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x))


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """``np.trapezoid(y, x)`` (spelled out: older numpy calls it
    ``trapz``)."""
    d = np.diff(x)
    return float((d * (y[1:] + y[:-1]) / 2.0).sum())


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(Metric):
    """Streaming top-1 accuracy (fluid ``metrics.Accuracy``): ``preds``
    (B,) class ids or (B, C) scores (argmax), ``labels`` (B,) or (B, 1).
    The count of hits is taken on the predictions' device."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._correct = 0.0
        self._total = 0.0

    def update(self, preds, labels):
        preds = _tensor(preds)
        labels = _tensor(labels).to(preds.device).reshape(
            preds.shape[0], -1)[:, 0]
        if preds.ndim > 1:
            preds = preds.argmax(-1)
        self._correct += float((preds == labels).sum())
        self._total += preds.shape[0]
        return self

    def eval(self) -> float:
        return self._correct / max(self._total, 1.0)


class Auc(Metric):
    """Streaming ROC-AUC over ``num_thresholds + 1`` bins of the predicted
    probability (fluid ``metrics.Auc`` and the ``auc`` op): a positive
    and a negative histogram, counted on the probabilities' device
    (``torch.bincount``) and added into float64 host bins; ``eval``
    integrates the ROC curve from the origin by the trapezoid rule."""

    def __init__(self, num_thresholds: int = 4095):
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1)
        self._neg = np.zeros(self.num_thresholds + 1)

    def update(self, probs, labels):
        probs = _tensor(probs).reshape(-1)
        labels = _tensor(labels).to(probs.device).reshape(-1)
        n = self.num_thresholds
        # truncation toward zero in the probabilities' dtype, as numpy's
        # astype(int64) of the reference
        idx = torch.clamp((probs * n).to(torch.int64), 0, n)
        pos = labels > 0.5
        hist = torch.stack([
            torch.bincount(idx[pos], minlength=n + 1),
            torch.bincount(idx[~pos], minlength=n + 1)])
        hist = hist.cpu().numpy()
        self._pos += hist[0]
        self._neg += hist[1]
        return self

    def eval(self) -> float:
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p == 0 or tot_n == 0:
            return 0.5
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        return _trapezoid(tpr, fpr)


class MeanMetric(Metric):
    """Running mean of a scalar stream (loss trackers)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._n = 0

    def update(self, value, weight: float = 1.0):
        self._sum += float(_host(value)) * weight
        self._n += weight
        return self

    def eval(self) -> float:
        return self._sum / max(self._n, 1e-12)


class ChunkEvaluator(Metric):
    """Chunking F1 for sequence labelling (fluid ``ChunkEvaluator`` and the
    ``chunk_eval`` op). IOB tags: ``tag = chunk_type * 2 + {0: B, 1: I}``,
    ``num_chunk_types * 2`` is "outside". ``update(infer_tags,
    label_tags, lengths=None)`` over (B, T) or (T,) tags."""

    def __init__(self, num_chunk_types: int):
        self.num_chunk_types = num_chunk_types
        self.reset()

    def reset(self):
        self.num_infer = 0.0
        self.num_label = 0.0
        self.num_correct = 0.0

    @staticmethod
    def extract_chunks(tags, num_chunk_types) -> List[Tuple[int, int, int]]:
        """``[(start, end, type), ...]`` from an IOB tag sequence."""
        chunks = []
        start = ctype = None
        outside = num_chunk_types * 2
        tags = [int(t) for t in _host(tags).reshape(-1)]
        for i, t in enumerate(tags + [outside]):
            is_begin = t < outside and t % 2 == 0
            is_inside = t < outside and t % 2 == 1
            cur_type = t // 2 if t < outside else None
            if start is not None and (not is_inside or cur_type != ctype):
                chunks.append((start, i, ctype))
                start = ctype = None
            if is_begin:
                start, ctype = i, cur_type
        return chunks

    def update(self, infer_tags, label_tags, lengths=None):
        infer_tags = _host(infer_tags)
        label_tags = _host(label_tags)
        lengths = None if lengths is None else _host(lengths)
        if infer_tags.ndim == 1:
            infer_tags = infer_tags[None]
            label_tags = label_tags[None]
        for i in range(infer_tags.shape[0]):
            n = (int(lengths[i]) if lengths is not None
                 else infer_tags.shape[1])
            inf = set(self.extract_chunks(infer_tags[i, :n],
                                          self.num_chunk_types))
            lab = set(self.extract_chunks(label_tags[i, :n],
                                          self.num_chunk_types))
            self.num_infer += len(inf)
            self.num_label += len(lab)
            self.num_correct += len(inf & lab)
        return self

    def eval(self) -> Dict[str, float]:
        return _prf(self.num_correct, self.num_infer, self.num_label)


def _prf(correct, predicted, actual) -> Dict[str, float]:
    p = correct / max(predicted, 1e-12)
    r = correct / max(actual, 1e-12)
    return {"precision": p, "recall": r,
            "f1": 2 * p * r / max(p + r, 1e-12)}


class PrecisionRecall(Metric):
    """Binary precision, recall and F1 at ``threshold`` (fluid
    ``metrics.Precision``/``Recall``); the true-positive, false-positive
    and false-negative counts are taken on the probabilities' device."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.tp = self.fp = self.fn = 0.0

    def update(self, probs, labels):
        probs = _tensor(probs).reshape(-1)
        labels = _tensor(labels).to(probs.device).reshape(-1) > 0.5
        pred = probs >= self.threshold
        tp, fp, fn = torch.stack([(pred & labels).sum(),
                                  (pred & ~labels).sum(),
                                  (~pred & labels).sum()]).tolist()
        self.tp += float(tp)
        self.fp += float(fp)
        self.fn += float(fn)
        return self

    def eval(self) -> Dict[str, float]:
        return _prf(self.tp, self.tp + self.fp, self.tp + self.fn)


class EditDistance(Metric):
    """Streaming mean Levenshtein distance (fluid ``metrics.EditDistance``,
    ``edit_distance_op``), normalised by the reference length when
    ``normalized``; also the share of sequences with a distance > 0."""

    def __init__(self, normalized: bool = True):
        self.normalized = normalized
        self.reset()

    def reset(self):
        self._dist = 0.0
        self._wrong = 0
        self._n = 0

    @staticmethod
    def levenshtein(a, b) -> int:
        a = list(_host(a).reshape(-1))
        b = list(_host(b).reshape(-1))
        if not a:
            return len(b)
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]

    def update(self, hyps, refs, hyp_lengths=None, ref_lengths=None):
        hyps = [_host(h) for h in hyps] if isinstance(hyps, (list, tuple)) \
            else _host(hyps)
        refs = [_host(r) for r in refs] if isinstance(refs, (list, tuple)) \
            else _host(refs)
        hyp_lengths = None if hyp_lengths is None else _host(hyp_lengths)
        ref_lengths = None if ref_lengths is None else _host(ref_lengths)
        for i, (h, r) in enumerate(zip(hyps, refs)):
            if hyp_lengths is not None:
                h = h[:int(hyp_lengths[i])]
            if ref_lengths is not None:
                r = r[:int(ref_lengths[i])]
            d = self.levenshtein(h, r)
            if self.normalized:
                d = d / max(len(r), 1)
            self._dist += d
            self._wrong += int(d > 0)
            self._n += 1
        return self

    def eval(self) -> Dict[str, float]:
        n = max(self._n, 1)
        return {"edit_distance": self._dist / n,
                "instance_error": self._wrong / n}


def _np_box_iou(a, b):
    """IoU of (N, 4) and (M, 4) xyxy boxes in numpy (one image's; the
    metric does not go back to the device per image)."""
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area1[:, None] + area2[None, :] - inter,
                              1e-10)


class DetectionMAP(Metric):
    """Mean average precision over detections (``detection_map_op`` and
    fluid ``metrics.DetectionMAP``). One ``update`` per image: the
    static-shape NMS outputs (``pred_*`` (K, ...) with a bool
    ``pred_valid``) and padded ground truths (``gt_*`` (G, ...) with a
    bool ``gt_mask``; ``gt_difficult`` marks boxes left out of the
    positive count, VOC's protocol), each copied to the host once. AP
    per class at ``eval``, "11point" or "integral", averaged over the
    classes that have ground truth."""

    def __init__(self, overlap_threshold: float = 0.5,
                 ap_version: str = "11point",
                 evaluate_difficult: bool = False):
        if ap_version not in ("11point", "integral"):
            raise ValueError(f"unknown ap_version {ap_version!r}")
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.evaluate_difficult = evaluate_difficult
        self.reset()

    def reset(self):
        self._records: Dict[int, list] = {}
        self._gt_count: Dict[int, int] = {}

    def update(self, pred_boxes, pred_scores, pred_classes, pred_valid,
               gt_boxes, gt_classes, gt_mask, gt_difficult=None):
        pv = _host(pred_valid).astype(bool)
        pb = _host(pred_boxes)[pv]
        ps = _host(pred_scores)[pv]
        pc = _host(pred_classes)[pv]
        gm = _host(gt_mask).astype(bool)
        gb = _host(gt_boxes)[gm]
        gc = _host(gt_classes)[gm]
        gd = (_host(gt_difficult)[gm].astype(bool)
              if gt_difficult is not None else np.zeros(len(gb), bool))

        for cls in np.unique(gc):
            n_easy = (int((~gd[gc == cls]).sum())
                      if not self.evaluate_difficult
                      else int((gc == cls).sum()))
            self._gt_count[int(cls)] = \
                self._gt_count.get(int(cls), 0) + n_easy

        iou = (_np_box_iou(pb.astype(np.float32), gb.astype(np.float32))
               if len(pb) and len(gb) else np.zeros((len(pb), len(gb))))
        order = np.argsort(-ps)
        taken = np.zeros(len(gb), bool)
        for i in order:
            cls = int(pc[i])
            rec = self._records.setdefault(cls, [])
            cand = np.where((gc == pc[i]) & ~taken)[0]
            if len(cand) and len(pb):
                j = cand[np.argmax(iou[i, cand])]
                if iou[i, j] >= self.overlap_threshold:
                    taken[j] = True
                    if gd[j] and not self.evaluate_difficult:
                        continue        # a difficult match: dropped
                    rec.append((float(ps[i]), 1))
                    continue
            rec.append((float(ps[i]), 0))
        return self

    def _ap(self, recs, n_gt) -> float:
        if not recs or n_gt == 0:
            return 0.0
        recs = sorted(recs, reverse=True)
        tp = np.cumsum([t for _, t in recs])
        fp = np.cumsum([1 - t for _, t in recs])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-12)
        if self.ap_version == "11point":
            ap = 0.0
            for r in np.linspace(0, 1, 11):
                mask = recall >= r
                ap += (precision[mask].max() if mask.any() else 0.0) / 11
            return float(ap)
        ap, prev_r = 0.0, 0.0
        for p, r in zip(precision, recall):
            ap += p * (r - prev_r)
            prev_r = r
        return float(ap)

    def eval(self) -> float:
        classes = [c for c, n in self._gt_count.items() if n > 0]
        if not classes:
            return 0.0
        return float(np.mean([self._ap(self._records.get(c, []),
                                       self._gt_count[c])
                              for c in classes]))


class CompositeMetric(Metric):
    """Metrics updated together (fluid ``metrics.CompositeMetric``)."""

    def __init__(self, *metrics):
        self._metrics = list(metrics)

    def add_metric(self, m):
        self._metrics.append(m)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, *args, **kwargs):
        for m in self._metrics:
            m.update(*args, **kwargs)
        return self

    def eval(self):
        return [m.eval() for m in self._metrics]


__all__ = ["Accuracy", "Auc", "ChunkEvaluator", "CompositeMetric",
           "DetectionMAP", "EditDistance", "MeanMetric", "Metric",
           "PrecisionRecall"]
