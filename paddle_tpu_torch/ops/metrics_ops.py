"""In-graph metric ops (``paddle_tpu/ops/metrics_ops.py``: ``auc_op``,
``precision_recall_op``). The statistics buffers are carried by the
caller: each op returns the updated ones beside the metric."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op

__all__ = ["auc", "precision_recall"]


@register_op("auc", has_grad=False)
def auc(probs, labels, pos_bins, neg_bins):
    """Binned ROC-AUC: ``probs`` (N,) positive scores in [0, 1],
    ``labels`` (N,) {0, 1}, running histograms ``pos_bins``/``neg_bins``
    (K + 1,). Returns ``(auc, new_pos_bins, new_neg_bins)``; a history
    of one class only gives 0.5."""
    k = pos_bins.shape[0] - 1
    idx = torch.clamp((probs * k).to(torch.int32), 0, k).long()
    pos = labels > 0.5
    pos_bins = pos_bins.index_add(0, idx, pos.to(pos_bins.dtype))
    neg_bins = neg_bins.index_add(0, idx, (~pos).to(neg_bins.dtype))
    tp = torch.cumsum(pos_bins.flip(0), 0)
    fp = torch.cumsum(neg_bins.flip(0), 0)
    tpr = tp / torch.clamp(tp[-1], min=1e-12)
    fpr = fp / torch.clamp(fp[-1], min=1e-12)
    area = ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) * 0.5).sum()
    area = area + fpr[0] * tpr[0] * 0.5
    degenerate = (pos_bins.sum() == 0) | (neg_bins.sum() == 0)
    return (torch.where(degenerate, torch.full_like(area, 0.5), area),
            pos_bins, neg_bins)


@register_op("precision_recall", has_grad=False)
def precision_recall(probs, labels, stats, threshold=0.5):
    """Binary precision, recall and F1 over running ``stats`` = (tp, fp,
    fn): ``((precision, recall, f1), new_stats)``."""
    pred = probs >= threshold
    truth = labels > 0.5
    tp = stats[0] + (pred & truth).sum()
    fp = stats[1] + (pred & ~truth).sum()
    fn = stats[2] + (~pred & truth).sum()
    p = tp / torch.clamp(tp + fp, min=1e-12)
    r = tp / torch.clamp(tp + fn, min=1e-12)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-12)
    return (p, r, f1), torch.stack([tp, fp, fn])
