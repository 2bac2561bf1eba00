"""The port's streaming metrics (``paddle_tpu_torch.metrics``) against the
JAX package's (``paddle_tpu.metrics``) on the same numpy streams from a
seed: every ``eval`` equal up to float64 rounding (rel 1e-12), with the
port fed torch tensors (and numpy arrays where the reference takes
lists), several updates a stream, ``reset`` between."""

import numpy as np
import pytest
import torch

from paddle_tpu import metrics as jm
from paddle_tpu_torch import metrics as pm

REL = 1e-12


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=REL, abs=1e-15), k
    elif isinstance(want, list):
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == pytest.approx(want, rel=REL, abs=1e-15)


def _feed(ref, port, batches, convert=torch.from_numpy):
    for args in batches:
        ref.update(*args)
        port.update(*(convert(a) if isinstance(a, np.ndarray) else a
                      for a in args))
    _same(port.eval(), ref.eval())


def test_accuracy_scores_and_ids():
    rng = np.random.default_rng(0)
    ref, port = jm.Accuracy(), pm.Accuracy()
    _feed(ref, port, [(rng.standard_normal((16, 5)).astype(np.float32),
                       rng.integers(0, 5, (16, 1)))
                      for _ in range(4)])
    ref.reset(), port.reset()
    _feed(ref, port, [(rng.integers(0, 3, 12), rng.integers(0, 3, 12))
                      for _ in range(3)])


@pytest.mark.parametrize("thresholds", [4095, 200])
def test_auc_histograms(thresholds):
    rng = np.random.default_rng(1)
    ref, port = jm.Auc(thresholds), pm.Auc(thresholds)
    batches = []
    for _ in range(5):
        labels = rng.integers(0, 2, 64).astype(np.float32)
        probs = np.clip(0.3 * labels + 0.7 * rng.random(64), 0, 1)
        batches.append((probs.astype(np.float32), labels))
    batches.append((np.array([0.0, 1.0, 1.5, -0.2], np.float32),
                    np.array([1, 0, 1, 0], np.float32)))
    _feed(ref, port, batches)
    np.testing.assert_array_equal(port._pos, ref._pos)
    np.testing.assert_array_equal(port._neg, ref._neg)
    one = pm.Auc().update(torch.ones(4), torch.ones(4))
    assert one.eval() == jm.Auc().update(np.ones(4), np.ones(4)).eval()


def test_mean_metric():
    ref, port = jm.MeanMetric(), pm.MeanMetric()
    for v, w in ((1.5, 1.0), (2.25, 3.0), (-0.5, 0.5)):
        ref.update(np.float32(v), w)
        port.update(torch.tensor(v), w)
    _same(port.eval(), ref.eval())


def test_chunk_evaluator():
    rng = np.random.default_rng(2)
    n_types = 3
    ref, port = jm.ChunkEvaluator(n_types), pm.ChunkEvaluator(n_types)
    for _ in range(4):
        infer = rng.integers(0, 2 * n_types + 1, (5, 20))
        label = np.where(rng.random((5, 20)) < 0.8, infer,
                         rng.integers(0, 2 * n_types + 1, (5, 20)))
        lengths = rng.integers(5, 21, 5)
        ref.update(infer, label, lengths)
        port.update(torch.from_numpy(infer), torch.from_numpy(label),
                    torch.from_numpy(lengths))
    ref.update(infer[0], label[0])
    port.update(torch.from_numpy(infer[0]), torch.from_numpy(label[0]))
    _same(port.eval(), ref.eval())
    assert pm.ChunkEvaluator.extract_chunks([0, 1, 6, 2, 3, 3], 3) == \
        jm.ChunkEvaluator.extract_chunks([0, 1, 6, 2, 3, 3], 3)


def test_precision_recall():
    rng = np.random.default_rng(3)
    ref, port = jm.PrecisionRecall(0.4), pm.PrecisionRecall(0.4)
    _feed(ref, port, [(rng.random(50).astype(np.float32),
                       rng.integers(0, 2, 50).astype(np.float32))
                      for _ in range(3)])


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance(normalized):
    rng = np.random.default_rng(4)
    ref, port = jm.EditDistance(normalized), pm.EditDistance(normalized)
    for _ in range(3):
        hyps = rng.integers(0, 5, (4, 9))
        refs = rng.integers(0, 5, (4, 7))
        hl, rl = rng.integers(0, 10, 4), rng.integers(1, 8, 4)
        ref.update(hyps, refs, hl, rl)
        port.update(torch.from_numpy(hyps), torch.from_numpy(refs),
                    torch.from_numpy(hl), torch.from_numpy(rl))
    lists = [rng.integers(0, 4, n) for n in (3, 0, 6)]
    ref.update(lists, lists[::-1])
    port.update([torch.from_numpy(a) for a in lists],
                [torch.from_numpy(a) for a in lists[::-1]])
    _same(port.eval(), ref.eval())
    assert pm.EditDistance.levenshtein([1, 2, 3], [2, 3, 4]) == 2


def _image(rng, k=12, g=5, classes=4):
    gt = rng.random((g, 2)) * 60
    gt_boxes = np.concatenate([gt, gt + 10 + rng.random((g, 2)) * 30], 1)
    pick = rng.integers(0, g, k)
    boxes = gt_boxes[pick] + rng.standard_normal((k, 4)) * 4
    return (boxes.astype(np.float32), rng.random(k).astype(np.float32),
            rng.integers(0, classes, k), rng.random(k) < 0.8,
            gt_boxes.astype(np.float32), rng.integers(0, classes, g),
            rng.random(g) < 0.9, rng.random(g) < 0.2)


@pytest.mark.parametrize("ap_version,difficult",
                         [("11point", False), ("integral", False),
                          ("integral", True)])
def test_detection_map(ap_version, difficult):
    rng = np.random.default_rng(5)
    ref = jm.DetectionMAP(0.5, ap_version, evaluate_difficult=difficult)
    port = pm.DetectionMAP(0.5, ap_version, evaluate_difficult=difficult)
    _feed(ref, port, [_image(rng) for _ in range(6)])
    with pytest.raises(ValueError):
        pm.DetectionMAP(ap_version="voc")


def test_composite_metric():
    rng = np.random.default_rng(6)
    ref = jm.CompositeMetric(jm.PrecisionRecall(), jm.Auc(100))
    port = pm.CompositeMetric(pm.PrecisionRecall())
    port.add_metric(pm.Auc(100))
    _feed(ref, port, [(rng.random(30).astype(np.float32),
                       rng.integers(0, 2, 30).astype(np.float32))
                      for _ in range(3)])
    ref.reset(), port.reset()
    _same(port.eval(), ref.eval())
