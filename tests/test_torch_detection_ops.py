"""The port's detection ops (``paddle_tpu_torch.ops.detection``) against
the JAX package on the CPU: every registered op on its sample (hand-built
ties in the NMS, matching and sampling inputs; floats within 1e-6 abs /
1e-5 rel, indices, classes, matches and masks exactly), the ties the
reference breaks toward the lower index, the batched helpers the
detectors use against the per-image ops, the gradients of the losses and
samplers, and the random subsampling by its counts and its determinism
under one seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu.ops import detection as JD
from paddle_tpu_torch.ops import detection as D
from paddle_tpu_torch.ops import samples
from torch_parity import (DETECTION_OPS, GRAD_ATOL, GRAD_RTOL, close,
                          op_equals_the_reference, op_module)

torch.set_num_threads(2)

NAMES = sorted(n for n in samples.SAMPLES if op_module(n) in DETECTION_OPS)


def test_the_sampled_ops_are_the_references_34():
    assert len(NAMES) == 34


@pytest.mark.parametrize("name", NAMES)
def test_op_equals_the_reference(name):
    op_equals_the_reference(name, jit=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_nms_keeps_the_lower_index_on_equal_scores():
    boxes = np.array([[0, 0, 4, 4]] * 4 + [[10, 10, 12, 12]] * 2,
                     np.float32)
    scores = np.array([0.5, 0.5, 0.9, 0.5, 0.9, 0.9], np.float32)
    got = D.nms(_t(boxes), _t(scores), iou_threshold=0.5, max_outputs=6)
    want = jax.jit(functools.partial(JD.nms, iou_threshold=0.5,
                                     max_outputs=6))(boxes, scores)
    for g, w in zip(got, want):
        close(g, w)
    # the first 0.9 of each cluster, then nothing: duplicates suppressed
    assert got[0][:2].tolist() == [2, 4] and got[1].tolist() == [
        True, True, False, False, False, False]


def test_top_k_and_topk_mask_break_ties_as_the_reference():
    x = np.array([0.3, 0.7, 0.7, 0.1, 0.7, 0.3, -np.inf, 0.7], np.float32)
    v, i = D._top_k(_t(x), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    close(v, jv)
    close(i, ji)
    mask = np.array([True, True, False, True, True, True, True, True])
    for limit in (0, 2, 3, 8):
        close(D.topk_mask(_t(mask), _t(x), limit),
              JD.topk_mask(jnp.asarray(mask), jnp.asarray(x), limit),
              what=f"limit {limit}")


def test_bipartite_match_on_an_all_equal_matrix():
    dist = np.full((3, 5), 0.5, np.float32)
    got = D.bipartite_match(_t(dist))
    want = JD.bipartite_match(jnp.asarray(dist))
    close(got[0], want[0])
    close(got[1], want[1])
    assert got[0].tolist() == [0, 1, 2, -1, -1]


def test_batched_helpers_equal_the_per_image_ops():
    r = np.random.default_rng(5)
    boxes = np.stack([samples._tied_boxes(r)[0] + i for i in range(3)])
    scores = r.integers(0, 4, (3, 8, 2)).astype(np.float32) / 4
    cls, idxs, valid = D.multiclass_nms_batched(
        _t(boxes), _t(scores), score_threshold=0.1, max_per_class=3)
    for b in range(3):
        c1, i1, v1 = D.multiclass_nms(_t(boxes[b]), _t(scores[b]),
                                      score_threshold=0.1, max_per_class=3)
        assert torch.equal(cls, c1) and torch.equal(idxs[b], i1) and \
            torch.equal(valid[b], v1)
        jc, ji, jv = JD.multiclass_nms(jnp.asarray(boxes[b]),
                                       jnp.asarray(scores[b]),
                                       score_threshold=0.1, max_per_class=3)
        close(i1, ji)
        close(v1, jv)
        close(c1, jc)
    dist = (r.integers(0, 3, (3, 4, 6)) / 3).astype(np.float32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], bool)
    m_idx, m_dist = D.match_boxes(_t(dist), _t(mask))
    for b in range(3):
        w_idx, w_dist = JD.match_boxes(jnp.asarray(dist[b]),
                                       jnp.asarray(mask[b]))
        close(m_idx[b], w_idx)
        close(m_dist[b], w_dist)


def _loss_grads(port_fn, jax_fn, arrays, argnums):
    tensors = [_t(a).requires_grad_(i in argnums) for i, a in
               enumerate(arrays)]
    loss = port_fn(*tensors)
    loss.backward()
    jl, jg = jax.value_and_grad(jax_fn, argnums=tuple(argnums))(
        *[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for i, g in zip(argnums, jg):
        # no gradient reached an input that only selects (bins by
        # comparison): the reference's is zero there
        got = tensors[i].grad
        close(torch.zeros(tensors[i].shape) if got is None else got, g,
              GRAD_ATOL, GRAD_RTOL, what=f"arg {i}")


def test_loss_gradients_equal_the_reference():
    for name, argnums in (("ssd_loss", (0, 1)), ("yolov3_loss", (0,))):
        args, kw = samples.sample(name)
        _loss_grads(functools.partial(getattr(D, name), **kw),
                    jax.jit(functools.partial(getattr(JD, name), **kw)),
                    list(args), argnums)
    args, kw = samples.sample("sigmoid_focal_loss")
    _loss_grads(lambda x, y: D.sigmoid_focal_loss(x, y, **kw).sum(),
                lambda x, y: JD.sigmoid_focal_loss(x, y, **kw).sum(),
                list(args), (0,))


@pytest.mark.parametrize("name", ["roi_align", "prroi_pool",
                                  "deformable_roi_pooling",
                                  "roi_perspective_transform",
                                  "deformable_conv", "psroi_pool"])
def test_sampler_gradients_equal_the_reference(name):
    args, kw = samples.sample(name)
    weights = np.random.default_rng(7).standard_normal(
        samples.to_numpy(samples.run_op(name, args, kw, "cpu")).shape
    ).astype(np.float32)
    # every float input that the reference differentiates
    argnums = tuple(i for i, a in enumerate(args)
                    if isinstance(a, np.ndarray) and a.dtype == np.float32)
    port = functools.partial(getattr(D, name), **{
        k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    ref = functools.partial(getattr(JD, name), **kw)
    _loss_grads(lambda *a: (port(*a) * _t(weights)).sum(),
                jax.jit(lambda *a: (ref(*a) * weights).sum()),
                list(args), argnums)


@pytest.mark.parametrize("name", ["rpn_target_assign",
                                  "generate_proposal_labels"])
def test_random_subsampling_counts_and_determinism(name):
    r = np.random.default_rng(11)
    anchors = samples._boxes(r, 200, 64.0, 6.0)
    gt = samples._boxes(r, 4, 64.0, 10.0)
    mask = np.array([True, True, True, False])
    if name == "rpn_target_assign":
        fn = functools.partial(D.rpn_target_assign, _t(anchors), _t(gt),
                               _t(mask), batch_size_per_im=32,
                               pos_threshold=0.4, neg_threshold=0.3)
        cap = 16
    else:
        fn = functools.partial(
            D.generate_proposal_labels, _t(anchors),
            torch.ones(200, dtype=torch.bool), _t(gt),
            torch.tensor([1, 2, 3, 1], dtype=torch.int32), _t(mask),
            batch_size_per_im=32, fg_fraction=0.25, fg_thresh=0.3,
            bg_thresh_hi=0.3)
        cap = 8

    def run(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return fn(generator=g)

    det = run(None)
    a, b, c = run(0), run(0), run(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for out in (det, a, c):
        labels, _, fg, bg = out[:4]
        assert int(fg.sum()) <= cap
        assert int(fg.sum()) + int(bg.sum()) <= 32
        assert not bool((fg & bg).any())
        assert torch.equal(labels >= 0, fg | bg)
    # as many of each kind as the deterministic pick, other members
    assert int(a[2].sum()) == int(det[2].sum())
    assert int(a[3].sum()) == int(det[3].sum())
    assert not torch.equal(a[3], c[3])
    # without a generator the reference's deterministic pick
    want = (JD.rpn_target_assign(jnp.asarray(anchors), jnp.asarray(gt),
                                 jnp.asarray(mask), batch_size_per_im=32,
                                 pos_threshold=0.4, neg_threshold=0.3)
            if name == "rpn_target_assign" else JD.generate_proposal_labels(
                jnp.asarray(anchors), jnp.ones(200, bool), jnp.asarray(gt),
                jnp.asarray([1, 2, 3, 1], jnp.int32), jnp.asarray(mask),
                batch_size_per_im=32, fg_fraction=0.25, fg_thresh=0.3,
                bg_thresh_hi=0.3))
    for g, w in zip(det, want):
        close(g, w)
