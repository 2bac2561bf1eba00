"""The port's detectors against the JAX package on the CPU, on the
reference's weights at its ``.tiny()`` configurations: SSD (MobileNetV1)
and YOLOv3 (MobileNetV1 and DarkNet53 backbones); Faster / Mask R-CNN in
``test_torch_detectors_rcnn.py``.
Each one's loss within 1e-5 relative and every gradient within atol 1e-5
/ rtol 1e-4, in eval mode (the BatchNorm statistics the reference's
``training=False`` uses; in training mode the tiny backbones normalise a
handful of samples a channel, where fp32 rounding dominates the
gradients), the training-mode loss, and ``detect`` / ``segment``: kept
indices (as boxes), class ids and validity exactly, boxes and scores
within 1e-6 abs / 1e-5 rel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import ssd as jssd
from paddle_tpu.models import yolov3 as jyolo
from paddle_tpu_torch.models import ssd, yolov3
from paddle_tpu_torch.nn.module import capture_state
from test_torch_model_zoo_cv import _grads_close
from torch_parity import close, init, loss_close

torch.set_num_threads(2)


def _gt(kind, b=2, g=3, size=64, seed=7):
    """Padded ground truths (the last row of the last image is padding):
    normalised xyxy (SSD), normalised cxcywh (YOLOv3) or pixel xyxy
    (R-CNN), labels in [1, 4)."""
    rng = np.random.default_rng(seed)
    xy = 0.05 + 0.5 * rng.random((b, g, 2))
    wh = 0.15 + 0.3 * rng.random((b, g, 2))
    if kind == "cxcywh":
        boxes = np.concatenate([xy + wh / 2, wh], -1)
    else:
        boxes = np.concatenate([xy, xy + wh], -1)
        if kind == "pixel":
            boxes = boxes * size
    labels = rng.integers(1, 4, (b, g)).astype(np.int32)
    mask = np.ones((b, g), bool)
    mask[-1, -1] = False
    image = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    return image, boxes.astype(np.float32), labels, mask


def _pair(jcls, pcls, cfg, pcfg, seed=0):
    jm = jcls(cfg)
    jm._assign_paths(())
    params = init(jm, seed)
    return jm, params, pcls.from_jax(params, pcfg, device="cpu")


def _loss_parity(jm, params, pm, args, extra=()):
    """Eval-mode loss and gradients, and the training-mode loss."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    for training in (False, True):
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, *jargs, training=training),
            has_aux=True))(params)
        pm.train(training)
        pm.zero_grad(set_to_none=True)
        with capture_state():
            loss, aux = pm.loss(*targs)
        loss_close(loss, jl)
        if not training:
            loss.backward()
            _grads_close(pm, jg)
    return aux


def _detect_parity(got, want):
    names = ("boxes", "classes", "scores", "valid", "masks")
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        if name in ("boxes", "scores"):
            close(g, w, 1e-6, 1e-5, name)
        else:
            close(g, w, what=name)
    assert bool(got[3].any()), "nothing kept: the check would be empty"


def test_ssd_equals_the_reference():
    cfg = jssd.SSDConfig.tiny()
    jm, params, pm = _pair(jssd.SSD, ssd.SSD, cfg, ssd.SSDConfig.tiny())
    image, boxes, labels, mask = _gt("xyxy")
    _loss_parity(jm, params, pm, (image, boxes, labels, mask))
    want = jm.detect(params, jnp.asarray(image), score_threshold=0.05)
    got = pm.detect(torch.from_numpy(image), score_threshold=0.05)
    _detect_parity(got, want)
    # (after the eager detect: the jitted loss left a tracer there)
    close(pm.anchors(), jm._anchors, 1e-7, 0, "prior boxes")


@pytest.mark.parametrize("backbone", ["mobilenet", "darknet53"])
def test_yolov3_equals_the_reference(backbone):
    kw = dict(backbone=backbone)
    if backbone == "darknet53":
        kw["endpoints"] = (-1, 22)
    cfg = jyolo.YOLOv3Config(**{**jyolo.YOLOv3Config.tiny().__dict__, **kw})
    pcfg = yolov3.YOLOv3Config(**{**yolov3.YOLOv3Config.tiny().__dict__,
                                  **kw})
    jm, params, pm = _pair(jyolo.YOLOv3, yolov3.YOLOv3, cfg, pcfg)
    image, boxes, labels, mask = _gt("cxcywh")
    _loss_parity(jm, params, pm, (image, boxes, labels, mask))
    want = jm.detect(params, jnp.asarray(image), score_threshold=0.3)
    got = pm.detect(torch.from_numpy(image), score_threshold=0.3)
    _detect_parity(got, want)
