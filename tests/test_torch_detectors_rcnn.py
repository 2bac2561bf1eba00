"""The port's Faster and Mask R-CNN against the JAX package on the CPU,
as ``test_torch_detectors.py`` holds SSD and YOLOv3 (its helpers): the
losses and gradients in eval mode, the training-mode losses, ``detect``
and ``segment`` with kept boxes, class ids and validity exactly."""

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.models import faster_rcnn as jfr
from paddle_tpu_torch.models import faster_rcnn
from test_torch_detectors import _detect_parity, _gt, _loss_parity, _pair

torch.set_num_threads(2)


def test_faster_rcnn_equals_the_reference():
    cfg = jfr.FasterRCNNConfig.tiny()
    jm, params, pm = _pair(jfr.FasterRCNN, faster_rcnn.FasterRCNN, cfg,
                           faster_rcnn.FasterRCNNConfig.tiny())
    image, boxes, labels, mask = _gt("pixel")
    _loss_parity(jm, params, pm, (image, boxes, labels, mask))
    want = jm.detect(params, jnp.asarray(image), score_threshold=0.05)
    got = pm.detect(torch.from_numpy(image), score_threshold=0.05)
    _detect_parity(got, want)


def test_mask_rcnn_equals_the_reference():
    cfg = jfr.FasterRCNNConfig.tiny()
    jm, params, pm = _pair(jfr.MaskRCNN, faster_rcnn.MaskRCNN, cfg,
                           faster_rcnn.FasterRCNNConfig.tiny())
    image, boxes, labels, mask = _gt("pixel")
    inst = (np.random.default_rng(9).random((2, 3, 32, 32)) < 0.5).astype(
        np.float32)
    aux = _loss_parity(jm, params, pm, (image, boxes, labels, mask, inst))
    assert set(aux) == {"mask_loss"}
    want = jm.segment(params, jnp.asarray(image), score_threshold=0.05)
    got = pm.segment(torch.from_numpy(image), score_threshold=0.05)
    _detect_parity(got, want)
