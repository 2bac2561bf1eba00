"""The port's ``models/legacy_cv.py`` against the JAX package on the CPU,
on the reference's weights: AlexNet, GoogLeNet, ShuffleNetV2, DarkNet53,
SqueezeNet and DenseNet-121 (eval logits, loss and every gradient, as
``test_torch_model_zoo_cv.py`` holds the other classifiers; training mode
too for the nets without BatchNorm), ``channel_shuffle``, DarkNet53's
endpoints, and dropout from an explicit generator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import legacy_cv as jlegacy
import paddle_tpu_torch.models as PM
from paddle_tpu_torch.models.legacy_cv import channel_shuffle
from paddle_tpu_torch.nn.module import capture_state
from test_torch_model_zoo_cv import _images, zoo_parity
from torch_parity import close, init

torch.set_num_threads(2)


@pytest.mark.parametrize("name,kw,hw,modes", [
    ("AlexNet", dict(num_classes=10), 64, (False, True)),
    ("AlexNet", dict(num_classes=10), 227, (False,)),
    ("GoogLeNet", dict(num_classes=10), 32, (False,)),
    ("ShuffleNetV2", dict(num_classes=10), 32, (False,)),
    ("DarkNet53", dict(num_classes=10, scale=0.25), 32, (False,)),
    ("SqueezeNet", dict(num_classes=10), 32, (False, True)),
    ("DenseNet121", dict(num_classes=10, growth=8), 32, (False,)),
], ids=["AlexNet-resample", "AlexNet-6x6", "GoogLeNet", "ShuffleNetV2",
        "DarkNet53", "SqueezeNet", "DenseNet121"])
def test_legacy_classifier_equals_the_reference(name, kw, hw, modes):
    x, y = _images(1 if hw > 64 else 2, hw, hw, 3)
    zoo_parity(name, kw, x, y, modes)


def test_channel_shuffle_and_darknet_endpoints_equal_the_reference():
    x = np.random.default_rng(4).standard_normal((2, 3, 4, 12)).astype(
        np.float32)
    for groups in (2, 3, 4):
        close(channel_shuffle(torch.from_numpy(x), groups),
              jlegacy.channel_shuffle(jnp.asarray(x), groups), 0, 0,
              f"groups {groups}")
    jm = jlegacy.DarkNet53(num_classes=1, scale=0.125)
    params = init(jm, 0)
    pm = PM.DarkNet53.from_jax(params, num_classes=1, scale=0.125,
                               device="cpu").eval()
    img, _ = _images(1, 64, 64, 3)
    _, want = jm.features(params, jnp.asarray(img), endpoints=(13, 22, 27))
    with torch.no_grad():
        _, got = pm.features(torch.from_numpy(img), endpoints=(13, 22, 27))
    for i in (13, 22, 27):
        close(got[i], want[i], 1e-5, 1e-4, f"endpoint {i}")
    assert pm.block_channels == jm.block_channels


def test_dropout_only_with_a_generator_in_training():
    pm = PM.SqueezeNet(num_classes=10, device="cpu")
    x = torch.from_numpy(_images(2, 32, 32, 3)[0])
    pm.train()
    with capture_state():
        plain = pm(x)
        a = pm(x, torch.Generator().manual_seed(0))
        b = pm(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    pm.eval()
    assert torch.equal(pm(x, torch.Generator().manual_seed(0)), plain)
