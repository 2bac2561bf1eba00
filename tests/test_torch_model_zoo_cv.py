"""The port's CV classifiers against the JAX package on the CPU, on the
reference's weights: MobileNet V1/V2, VGG, SE-ResNeXt, LeNet, TSN and C3D
(the rest of ``legacy_cv``: ``test_torch_legacy_cv.py``). Each model's
eval logits within 1e-6 abs / 1e-5 rel of its scale, its loss within
1e-5 relative and every gradient within atol 1e-5 / rtol 1e-4, in eval
mode and, where the batch's statistics are well conditioned at these
sizes, in training mode too (at 2 images of 32 pixels a deep net's last
stages normalise 2 samples a channel, where both packages' fp32
gradients are dominated by rounding). Also: the conv layer's symmetric
padding through ``F.conv2d``'s ``padding=`` gives the numbers of
``F.pad`` first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.models as JM
import paddle_tpu_torch.models as PM
from paddle_tpu.models.common import classification_loss as jloss_head
from paddle_tpu_torch.models.common import classification_loss
from paddle_tpu_torch.nn.module import capture_state
from paddle_tpu_torch.ops import nn as ops_nn
from test_torch_resnet import _transposes, params_only
from torch_parity import (GRAD_ATOL, GRAD_RTOL, OP_ATOL, OP_RTOL, close,
                          flat, init, loss_close)

torch.set_num_threads(2)


def _grads_close(pm, jgrads):
    """Every parameter's gradient against the reference's (a parameter
    the loss does not reach has none here and zeros there)."""
    want = flat(params_only(jax.device_get(jgrads)))
    tr = _transposes(pm)
    got = dict(pm.named_parameters())
    assert set(got) == set(want), set(got) ^ set(want)
    for name, p in got.items():
        w = tr[name](want[name]) if name in tr else want[name]
        g = p.grad if p.grad is not None else torch.zeros(p.shape)
        close(g, w, GRAD_ATOL, GRAD_RTOL, what=name)


def zoo_parity(name, kw, x, y, training_modes=(False,), port_kw=None,
               seed=0):
    """Build the reference model ``name(**kw)`` and the port's from its
    weights; eval logits, then loss and gradients in each mode of
    ``training_modes``."""
    jm = getattr(JM, name)(**kw)
    jm._assign_paths(())
    params = init(jm, seed)
    pm = getattr(PM, name).from_jax(params, **(port_kw or kw), device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    has_loss = hasattr(jm, "loss")

    def jfwd(p, xx, training):
        if name == "LeNet":
            return jm(p, xx)
        return jm(p, xx, training=training)

    want = jax.jit(lambda p, xx: jfwd(p, xx, False))(params, jnp.asarray(x))
    pm.eval()
    with torch.no_grad():
        got = pm(xt)
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, OP_ATOL * scale, OP_RTOL, "eval logits")
    for training in training_modes:
        def jloss(p):
            if has_loss:
                return jm.loss(p, jnp.asarray(x), jnp.asarray(y),
                               training=training)
            return jloss_head(jfwd(p, jnp.asarray(x), training),
                              jnp.asarray(y))

        (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            params)
        pm.train(training)
        pm.zero_grad(set_to_none=True)
        with capture_state():         # the statistics stay the reference's
            out = pm.loss(xt, yt) if has_loss else classification_loss(
                pm(xt), yt)
        out[0].backward()
        loss_close(out[0], jl)
        _grads_close(pm, jg)
    return pm


def _images(b, *shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b,) + shape).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


@pytest.mark.parametrize("name,kw,hw,b,modes", [
    ("MobileNetV1", dict(num_classes=10, scale=0.25), 32, 2, (False,)),
    ("MobileNetV2", dict(num_classes=10, scale=0.25), 32, 2, (False,)),
    ("VGG", dict(depth=11, num_classes=10, width=8, fc_dim=32), 32, 2,
     (False, True)),
    ("SEResNeXt", dict(depth=50, num_classes=10, width=16, cardinality=4),
     32, 2, (False,)),
])
def test_classifier_equals_the_reference(name, kw, hw, b, modes):
    x, y = _images(b, hw, hw, 3)
    zoo_parity(name, kw, x, y, modes)


def test_mobilenet_v1_feature_endpoints_equal_the_reference():
    """The endpoints the detectors read, and their widths."""
    x, _ = _images(2, 64, 64, 3)
    jm = JM.MobileNetV1(num_classes=10, scale=0.25)
    params = init(jm, 0)
    pm = PM.MobileNetV1.from_jax(params, num_classes=10, scale=0.25,
                                 device="cpu").eval()
    _, want = jm.features(params, jnp.asarray(x), endpoints=(4, 10))
    with torch.no_grad():
        _, got = pm.features(torch.from_numpy(x), endpoints=(4, 10))
    assert set(got) == {4, 10}
    for i in (4, 10):
        close(got[i], want[i], 1e-5, 1e-4, f"endpoint {i}")
    assert pm.block_channels == jm.block_channels


def test_lenet_equals_the_reference():
    x, y = _images(2, 28, 28, 1)
    zoo_parity("LeNet", dict(num_classes=10), x, y, (False,))


def test_vgg_dropout_draws_from_the_generator():
    pm = PM.VGG(11, num_classes=10, width=8, fc_dim=32, device="cpu")
    x = torch.from_numpy(_images(2, 32, 32, 3)[0])
    pm.train()
    with capture_state():
        plain = pm(x)                      # no generator: no dropout
        a = pm(x, torch.Generator().manual_seed(3))
        b = pm(x, torch.Generator().manual_seed(3))
        c = pm(x, torch.Generator().manual_seed(4))
        pm.eval()
        evald = pm(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)
    pm.train()
    with capture_state():
        assert torch.equal(pm(x), plain)
    assert evald.shape == plain.shape


def test_tsn_equals_the_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 32, 32, 3)).astype(np.float32)
    zoo_parity("TSN", dict(num_classes=10, num_segments=3, scale=0.125), x,
               np.array([1, 7], np.int32), (False,))


def test_c3d_equals_the_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 16, 16, 3)).astype(np.float32)
    zoo_parity("C3D", dict(num_classes=10, width_scale=0.125), x,
               np.array([2, 5], np.int32), (False, True))


def test_seeded_models_are_the_same_on_every_device_type_and_differ_by_seed():
    a = PM.MobileNetV2(10, scale=0.25, device="cpu", seed=3)
    b = PM.MobileNetV2(10, scale=0.25, device="cpu", seed=3)
    c = PM.MobileNetV2(10, scale=0.25, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    # the reference's init moments: MSRA-normal convs, ones/zeros BN
    w = a.blocks[3].project.conv.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) - (2.0 / fan_in) ** 0.5) < 0.15 * (
        2.0 / fan_in) ** 0.5
    assert torch.equal(a.stem.bn.variance, torch.ones_like(
        a.stem.bn.variance))


@pytest.mark.parametrize("stride,padding,groups", [
    (1, 1, 1), (2, 1, 1), (1, 2, 4), (2, 3, 8), (1, 0, 1)])
def test_symmetric_padding_through_the_conv_gives_the_padded_numbers(
        stride, padding, groups):
    """Within 1e-6 of the explicitly padded conv (oneDNN on the CPU may
    pick another algorithm for the two calls; the card's run compares
    them bit for bit)."""
    g = torch.Generator().manual_seed(stride * 10 + padding + groups)
    x = torch.randn(2, 8, 13, 11, generator=g)
    w = torch.randn(16, 8 // groups, 3, 3, generator=g)
    want = F.conv2d(F.pad(x, [padding] * 4), w, stride=stride, groups=groups)
    for xin in (x, x.to(memory_format=torch.channels_last)):
        got = ops_nn._conv_nd(xin, w, (stride, stride), (padding, padding),
                              (1, 1), groups)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # SAME with an odd total keeps the explicit pad (the odd pixel after)
    same = ops_nn._conv_nd(x, w, (2, 2), "SAME", (1, 1), groups)
    assert same.shape[2:] == (7, 6)
