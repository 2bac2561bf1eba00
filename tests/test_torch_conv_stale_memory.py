"""A bf16 conv's gradients on the CPU do not depend on what the allocator's
freed blocks hold.

oneDNN's bf16 weight gradient of a padded strided conv whose output is
one pixel wide (a 3x3 stride-2 conv over a 1x1 map: ResNet-18's last
stage at a 16-pixel input) reads memory it never wrote. Stale NaN in
freed blocks, such as a skipped AMP step's non-finite gradients or an
earlier test's buffers, then came out in the gradient, and the next AMP
step was skipped too (``test_torch_resnet.py::
test_amp_step_keeps_statistics_on_a_skipped_step`` failed in a shared
test process). ``ops.nn._conv_nd`` pads bf16 CPU inputs explicitly.
Each test first fills and frees blocks of many sizes with NaN (the state
that leaked), then runs the step or the conv."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.amp import make_amp_state, scaled_train_step
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import nn as ops_nn

torch.set_num_threads(2)


def _stale_nan():
    """Fill blocks of many sizes with NaN and free them."""
    bufs = [torch.full((n,), float("nan")) for n in range(1, 4097, 7)]
    del bufs


def test_amp_steps_over_stale_nan_memory():
    """The skipped-step test's two steps (loss scale inf, then 1.0) on
    ResNet-18 at width 4 and 16 pixels, ten times, with NaN left in
    freed memory before each step and between its forward and its
    backward: the finite step's gradients are finite every time."""
    model = resnet.ResNet(18, num_classes=5, width=4, device="cpu", seed=0)
    model.train()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 3), np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 4).astype(np.int32))
    opt = popt.Momentum(model.parameters(), learning_rate=0.1, momentum=0.9)
    state = make_amp_state(model, opt)

    def loss_fn(m, **b):
        out = m.loss(**b)
        _stale_nan()            # the backward allocates after this
        return out

    step = scaled_train_step(loss_fn, opt)
    for _ in range(10):
        state["loss_scale"]["scale"].fill_(float("inf"))
        _stale_nan()
        _, m = step(state, image=x, label=y)
        assert not bool(m["grads_finite"])
        state["loss_scale"]["scale"].fill_(1.0)
        _stale_nan()
        _, m = step(state, image=x, label=y)
        assert bool(m["grads_finite"])


# (input pixels, kernel, stride, padding): the shapes whose one-pixel
# output read stale memory in oneDNN's bf16 weight gradient
SHAPES = [(1, 3, 2, 1), (1, 7, 2, 3), (1, 5, 3, 2), (2, 5, 3, 2)]


@pytest.mark.parametrize("hw,k,stride,pad", SHAPES)
def test_bf16_conv_gradients_over_stale_nan_memory(hw, k, stride, pad):
    """``ops.nn.conv2d`` in bf16 (NHWC, HWIO) at those shapes, 20 times
    over NaN left in freed memory: finite gradients equal to the
    explicitly padded conv's."""
    gen = torch.Generator().manual_seed(hw * 100 + k)
    x0 = torch.randn(4, hw, hw, 16, generator=gen)
    w0 = torch.randn(k, k, 16, 32, generator=gen)
    grads = []
    for _ in range(20):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        _stale_nan()
        out = ops_nn.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16),
                            stride=stride, padding=pad)
        out.float().sum().backward()
        assert torch.isfinite(w.grad).all() and torch.isfinite(x.grad).all()
        grads.append((w.grad, x.grad))
    x = x0.clone().requires_grad_()
    w = w0.clone().requires_grad_()
    xp = F.pad(x.to(torch.bfloat16).permute(0, 3, 1, 2), [pad] * 4)
    F.conv2d(xp, w.to(torch.bfloat16).permute(3, 2, 0, 1),
             stride=stride).float().sum().backward()
    for gw, gx in grads:
        assert torch.equal(gw, w.grad) and torch.equal(gx, x.grad)
