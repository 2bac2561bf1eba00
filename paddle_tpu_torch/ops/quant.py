"""Quantization ops (``paddle_tpu/ops/quant.py``): QAT fake-quant with
straight-through gradients, and weight fake-quant for PTQ.

``fake_quantize_abs_max``, ``fake_channel_wise_quantize_abs_max`` and
``fake_quantize_moving_average_abs_max`` quantise to ``bit_length`` bits
and back: ``round(clip(x / scale) * qmax) * scale / qmax``. Rounding is
half to even (``torch.round``, as ``jnp.round``). The gradient passes
straight through the rounding, and through the clip where ``|x / scale|
<= 1`` (a closed interval: the element at the abs-max keeps gradient 1);
the scale is an observer and takes none.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op

__all__ = ["fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
           "fake_quantize_moving_average_abs_max", "quantize_weight_tree"]


class _STEQuant(torch.autograd.Function):
    """``round(clip(v, -1, 1) * qmax)`` with a straight-through gradient
    masked to ``|v| <= 1``."""

    @staticmethod
    def forward(v, qmax):
        return torch.round(torch.clamp(v, -1.0, 1.0) * qmax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.qmax = inputs[1]

    @staticmethod
    def backward(ctx, g):
        v, = ctx.saved_tensors
        return g * (v.abs() <= 1.0).to(g.dtype) * ctx.qmax, None


def _fake_quant(x, scale, qmax):
    return _STEQuant.apply(x / scale, qmax) * scale / qmax


@register_op("fake_quantize_abs_max")
def fake_quantize_abs_max(x, bit_length: int = 8):
    """Symmetric per-tensor fake quant with the dynamic abs-max scale:
    ``(quantised-dequantised x, scale)``."""
    qmax = 2.0 ** (bit_length - 1) - 1
    scale = torch.clamp(x.detach().abs().max(), min=1e-8)
    return _fake_quant(x, scale, qmax), scale


@register_op("fake_channel_wise_quantize_abs_max")
def fake_channel_wise_quantize_abs_max(x, bit_length: int = 8,
                                       axis: int = -1):
    """Per-channel symmetric fake quant along ``axis`` (conv and linear
    weights): ``(fq x, per-channel scale)``."""
    qmax = 2.0 ** (bit_length - 1) - 1
    dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    scale = torch.clamp(x.detach().abs().amax(dim=dims, keepdim=True),
                        min=1e-8)
    return _fake_quant(x, scale, qmax), scale.squeeze()


@register_op("fake_quantize_moving_average_abs_max")
def fake_quantize_moving_average_abs_max(x, state_scale, *,
                                         bit_length: int = 8,
                                         momentum: float = 0.9,
                                         training: bool = True):
    """Activation fake quant with an EMA abs-max scale (the QAT
    observer): ``(fq x, new state scale)``."""
    qmax = 2.0 ** (bit_length - 1) - 1
    if training:
        scale = momentum * state_scale + (1 - momentum) * x.abs().max()
    else:
        scale = state_scale
    scale = torch.clamp(torch.as_tensor(scale, dtype=x.dtype,
                                        device=x.device).detach(), min=1e-8)
    return _fake_quant(x, scale, qmax), scale


def quantize_weight_tree(params, bit_length: int = 8):
    """PTQ: every floating leaf named ``weight`` of rank >= 2 in a nested
    dict, fake-quantised per channel on its last axis."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if (name == "weight" and isinstance(tree, torch.Tensor)
                and tree.is_floating_point() and tree.ndim >= 2):
            return fake_channel_wise_quantize_abs_max(tree, bit_length)[0]
        return tree

    return walk(params)
