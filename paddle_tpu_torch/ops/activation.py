"""Activation ops (``paddle_tpu/ops/activation.py``): the reference's
registered activations over tensors, each with the reference's numpy
reference. ``gelu`` and ``relu`` are also the models' activations."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op

__all__ = [
    "relu", "sigmoid", "tanh", "gelu", "softplus", "softsign", "exp", "log",
    "square", "sqrt", "rsqrt", "abs", "ceil", "floor", "round", "reciprocal",
    "sin", "cos", "swish", "silu", "leaky_relu", "elu", "relu6",
    "hard_sigmoid", "hard_swish", "prelu", "pow", "clip",
    "selu", "mish", "softshrink", "hard_shrink", "tanh_shrink",
    "thresholded_relu", "logsigmoid", "stanh",
]


def _reg(name, fn, np_ref):
    register_op(name, reference=np_ref)(fn)
    return fn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation: the reference's ``jax.nn.gelu`` default
    (``approximate=True``), not PyTorch's erf default."""
    return F.gelu(x, approximate="tanh")


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` (the reference's ``jax.nn.relu``)."""
    return F.relu(x)


def _softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it:
    ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _silu(x):
    """``x * sigmoid(x)`` (``jax.nn.silu``)."""
    return x * torch.sigmoid(x)


relu = _reg("relu", relu, lambda x: np.maximum(x, 0))
sigmoid = _reg("sigmoid", torch.sigmoid, lambda x: 1 / (1 + np.exp(-x)))
tanh = _reg("tanh", torch.tanh, np.tanh)
gelu = _reg("gelu", gelu,
            lambda x: 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x**3))))
softplus = _reg("softplus", _softplus, lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0))
softsign = _reg("softsign", F.softsign, lambda x: x / (1 + np.abs(x)))
exp = _reg("exp", torch.exp, np.exp)
log = _reg("log", torch.log, np.log)
square = _reg("square", torch.square, np.square)
sqrt = _reg("sqrt", torch.sqrt, np.sqrt)
rsqrt = _reg("rsqrt", torch.rsqrt, lambda x: 1 / np.sqrt(x))
abs = _reg("abs", torch.abs, np.abs)
ceil = _reg("ceil", torch.ceil, np.ceil)
floor = _reg("floor", torch.floor, np.floor)
round = _reg("round", torch.round, np.round)
reciprocal = _reg("reciprocal", torch.reciprocal, lambda x: 1 / x)
sin = _reg("sin", torch.sin, np.sin)
cos = _reg("cos", torch.cos, np.cos)
swish = _reg("swish", _silu, lambda x: x / (1 + np.exp(-x)))
silu = swish


@register_op("leaky_relu", reference=lambda x, alpha=0.02: np.where(x >= 0, x, alpha * x))
def leaky_relu(x, alpha=0.02):
    return torch.where(x >= 0, x, alpha * x)


@register_op("elu", reference=lambda x, alpha=1.0: np.where(x > 0, x, alpha * (np.exp(x) - 1)))
def elu(x, alpha=1.0):
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


@register_op("relu6", reference=lambda x: np.minimum(np.maximum(x, 0), 6))
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@register_op("hard_sigmoid", reference=lambda x, slope=0.2, offset=0.5:
             np.clip(slope * x + offset, 0, 1))
def hard_sigmoid(x, slope=0.2, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@register_op("hard_swish", reference=lambda x: x * np.clip(x + 3, 0, 6) / 6)
def hard_swish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@register_op("prelu", reference=lambda x, alpha: np.where(x >= 0, x, alpha * x))
def prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


@register_op("pow", reference=lambda x, factor=1.0: np.power(x, factor))
def pow(x, factor=1.0):
    return torch.pow(x, factor)


@register_op("clip", reference=lambda x, min, max: np.clip(x, min, max))
def clip(x, min, max):  # noqa: A002 - fluid op signature
    return torch.clamp(x, min, max)


# -- activation long tail (activation_op.cc breadth) ------------------------

@register_op("selu", reference=lambda x, scale=1.0507009873554805,
             alpha=1.6732632423543772:
             scale * np.where(x > 0, x, alpha * (np.exp(x) - 1)))
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


@register_op("mish", reference=lambda x:
             x * np.tanh(np.log1p(np.exp(x))))
def mish(x):
    return x * torch.tanh(_softplus(x))


@register_op("softshrink", reference=lambda x, lambda_=0.5:
             np.where(x > lambda_, x - lambda_,
                      np.where(x < -lambda_, x + lambda_, 0.0)))
def softshrink(x, lambda_=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > lambda_, x - lambda_,
                       torch.where(x < -lambda_, x + lambda_, zero))


@register_op("hard_shrink", reference=lambda x, threshold=0.5:
             np.where(np.abs(x) > threshold, x, 0.0))
def hard_shrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@register_op("tanh_shrink", reference=lambda x: x - np.tanh(x))
def tanh_shrink(x):
    return x - torch.tanh(x)


@register_op("thresholded_relu", reference=lambda x, threshold=1.0:
             np.where(x > threshold, x, 0.0))
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


@register_op("logsigmoid", reference=lambda x:
             -np.log1p(np.exp(-np.abs(x))) + np.minimum(x, 0))
def logsigmoid(x):
    return -_softplus(-x)


@register_op("stanh", reference=lambda x, scale_a=0.67, scale_b=1.7159:
             scale_b * np.tanh(scale_a * x))
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_op("acos", reference=np.arccos)
def acos(x):
    """acos activation (activation_op.cc AcosFunctor)."""
    return torch.acos(x)


@register_op("asin", reference=np.arcsin)
def asin(x):
    """asin activation."""
    return torch.asin(x)


@register_op("atan", reference=np.arctan)
def atan(x):
    """atan activation."""
    return torch.atan(x)


@register_op("brelu", reference=None)
def brelu(x, t_min=0.0, t_max=24.0):
    """brelu: clip(x, t_min, t_max) (activation_op.cc BReluFunctor)."""
    return torch.clamp(x, t_min, t_max)


@register_op("soft_relu", reference=None)
def soft_relu(x, threshold=40.0):
    """soft_relu: log(1 + exp(clip(x, -t, t)))."""
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))
