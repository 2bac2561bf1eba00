"""Composite network helpers (``paddle_tpu/nn/nets.py``, fluid's
``nets``): ``glu`` (registered) and the modules ``SimpleImgConvPool``,
``ImgConvGroup`` and ``SequenceConvPool`` over ``Conv2D``/``Pool2D``/
``BatchNorm``/``Dropout`` and the sequence ops. Images are NHWC, as the
reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import BatchNorm, Conv2D, Dropout, Pool2D
from paddle_tpu_torch.ops import activation as A
from paddle_tpu_torch.ops import sequence as S

__all__ = ["glu", "SimpleImgConvPool", "ImgConvGroup", "SequenceConvPool"]


@register_op("glu", has_grad=True)
def glu(x, axis: int = -1):
    """Gated linear unit: the first half of ``x`` along ``axis`` times
    the sigmoid of the second."""
    if x.shape[axis] % 2:
        raise ValueError(f"glu axis dim must be even, got {x.shape[axis]}")
    a, b = x.chunk(2, dim=axis)
    return a * A.sigmoid(b)


_ACTS = {None: lambda x: x, "relu": A.relu, "sigmoid": A.sigmoid,
         "tanh": A.tanh, "gelu": A.gelu, "swish": A.swish}


def _act(name):
    if callable(name):
        return name
    try:
        return _ACTS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


class SimpleImgConvPool(nn.Module):
    """One ``Conv2D``, its activation, one ``Pool2D``
    (``simple_img_conv_pool``)."""

    def __init__(self, in_channels, num_filters, filter_size, pool_size,
                 pool_stride, pool_padding=0, pool_type="max",
                 global_pooling=False, conv_stride=1, conv_padding=0,
                 conv_dilation=1, conv_groups=1, act=None, bias=True, *,
                 device=None, dtype=None):
        super().__init__()
        self.conv = Conv2D(in_channels, num_filters, filter_size,
                           stride=conv_stride, padding=conv_padding,
                           dilation=conv_dilation, groups=conv_groups,
                           bias=bias, device=device, dtype=dtype)
        self.pool = Pool2D(pool_size, pool_stride, pool_padding,
                           pool_type=pool_type, global_pooling=global_pooling)
        self.act = _act(act)

    def forward(self, x):
        return self.pool(self.act(self.conv(x)))


def _extend(obj, n, what):
    if isinstance(obj, (list, tuple)):
        if len(obj) != n:
            raise ValueError(f"{what} length {len(obj)} != {n} conv layers")
        return list(obj)
    return [obj] * n


class ImgConvGroup(nn.Module):
    """Conv2D [+ BatchNorm [+ Dropout]] layers, then one Pool2D
    (``img_conv_group``, the VGG block); per-layer settings broadcast as
    the reference's. With batch norm the activation follows it. In
    training mode the batch norms update their statistics and the
    dropouts draw from ``generator``."""

    def __init__(self, in_channels, conv_num_filter: Sequence[int],
                 pool_size, conv_padding=1, conv_filter_size=3,
                 conv_act=None, conv_with_batchnorm: Union[bool, list] = False,
                 conv_batchnorm_drop_rate: Union[float, list] = 0.0,
                 pool_stride=1, pool_type="max", *, device=None, dtype=None):
        super().__init__()
        n = len(conv_num_filter)
        pad = _extend(conv_padding, n, "conv_padding")
        fs = _extend(conv_filter_size, n, "conv_filter_size")
        self.with_bn = _extend(conv_with_batchnorm, n, "conv_with_batchnorm")
        self.drop = _extend(conv_batchnorm_drop_rate, n,
                            "conv_batchnorm_drop_rate")
        self.act = _act(conv_act)
        kw = dict(device=device, dtype=dtype)
        c = in_channels
        for i, f in enumerate(conv_num_filter):
            self.add_module(f"conv{i}", Conv2D(c, f, fs[i], padding=pad[i],
                                               **kw))
            if self.with_bn[i]:
                self.add_module(f"bn{i}", BatchNorm(f, **kw))
                if abs(self.drop[i]) > 1e-5:
                    self.add_module(f"dropout{i}", Dropout(self.drop[i]))
            c = f
        self.n = n
        self.pool = Pool2D(pool_size, pool_stride, pool_type=pool_type)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = x
        for i in range(self.n):
            h = getattr(self, f"conv{i}")(h)
            if self.with_bn[i]:
                h = self.act(getattr(self, f"bn{i}")(h))
                if abs(self.drop[i]) > 1e-5:
                    h = getattr(self, f"dropout{i}")(h, generator)
            else:
                h = self.act(h)
        return self.pool(h)


class SequenceConvPool(nn.Module):
    """Context-window sequence conv, activation, sequence pool
    (``sequence_conv_pool``, the text-CNN block) over padded ``(B, T, D)``
    rows and lengths. The window is centred: ``context_start =
    -(filter_size // 2)``."""

    def __init__(self, input_dim, num_filters, filter_size, act="sigmoid",
                 pool_type="max", bias=True, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.filter_size = filter_size
        self.filter = nn.Parameter(torch.empty(filter_size * input_dim,
                                               num_filters, **kw))
        self.bias = (nn.Parameter(torch.empty(num_filters, **kw))
                     if bias else None)
        self.act = _act(act)
        self.pool_type = pool_type

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        I.xavier_uniform()(self.filter, generator)
        if self.bias is not None:
            I.zeros(self.bias)

    def forward(self, x, lengths):
        h = S.sequence_conv(x, lengths, self.filter,
                            context_start=-(self.filter_size // 2))
        if self.bias is not None:
            h = h + self.bias
        return S.sequence_pool(self.act(h), lengths,
                               pool_type=self.pool_type)
