"""Standard layers, with the reference's parameter names and layouts so
that weights carry across from ``paddle_tpu`` as a plain key flatten
(``paddle_tpu/nn/layers.py``); ``Conv2D`` holds torch's OIHW weight,
which ``models.convert`` transposes from the reference's HWIO."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.module import report_state

#: the reference's default hints: Megatron column split, vocab split
COLUMN, ROW, VOCAB = (None, "tp"), ("tp", None), ("tp", None)


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` stored ``(in, out)``, as the
    reference stores it (not ``nn.Linear``'s ``(out, in)``).
    ``sharding`` is the weight's hint (the reference's default: split
    over "tp" on the output dim); under a sharded train step's Megatron
    placement ``tp`` holds this layer's role
    (:mod:`paddle_tpu_torch.parallel.api`)."""

    #: the layer's tensor-parallel role, set by a sharded placement
    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_init=None, bias_init=None, *, sharding=COLUMN,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight_init, self.bias_init = weight_init, bias_init
        # the bias takes the weight's output entry, as the reference's
        out = sharding[-1] if sharding is not None else None
        self.param_sharding = {
            "weight": None if sharding is None else tuple(sharding),
            "bias": (out,) if out else None}
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """``weight_init`` or the reference's default Xavier-uniform
        weight; ``bias_init`` or a zero bias."""
        (self.weight_init or I.xavier_uniform())(self.weight, generator)
        if self.bias is not None:
            (self.bias_init or I.zeros)(self.bias, generator)

    def forward(self, x):
        if self.tp is not None:
            return self.tp.linear(self, x)
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


#: the Fluid name of :class:`Linear`
FC = Linear


class LayerNorm(nn.Module):
    """Layer norm over the trailing ``normalized_shape`` axes: biased
    variance, ``eps`` inside the rsqrt, flat parameters named
    ``scale``/``bias`` (``ops/nn.py:186``). ``scale=False`` or
    ``shift=False`` creates no such parameter, so the parameter tree is
    the reference's."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 scale: bool = True, shift: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.shape = tuple(normalized_shape)
        self.epsilon = epsilon
        n = math.prod(self.shape)
        self.scale = (nn.Parameter(torch.empty(n, device=device, dtype=dtype))
                      if scale else None)
        self.bias = (nn.Parameter(torch.empty(n, device=device, dtype=dtype))
                     if shift else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.scale is not None:
            I.ones(self.scale)
        if self.bias is not None:
            I.zeros(self.bias)

    def forward(self, x):
        return F.layer_norm(
            x, self.shape,
            None if self.scale is None else self.scale.view(self.shape),
            None if self.bias is None else self.bias.view(self.shape),
            self.epsilon)


#: tables up to this many rows sum their gradients by masked reductions
_FEW_ROWS = 16


class _Embedding(torch.autograd.Function):
    """``F.embedding`` with a backward that sums each row's gradients in
    a fixed order, in float32. PyTorch's own CUDA backward gives
    run-to-run different bits where an id repeats many times (BERT's
    token types: one id over the whole batch), and a training run must be
    bit-reproducible to resume exactly. A table of at most
    :data:`_FEW_ROWS` rows takes one masked reduction per row; a larger
    one sorts the ids (stably), gathers the gradient rows in that order
    and reduces them segment by segment (``segment_reduce`` runs a
    segment on one thread per feature, 2.9 ms per BERT-base step for the
    token types' one segment of 24,576 rows on an H100). Static shapes
    and no host value, so it is captured in CUDA graphs."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num_rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        flat = ids.reshape(-1)
        rows = grad.reshape(-1, grad.shape[-1]).float()
        if ctx.num_rows <= _FEW_ROWS:
            summed = torch.stack([
                torch.where((flat == r)[:, None], rows, 0.0).sum(0)
                for r in range(ctx.num_rows)])
            return None, summed.to(grad.dtype)
        sorted_ids, order = torch.sort(flat, stable=True)
        offsets = torch.searchsorted(
            sorted_ids, torch.arange(ctx.num_rows + 1, device=ids.device,
                                     dtype=sorted_ids.dtype))
        summed = torch.segment_reduce(rows.index_select(0, order), "sum",
                                      offsets=offsets, axis=0, unsafe=True,
                                      initial=0)
        return None, summed.to(grad.dtype)


def embedding(ids, weight):
    """Rows of ``weight`` at ``ids``, with a deterministic backward."""
    return _Embedding.apply(ids, weight)


class Embedding(nn.Module):
    """Token/position lookup table ``(num_embeddings, embedding_dim)``;
    its gradient is bit-reproducible (:func:`embedding`). Rows at
    ``padding_idx`` come out zero; ``weight_init`` replaces the default
    normal draw of standard deviation ``init_std``. ``sharding`` is
    the table's hint (the reference's default: rows split over "tp");
    ``tp`` holds its role under a sharded placement."""

    tp = None

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, weight_init=None, *,
                 init_std: float = 0.02, sharding=VOCAB, device=None,
                 dtype=None):
        super().__init__()
        self.padding_idx, self.weight_init = padding_idx, weight_init
        self.init_std = init_std
        self.param_sharding = {"weight": None if sharding is None
                               else tuple(sharding)}
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        (self.weight_init or I.normal(0.0, self.init_std))(self.weight,
                                                           generator)

    def forward(self, ids):
        if self.tp is not None:
            out = self.tp.lookup(self, ids)
        else:
            out = embedding(ids, self.weight)
        if self.padding_idx is not None:
            # rows at padding ids come out zero, so the padding row takes
            # no gradient (``ops/nn.py:239``)
            out = out * (ids != self.padding_idx)[..., None].to(out.dtype)
        return out

    def attend(self, x, bias=None):
        """``x @ table^T (+ bias)``: the tied output projection
        ``(..., D) -> (..., V)``."""
        if self.tp is not None:
            return self.tp.attend(self, x, bias)
        out = torch.einsum("bsd,vd->bsv", x, self.weight)
        return out if bias is None else out + bias


def dropout(x, rate: float = 0.5, *, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Upscale-in-train dropout (``ops/nn.py:229``): keep each element
    with probability ``1 - rate`` and divide it by that, zero the rest.
    The identity when not ``training`` or at rate 0. Draws come from
    ``generator`` (the default generator of ``x``'s device when None)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """:func:`dropout` in the module's training mode: the identity in
    ``eval()`` or at rate 0."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return dropout(x, self.rate, training=self.training,
                       generator=generator)


class Conv2D(nn.Module):
    """2-D conv layer over NHWC input (NCHW with ``data_format``), the
    reference's ``Conv2D``. The weight is held as torch's OIHW
    ``(out, in / groups, kh, kw)`` (the reference holds HWIO;
    ``models.convert`` transposes, :meth:`from_jax` too); ``padding`` an
    int, a pair or "SAME"/"VALID"."""

    #: the reference's layout of each parameter that differs from this
    #: module's, for ``models.convert``
    jax_layouts = {"weight": "HWIO"}

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 bias: bool = True, data_format: str = "NHWC", *,
                 weight_init=None, device=None, dtype=None):
        super().__init__()
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        self.weight_init = weight_init
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = (kh, kw)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kh, kw, device=device,
            dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device,
                                              dtype=dtype))
                     if bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """``weight_init`` or the reference's default MSRA-normal weight
        over fan-in ``in / groups * kh * kw``, zero bias."""
        fan_in = self.in_channels // self.groups * math.prod(self.kernel_size)
        (self.weight_init or I.msra_normal(fan_in=fan_in))(self.weight,
                                                           generator)
        if self.bias is not None:
            I.zeros(self.bias)

    def forward(self, x):
        from paddle_tpu_torch.ops import nn as ops_nn
        pad = (self.padding if isinstance(self.padding, str)
               else ops_nn._pair(self.padding))
        nchw = self.data_format == "NCHW"
        out = ops_nn._conv_nd(x if nchw else x.permute(0, 3, 1, 2),
                              self.weight, ops_nn._pair(self.stride), pad,
                              ops_nn._pair(self.dilation), self.groups)
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out if nchw else out.permute(0, 2, 3, 1)

    @classmethod
    def from_jax(cls, params, stride=1, padding=0, dilation=1,
                 groups: int = 1, data_format: str = "NHWC", *,
                 device="cuda") -> "Conv2D":
        """The layer of a reference ``Conv2D``'s parameters ``{"weight":
        HWIO, "bias"?}`` (numpy arrays), on ``device``."""
        from paddle_tpu_torch.core.device import resolve_device
        from paddle_tpu_torch.models.convert import load_jax
        kh, kw, cin, cout = np.shape(params["weight"])
        layer = cls(cin * groups, cout, (kh, kw), stride, padding, dilation,
                    groups, "bias" in params, data_format,
                    device=resolve_device(device))
        return load_jax(layer, params)


class Pool2D(nn.Module):
    """Max/avg pooling layer (``ops.nn.pool2d``), no parameters."""

    def __init__(self, kernel_size=2, stride=None, padding=0,
                 pool_type="max", global_pooling=False, data_format="NHWC"):
        super().__init__()
        self.kw = dict(kernel=kernel_size, stride=stride, padding=padding,
                       pool_type=pool_type, global_pooling=global_pooling,
                       data_format=data_format)

    def forward(self, x):
        from paddle_tpu_torch.ops.nn import pool2d
        return pool2d(x, **self.kw)


class BatchNorm(nn.Module):
    """Batch norm over the channel axis (last for NHWC): ``scale`` and
    ``bias`` parameters, the running ``mean`` and ``variance`` buffers
    (the reference's non-trainable parameters). In training mode a
    forward normalises by the batch and moves the buffers to ``momentum *
    old + (1 - momentum) * batch`` (biased variance): inside
    ``nn.module.capture_state`` it reports the new values to the tape
    (the train step applies them after its update, as the reference's
    state tape does), outside any capture it writes them in place. In
    eval mode it uses them."""

    def __init__(self, num_channels: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, data_format: str = "NHWC", *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.epsilon, self.momentum = epsilon, momentum
        self.data_format = data_format
        self.scale = nn.Parameter(torch.ones(num_channels, **kw))
        self.bias = nn.Parameter(torch.zeros(num_channels, **kw))
        self.register_buffer("mean", torch.zeros(num_channels, **kw))
        self.register_buffer("variance", torch.ones(num_channels, **kw))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        I.ones(self.scale)
        I.zeros(self.bias)
        I.zeros(self.mean)
        I.ones(self.variance)

    def forward(self, x):
        from paddle_tpu_torch.ops.nn import batch_norm
        out, new_mean, new_var = batch_norm(
            x, self.scale, self.bias, self.mean, self.variance,
            epsilon=self.epsilon, momentum=self.momentum,
            training=self.training, data_format=self.data_format)
        if self.training and not report_state(
                self, {"mean": new_mean, "variance": new_var}):
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.variance.copy_(new_var)
        return out
