"""Neural-net ops (``paddle_tpu/ops/nn.py``): conv, pooling,
normalization, embedding, resize and sampling, and the losses, under the
reference's registered names.

The ops keep the reference's interface, so the same arrays reach both
packages:

- images are NHWC (NDHWC in 3-D) by default and NCHW where the reference
  takes ``data_format="NCHW"``; conv weights are HWIO (DHWIO). Inside,
  the ops permute to torch's NCHW/OIHW and call ``F.conv2d`` and friends.
- ``padding`` is an int, a pair or ``"SAME"``/``"VALID"`` as XLA reads
  them (SAME puts the odd pixel after).
- Pooling pads max windows with -inf and divides an average by the cells
  of the window inside the image (``count_include_pad=False``);
  ``ceil_mode`` is accepted and unused, as in the reference.
- ``interpolate`` and the resize aliases are ``jax.image.resize``:
  half-pixel centres, nearest by ``floor``, and linear through a weight
  matrix per axis that widens its triangle kernel when it shrinks (the
  antialiasing ``F.interpolate`` lacks).
- ``batch_norm`` uses the biased variance and returns ``(out, new_mean,
  new_var)`` with ``momentum`` weighting the old statistic.
- Random ops (``dropout``, ``nce``, ``sampled_softmax_with_cross_entropy``)
  take a ``torch.Generator`` where the reference takes a PRNG key: the
  same distributions, not JAX's bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _to_nhwc(x, data_format):
    return x.permute(0, 2, 3, 1) if data_format == "NCHW" else x


def _from_nhwc(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NCHW" else x


def _channels_first(x):
    """N...C -> NC... (NHWC -> NCHW, NDHWC -> NCDHW)."""
    return x.movedim(-1, 1)


def _channels_last(x):
    return x.movedim(1, -1)


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's SAME padding per spatial axis: ``(lo, hi)``, the odd pixel
    after."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv_nd(x_cf, w, stride, padding, dilation, groups):
    """``F.conv{2,3}d`` on channels-first ``x_cf`` and OI... ``w`` with
    XLA's padding rules (explicit pairs, SAME or VALID). Symmetric pads go
    to the conv's own ``padding=`` (the same numbers; an ``F.pad`` first
    would copy a channels-last activation into a contiguous NCHW one and
    take cuDNN off the channels-last layout); only SAME's uneven pads go
    through ``F.pad``, and so does a bfloat16 conv on the CPU: there
    oneDNN's bf16 weight gradient of a padded strided conv whose output
    is one pixel wide (a 3x3 stride-2 conv over a 1x1 map, ResNet's last
    stage at small inputs) reads memory it never wrote, so stale NaN in
    the allocator's freed blocks came out in the gradient."""
    nd = x_cf.ndim - 2
    k = tuple(w.shape[2:])
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0)] * nd
        else:
            pads = _same_pads(x_cf.shape[2:], k, stride, dilation)
    else:
        pads = [(p, p) for p in padding]
    conv = F.conv2d if nd == 2 else F.conv3d
    cpu_bf16 = x_cf.device.type == "cpu" and x_cf.dtype == torch.bfloat16
    if all(lo == hi for lo, hi in pads) and not cpu_bf16:
        return conv(x_cf, w, stride=stride, padding=[lo for lo, _ in pads],
                    dilation=dilation, groups=groups)
    x_cf = F.pad(x_cf, [v for lo_hi in reversed(pads) for v in lo_hi])
    return conv(x_cf, w, stride=stride, dilation=dilation, groups=groups)


@register_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NHWC"):
    """2-D convolution. ``weight`` HWIO (filter_h, filter_w,
    in_channels / groups, out_channels); ``padding`` an int, a pair or
    "SAME"/"VALID"."""
    x = _to_nhwc(x, data_format)
    pad = padding if isinstance(padding, str) else _pair(padding)
    out = _conv_nd(_channels_first(x), weight.permute(3, 2, 0, 1),
                   _pair(stride), pad, _pair(dilation), groups)
    out = _channels_last(out)
    if bias is not None:
        out = out + bias
    return _from_nhwc(out, data_format)


@register_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     data_format="NHWC"):
    """Transposed conv (``conv2d_transpose_op``), the gradient of a conv
    with respect to its input: out = (H - 1) * stride + k - 2 * padding.
    ``weight`` HWIO with I the input's channels."""
    x = _to_nhwc(x, data_format)
    out = F.conv_transpose2d(_channels_first(x), weight.permute(2, 3, 0, 1),
                             stride=_pair(stride), padding=_pair(padding))
    out = _channels_last(out)
    if bias is not None:
        out = out + bias
    return _from_nhwc(out, data_format)


@register_op("depthwise_conv2d")
def depthwise_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     data_format="NHWC"):
    """Depthwise conv: ``weight`` HWI1 (or HWIM), one group per input
    channel."""
    channels = weight.shape[2]
    w = weight.reshape(weight.shape[0], weight.shape[1], 1,
                       channels * weight.shape[3])
    return conv2d(x, w, bias, stride, padding, dilation, groups=channels,
                  data_format=data_format)


def _pool_nd(x_cl, kernel, stride, padding, pool_type):
    """Max or average pooling of channels-last ``x_cl`` (N, *spatial, C):
    max windows padded with -inf, averages over the cells inside."""
    nd = len(kernel)
    flat = [v for p in reversed(padding) for v in (p, p)]
    x_cf = _channels_first(x_cl)
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    avg = F.avg_pool2d if nd == 2 else F.avg_pool3d
    if pool_type == "max":
        if any(flat):
            x_cf = F.pad(x_cf, flat, value=-math.inf)
        return _channels_last(pool(x_cf, kernel, stride))
    if pool_type != "avg":
        raise ValueError(f"unknown pool_type {pool_type!r}")
    if not any(flat):
        return _channels_last(avg(x_cf, kernel, stride))
    size = math.prod(kernel)
    sums = avg(F.pad(x_cf, flat), kernel, stride) * size
    ones = F.pad(torch.ones((1, 1) + tuple(x_cl.shape[1:-1]),
                            dtype=x_cl.dtype, device=x_cl.device), flat)
    counts = avg(ones, kernel, stride) * size
    return _channels_last(sums / counts)


@register_op("pool2d")
def pool2d(x, kernel=2, stride=None, padding=0, pool_type="max",
           ceil_mode=False, data_format="NHWC", global_pooling=False):
    """Max/avg pooling (``pool2d_op``); ``ceil_mode`` is unused, as in
    the reference."""
    del ceil_mode
    x = _to_nhwc(x, data_format)
    if global_pooling:
        kernel = (x.shape[1], x.shape[2])
        stride, padding = kernel, 0
    kernel = _pair(kernel)
    stride = _pair(stride if stride is not None else kernel)
    out = _pool_nd(x, kernel, stride, _pair(padding), pool_type)
    return _from_nhwc(out, data_format)


@register_op("adaptive_pool2d")
def adaptive_pool2d(x, output_size, pool_type="avg", data_format="NHWC"):
    """Adaptive pooling over divisible sizes (the reference raises
    otherwise)."""
    x = _to_nhwc(x, data_format)
    oh, ow = _pair(output_size)
    n, h, w, c = x.shape
    if h % oh or w % ow:
        raise NotImplementedError("adaptive pool requires divisible sizes")
    x = x.reshape(n, oh, h // oh, ow, w // ow, c)
    out = x.amax(dim=(2, 4)) if pool_type == "max" else x.mean(dim=(2, 4))
    return _from_nhwc(out, data_format)


def _np_softmax(x, axis=-1):
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / np.sum(e, axis=axis, keepdims=True)


@register_op("softmax", reference=_np_softmax)
def softmax(x, axis=-1):
    """Numerically stable softmax (``softmax_op``)."""
    return torch.softmax(x, dim=axis)


@register_op("log_softmax",
             reference=lambda x, axis=-1: np.log(_np_softmax(x, axis)))
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def _np_layer_norm(x, scale=None, bias=None, epsilon=1e-5,
                   begin_norm_axis=1):
    axes = tuple(range(begin_norm_axis, np.ndim(x)))
    mean = np.mean(x, axis=axes, keepdims=True)
    var = np.var(x, axis=axes, keepdims=True)
    out = (x - mean) / np.sqrt(var + epsilon)
    if scale is not None:
        out = out * np.reshape(scale, x.shape[begin_norm_axis:])
    if bias is not None:
        out = out + np.reshape(bias, x.shape[begin_norm_axis:])
    return out


@register_op("layer_norm", reference=_np_layer_norm)
def layer_norm(x, scale=None, bias=None, epsilon=1e-5, begin_norm_axis=-1):
    """Layer normalization over the axes from ``begin_norm_axis`` on:
    biased variance, ``epsilon`` inside the rsqrt."""
    if begin_norm_axis < 0:
        begin_norm_axis = x.ndim + begin_norm_axis
    axes = tuple(range(begin_norm_axis, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        out = out * scale.reshape(x.shape[begin_norm_axis:])
    if bias is not None:
        out = out + bias.reshape(x.shape[begin_norm_axis:])
    return out


@register_op("batch_norm")
def batch_norm(x, scale, bias, mean, variance, epsilon=1e-5, momentum=0.9,
               training=False, data_format="NHWC"):
    """Batch normalization (``batch_norm_op``): ``(out, new_mean,
    new_variance)``. Training normalises by the batch's mean and biased
    variance and moves the running statistics to ``momentum * old + (1 -
    momentum) * batch``; inference uses and returns the running ones.
    Channels are last for NHWC, axis 1 for NCHW."""
    caxis = 1 if data_format == "NCHW" else x.ndim - 1
    shape = [1] * x.ndim
    shape[caxis] = x.shape[caxis]
    axes = tuple(i for i in range(x.ndim) if i != caxis)
    if training:
        batch_mean = x.mean(dim=axes)
        batch_var = x.var(dim=axes, unbiased=False)
        new_mean = momentum * mean + (1 - momentum) * batch_mean
        new_var = momentum * variance + (1 - momentum) * batch_var
        use_mean, use_var = batch_mean, batch_var
    else:
        new_mean, new_var = mean, variance
        use_mean, use_var = mean, variance
    inv = torch.rsqrt(use_var + epsilon) * scale
    out = (x - use_mean.reshape(shape)) * inv.reshape(shape) \
        + bias.reshape(shape)
    return out, new_mean, new_var


@register_op("dropout")
def dropout(x, generator, rate=0.5, training=True):
    """Upscale-in-train dropout with an explicit ``torch.Generator`` (the
    reference's key; None draws from the device's default generator)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


@register_op("lookup_table", has_grad=True)
def embedding(ids, table, padding_idx=None):
    """Embedding lookup (``lookup_table_op``); rows at ``padding_idx``
    come out zero. The gradient sums each row's contributions in a fixed
    order (:func:`paddle_tpu_torch.nn.layers.embedding`)."""
    from paddle_tpu_torch.nn.layers import embedding as lookup
    out = lookup(ids.long(), table)
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


@register_op("one_hot", has_grad=False,
             reference=lambda ids, depth: np.eye(depth)[np.asarray(ids)])
def one_hot(ids, depth):
    """float32 one-hot rows (``jax.nn.one_hot``: an id outside ``[0,
    depth)`` gives a zero row)."""
    ids = ids.long()
    inside = (ids >= 0) & (ids < depth)
    out = F.one_hot(torch.where(inside, ids, 0), depth).to(torch.float32)
    return out * inside[..., None]


# -- losses -------------------------------------------------------------------

def _np_cross_entropy(logp_or_probs, label, soft_label=False):
    x = np.asarray(logp_or_probs)
    if soft_label:
        return -np.sum(label * np.log(x), axis=-1, keepdims=True)
    lbl = np.asarray(label).reshape(-1)
    flat = x.reshape(-1, x.shape[-1])
    picked = flat[np.arange(flat.shape[0]), lbl]
    return -np.log(picked).reshape(x.shape[:-1] + (1,))


def _hard_label(label, ndim):
    """int64 labels without fluid's trailing (N, 1) axis."""
    lbl = label.long()
    return lbl.squeeze(-1) if lbl.ndim == ndim else lbl


@register_op("cross_entropy", reference=_np_cross_entropy)
def cross_entropy(probs, label, soft_label=False, epsilon=1e-12):
    """Cross entropy over probabilities (``cross_entropy_op``)."""
    logp = torch.log(torch.clamp(probs, epsilon, 1.0))
    if soft_label:
        return -(label * logp).sum(-1, keepdim=True)
    lbl = _hard_label(label, probs.ndim)
    return -torch.gather(logp, -1, lbl[..., None])


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               return_softmax=False, ignore_index=None):
    """Fused softmax and cross entropy (``softmax_with_cross_entropy_op``):
    (..., 1) losses, 0 where the label is ``ignore_index``."""
    logp = torch.log_softmax(logits, dim=-1)
    if soft_label:
        loss = -(label * logp).sum(-1, keepdim=True)
    else:
        lbl = _hard_label(label, logits.ndim)
        loss = -torch.gather(logp, -1, lbl[..., None])
        if ignore_index is not None:
            loss = torch.where(lbl[..., None] == ignore_index,
                               torch.zeros_like(loss), loss)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(x: torch.Tensor,
                                      label: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) - x * z + log(1 + exp(-|x|))`` elementwise (fluid's op
    of the same name), written as the reference writes it."""
    return torch.clamp(x, min=0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))


@register_op("square_error_cost",
             reference=lambda x, y: np.square(np.asarray(x) - np.asarray(y)))
def square_error_cost(input, label):
    return torch.square(input - label)


@register_op("smooth_l1", reference=None)
def smooth_l1(x, y, sigma=1.0):
    diff = torch.abs(x - y)
    s2 = sigma * sigma
    return torch.where(diff < 1.0 / s2, 0.5 * s2 * diff * diff,
                       diff - 0.5 / s2)


@register_op("kldiv_loss")
def kldiv_loss(x, target, reduction="mean"):
    loss = target * (torch.log(torch.clamp(target, min=1e-12)) - x)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@register_op("margin_rank_loss")
def margin_rank_loss(label, left, right, margin=0.1):
    return torch.clamp(-label * (left - right) + margin, min=0.0)


@register_op("huber_loss")
def huber_loss(input, label, delta=1.0):
    diff = torch.abs(label - input)
    return torch.where(diff <= delta, 0.5 * diff * diff,
                       delta * (diff - 0.5 * delta))


# -- misc nn ------------------------------------------------------------------

@register_op("label_smooth")
def label_smooth(label, epsilon=0.1):
    return label * (1 - epsilon) + epsilon / label.shape[-1]


@register_op("pad", reference=lambda x, paddings, pad_value=0.0:
             np.pad(x, paddings, constant_values=pad_value))
def pad(x, paddings, pad_value=0.0):
    """``np.pad``'s constant mode: ``paddings`` one ``(before, after)`` a
    dimension."""
    flat = [int(v) for p in reversed(list(paddings)) for v in p]
    return F.pad(x, flat, value=pad_value)


def _resize_weights(m: int, n: int) -> np.ndarray:
    """``jax.image.resize``'s linear weight matrix (m, n) from ``m`` input
    to ``n`` output cells, in float32 as it computes it: half-pixel
    sample points, a triangle kernel widened by ``m / n`` when shrinking
    (antialiasing), columns normalised, samples outside the input zero."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n / m)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize(x, size, method):
    """``jax.image.resize(x, x.shape[:1] + size + x.shape[-1:], method)``
    over the spatial axes of channels-last ``x``."""
    method = {"bilinear": "linear", "trilinear": "linear",
              "linear": "linear", "triangle": "linear",
              "nearest": "nearest"}.get(method)
    if method is None:
        raise ValueError("interpolate supports nearest and linear methods")
    for axis, n in enumerate(size, start=1):
        m = x.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            src = np.floor((np.arange(n, dtype=np.float32) + 0.5)
                           * np.float32(m) / np.float32(n)).astype(np.int64)
            x = x.index_select(axis, torch.from_numpy(src).to(x.device))
        else:
            w = torch.from_numpy(_resize_weights(m, n)).to(x.device, x.dtype)
            x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x


@register_op("interpolate", has_grad=True)
def interpolate(x, size, method="nearest", data_format="NHWC"):
    """Image resize as ``jax.image.resize`` (see the module docstring)."""
    x = _to_nhwc(x, data_format)
    return _from_nhwc(_resize(x, _pair(size), method), data_format)


@register_op("grid_sampler", has_grad=True)
def grid_sampler(x, grid, data_format="NCHW"):
    """Bilinear grid sampling (``grid_sampler_op``): ``grid`` (N, Ho, Wo,
    2) of normalised (x, y) in [-1, 1] with align_corners (-1 -> 0, 1 ->
    size - 1), zero outside the image; differentiable in ``x`` and
    ``grid``."""
    nchw = data_format == "NCHW"
    if nchw:
        x = x.permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    xi0, yi0 = x0.long(), y0.long()
    flat = x.reshape(n, h * w, c)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1))
        vals = torch.gather(flat, 1, idx.reshape(n, -1, 1).expand(-1, -1, c))
        vals = vals.reshape(idx.shape + (c,))
        return torch.where(inb[..., None], vals, torch.zeros_like(vals))

    out = (gather(yi0, xi0) * (1 - wy) * (1 - wx)
           + gather(yi0, xi0 + 1) * (1 - wy) * wx
           + gather(yi0 + 1, xi0) * wy * (1 - wx)
           + gather(yi0 + 1, xi0 + 1) * wy * wx)
    return out.permute(0, 3, 1, 2) if nchw else out


# -- nn long tail -------------------------------------------------------------

@register_op("group_norm")
def group_norm(x, scale=None, bias=None, groups=32, epsilon=1e-5,
               data_format="NHWC"):
    """``group_norm_op`` over NHWC (NCHW through ``data_format``)."""
    x = _to_nhwc(x, data_format)
    n, h, w, c = x.shape
    g = x.reshape(n, h, w, groups, c // groups)
    mean = g.mean(dim=(1, 2, 4), keepdim=True)
    var = g.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(n, h, w, c)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return _from_nhwc(out, data_format)


@register_op("instance_norm")
def instance_norm(x, scale=None, bias=None, epsilon=1e-5,
                  data_format="NHWC"):
    """``instance_norm_op``: per (sample, channel) over the image."""
    x = _to_nhwc(x, data_format)
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return _from_nhwc(out, data_format)


@register_op("lrn")
def lrn(x, n=5, k=1.0, alpha=1e-4, beta=0.75, data_format="NHWC"):
    """``lrn_op``: local response norm across channels."""
    x = _to_nhwc(x, data_format)
    half = n // 2
    sq = F.pad(x * x, (half, n - 1 - half))
    window = sum(sq[..., i:i + x.shape[-1]] for i in range(n))
    return _from_nhwc(x / torch.pow(k + alpha * window, beta), data_format)


@register_op("maxout")
def maxout(x, groups, axis=-1):
    """``maxout_op``: axis of C -> C / groups by the max over each
    group."""
    axis = axis % x.ndim
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(dim=axis + 1)


@register_op("pad2d")
def pad2d(x, paddings, mode="constant", pad_value=0.0, data_format="NHWC"):
    """``pad2d_op``: spatial padding (constant, reflect, edge); paddings
    (top, bottom, left, right)."""
    x = _to_nhwc(x, data_format)
    t, b, l, r = (int(p) for p in paddings)
    x_cf = x.permute(0, 3, 1, 2)
    if mode == "constant":
        out = F.pad(x_cf, (l, r, t, b), value=pad_value)
    else:
        out = F.pad(x_cf, (l, r, t, b),
                    mode={"reflect": "reflect", "edge": "replicate"}[mode])
    return _from_nhwc(out.permute(0, 2, 3, 1), data_format)


@register_op("affine_grid")
def affine_grid(theta, out_shape):
    """``affine_grid_op``: theta (N, 2, 3) -> normalised sampling grid
    (N, H, W, 2), align_corners."""
    n, h, w = out_shape[0], out_shape[-2], out_shape[-1]
    dev = theta.device
    ys = torch.linspace(-1.0, 1.0, h, device=dev)
    xs = torch.linspace(-1.0, 1.0, w, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(
        1, h * w, 3).to(theta.dtype)
    grid = torch.einsum("bnk,bjk->bnj", base.expand(n, h * w, 3), theta)
    return grid.reshape(n, h, w, 2)


@register_op("affine_channel")
def affine_channel(x, scale, bias, data_format="NHWC"):
    """``affine_channel_op``: per-channel ``scale * x + bias``."""
    x = _to_nhwc(x, data_format)
    return _from_nhwc(x * scale + bias, data_format)


@register_op("log_loss", reference=lambda pred, label, epsilon=1e-4:
             -label * np.log(pred + epsilon)
             - (1 - label) * np.log(1 - pred + epsilon))
def log_loss(pred, label, epsilon=1e-4):
    return -label * torch.log(pred + epsilon) \
        - (1.0 - label) * torch.log(1.0 - pred + epsilon)


@register_op("rank_loss", reference=lambda label, left, right:
             np.log1p(np.exp(-np.abs(left - right)))
             + np.maximum(left - right, 0) - label * (left - right))
def rank_loss(label, left, right):
    """``rank_loss_op`` (RankNet), in the softplus form."""
    d = left - right
    return torch.logaddexp(d, torch.zeros_like(d)) - label * d


@register_op("hinge_loss", reference=lambda logits, label:
             np.maximum(0.0, 1.0 - (2.0 * label - 1.0) * logits))
def hinge_loss(logits, label):
    return torch.clamp(1.0 - (2.0 * label - 1.0) * logits, min=0.0)


@register_op("cos_sim")
def cos_sim(x, y, epsilon=1e-12):
    """Row-wise cosine similarity (B, D) -> (B, 1)."""
    nx = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    ny = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return (x * y).sum(-1, keepdim=True) / torch.clamp(nx * ny, min=epsilon)


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(x, y, weight, bias=None):
    """``out[:, k] = x W_k y^T``: x (B, M), y (B, N), weight (K, M, N)."""
    out = torch.einsum("bm,kmn,bn->bk", x, weight, y)
    return out if bias is None else out + bias


# -- the loss long tail -------------------------------------------------------

@register_op("mse_loss")
def mse_loss(input, label):
    return ((input - label) ** 2).mean()


@register_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5):
    """1 - 2|X & Y| / (|X| + |Y|) over (N, C) probabilities; ``label``
    (N,) ids or (N, C) one-hot."""
    if label.ndim == input.ndim - 1:
        label = one_hot(label, input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = (input * label).sum(dims)
    union = input.sum(dims) + label.sum(dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


@register_op("bpr_loss")
def bpr_loss(input, label):
    """Bayesian personalised ranking: -mean log sigmoid(score[label] -
    score[j]) over the other columns."""
    n, c = input.shape
    lbl = label.long()
    pos = torch.gather(input, 1, lbl[:, None])
    logsig = F.logsigmoid(pos - input)
    mask = torch.arange(c, device=input.device)[None, :] != lbl[:, None]
    return -(logsig * mask).sum() / (n * (c - 1))


@register_op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Softmax cross entropy over anchor @ positive^T with same-label
    targets, plus L2 on the embeddings."""
    labels = labels.reshape(-1)
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    targets = same / same.sum(-1, keepdim=True)
    ce = -(targets * torch.log_softmax(sim, -1)).sum(-1).mean()
    l2 = (anchor ** 2).sum(-1).mean() + (positive ** 2).sum(-1).mean()
    return ce + l2_reg * 0.25 * l2


@register_op("center_loss")
def center_loss(features, label, centers, alpha=0.1):
    """Pull features toward their class centers: ``(loss (N,), new
    centers)`` (the reference updates the centers in place; here they
    come back, detached)."""
    lbl = label.long()
    diff = features - centers[lbl]
    loss = 0.5 * (diff ** 2).sum(-1)
    counts = torch.zeros(centers.shape[0], dtype=features.dtype,
                         device=features.device).index_add(
        0, lbl, torch.ones_like(lbl, dtype=features.dtype))
    sums = torch.zeros_like(centers).index_add(0, lbl, diff)
    new = centers + alpha * sums / torch.clamp(counts[:, None], min=1.0)
    return loss, new.detach()


@register_op("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss(x, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    x = torch.clamp(x, soft_max_lower_bound, soft_max_up_bound)
    return sigmoid_cross_entropy_with_logits(x, label).mean()


@register_op("sampled_softmax_with_cross_entropy", has_grad=True)
def sampled_softmax_with_cross_entropy(logits_fn, label, generator, *,
                                       num_samples, num_classes):
    """Cross entropy over {true class} and ``num_samples`` uniform
    negatives drawn from ``generator``; ``logits_fn(ids) -> (N, len(ids))``
    computes the sampled columns only. Accidental hits (another column
    with the row's true id) leave the denominator."""
    lbl = label.reshape(-1).long()
    dev = lbl.device
    neg = torch.randint(0, num_classes, (num_samples,), generator=generator,
                        device=dev)
    ids = torch.cat([lbl, neg])
    logits = logits_fn(ids)
    n = lbl.shape[0]
    tgt = torch.arange(n, device=dev)
    hit = (ids[None, :] == lbl[:, None]) & \
        (torch.arange(ids.shape[0], device=dev)[None, :] != tgt[:, None])
    logits = torch.where(hit, torch.full_like(logits, -math.inf), logits)
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, 1, tgt[:, None]).mean()


@register_op("nce")
def nce(emb, weight, bias, label, generator, *, num_neg, num_classes):
    """Noise-contrastive estimation with uniform noise: a binary logistic
    loss on the true class and ``num_neg`` negatives a row, drawn from
    ``generator``. ``emb`` (N, D), ``weight`` (C, D), ``bias`` (C,)."""
    n = emb.shape[0]
    lbl = label.long()
    neg = torch.randint(0, num_classes, (n, num_neg), generator=generator,
                        device=emb.device)
    pos_logit = (emb * weight[lbl]).sum(-1) + bias[lbl]
    neg_logit = torch.einsum("nd,nkd->nk", emb, weight[neg]) + bias[neg]
    log_q = -math.log(float(num_classes))
    pos = F.logsigmoid(pos_logit - log_q)
    negl = F.logsigmoid(-(neg_logit - log_q)).sum(-1)
    return -(pos + negl).mean()


@register_op("hsigmoid")
def hsigmoid(x, weight, bias, label, *, num_classes):
    """Hierarchical sigmoid over the complete binary tree: the label's
    root-to-leaf path from its bits, a logistic loss at each internal
    node on it. ``weight`` (C - 1, D), ``bias`` (C - 1,)."""
    c = num_classes
    depth = int(np.ceil(np.log2(c))) if c > 1 else 1
    cur = label.long() + c
    nodes, codes = [], []
    for _ in range(depth):
        codes.append(cur % 2)
        cur = torch.div(cur, 2, rounding_mode="floor")
        nodes.append(cur)
    nodes = torch.stack(nodes, -1)
    codes = torch.stack(codes, -1).to(x.dtype)
    idx = torch.clamp(nodes - 1, 0, c - 2)
    logits = torch.einsum("nd,nkd->nk", x, weight[idx]) + bias[idx]
    bce = sigmoid_cross_entropy_with_logits(logits, codes)
    return (bce * (nodes >= 1)).sum(-1).mean()


# -- normalization / misc tail ------------------------------------------------

@register_op("data_norm")
def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    """Normalise by running sums (``data_norm_op``): ``(out, new_size,
    new_sum, new_square_sum)``."""
    mean = batch_sum / batch_size
    var = batch_square_sum / batch_size - mean ** 2
    out = (x - mean) / torch.sqrt(var + epsilon)
    return (out, batch_size + x.shape[0], batch_sum + x.sum(0),
            batch_square_sum + (x ** 2).sum(0))


@register_op("spectral_norm")
def spectral_norm(weight, u, *, power_iters=1, epsilon=1e-12):
    """``W / sigma_max(W)`` by power iteration from ``u`` (rows,):
    ``(normalised weight, new u)``, the new ``u`` detached."""
    w = weight.reshape(weight.shape[0], -1)
    v = None
    for _ in range(power_iters):
        v = w.T @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=epsilon)
        u = w @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=epsilon)
    sigma = u @ w @ v
    return weight / sigma, u.detach()


@register_op("add_position_encoding")
def add_position_encoding(x, alpha=1.0, beta=1.0):
    """``x * alpha + beta * sinusoid`` over (B, T, D)."""
    _, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=x.device),
                            2 * i / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], -1)
    return x * alpha + beta * pe[None].to(x.dtype)


@register_op("mean_iou", has_grad=False)
def mean_iou(pred, label, num_classes):
    """Mean intersection over union over the classes present."""
    pred, label = pred.reshape(-1).long(), label.reshape(-1).long()
    dev = pred.device
    hit = (pred == label).to(torch.float32)

    def hist(idx, vals):
        return torch.zeros(num_classes, device=dev).index_add(0, idx, vals)

    inter = hist(torch.where(pred == label, pred, num_classes - 1), hit)
    ones = torch.ones_like(hit)
    union = hist(pred, ones) + hist(label, ones) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(inter))
    return iou.sum() / torch.clamp(present.sum(), min=1)


@register_op("row_conv")
def row_conv(x, weight):
    """Lookahead conv (Deep Speech 2): ``out[t] = sum_k x[t + k] * w[k]``;
    x (B, T, D), weight (K, D)."""
    k = weight.shape[0]
    xp = F.pad(x, (0, 0, 0, k - 1))
    return sum(xp[:, i:i + x.shape[1], :] * weight[i] for i in range(k))


@register_op("im2sequence", has_grad=True)
def im2sequence(x, filter_size, stride=1, padding=0):
    """Each window of an NHWC image flattened to one time step:
    (B, out_h * out_w, C * fh * fw), channel-major as the reference's
    patches."""
    cols = F.unfold(x.permute(0, 3, 1, 2), _pair(filter_size),
                    padding=_pair(padding), stride=_pair(stride))
    return cols.transpose(1, 2)


@register_op("similarity_focus", has_grad=False)
def similarity_focus(x, axis, indexes):
    """Binary mask: for each selected index along ``axis``, the positions
    where that slice reaches its per-sample maximum."""
    out = None
    spatial = tuple(i for i in range(1, x.ndim) if i != axis)
    for idx in indexes:
        sl = x.narrow(axis, idx, 1)
        m = (sl == sl.amax(dim=spatial, keepdim=True)).expand(x.shape)
        out = m if out is None else out | m
    return out.to(x.dtype)


# -- 3-D conv and pooling -----------------------------------------------------

@register_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """NDHWC convolution with a DHWIO weight."""
    pad = padding if isinstance(padding, str) else _triple(padding)
    out = _channels_last(_conv_nd(
        _channels_first(x), weight.permute(4, 3, 0, 1, 2), _triple(stride),
        pad, _triple(dilation), groups))
    return out if bias is None else out + bias


@register_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0):
    """Transposed NDHWC conv (DHWIO weight); integer padding only."""
    if isinstance(padding, str):
        raise ValueError(
            "conv3d_transpose takes integer/tuple padding, not "
            f"{padding!r} (SAME/VALID are ambiguous for deconv)")
    out = _channels_last(F.conv_transpose3d(
        _channels_first(x), weight.permute(3, 4, 0, 1, 2),
        stride=_triple(stride), padding=_triple(padding)))
    return out if bias is None else out + bias


@register_op("pool3d")
def pool3d(x, kernel=2, stride=None, padding=0, pool_type="max"):
    """NDHWC max/avg pooling."""
    kernel = _triple(kernel)
    stride = _triple(stride if stride is not None else kernel)
    if pool_type != "max":
        pool_type = "avg"
    return _pool_nd(x, kernel, stride, _triple(padding), pool_type)


@register_op("adaptive_pool3d")
def adaptive_pool3d(x, output_size, pool_type="avg"):
    """Adaptive 3-D pooling over divisible sizes."""
    od, oh, ow = _triple(output_size)
    b, d, h, w, c = x.shape
    if d % od or h % oh or w % ow:
        raise NotImplementedError(
            "adaptive_pool3d needs divisible spatial dims "
            f"(got {(d, h, w)} -> {(od, oh, ow)})")
    xr = x.reshape(b, od, d // od, oh, h // oh, ow, w // ow, c)
    if pool_type == "max":
        return xr.amax(dim=(2, 4, 6))
    return xr.mean(dim=(2, 4, 6))


# -- image resize aliases -----------------------------------------------------

def resize_bilinear(x, size, data_format="NHWC"):
    """resize_bilinear (``bilinear_interp_op``)."""
    return interpolate(x, size, method="bilinear", data_format=data_format)


def resize_nearest(x, size, data_format="NHWC"):
    """resize_nearest (``nearest_interp_op``)."""
    return interpolate(x, size, method="nearest", data_format=data_format)


def image_resize(x, size, method="bilinear", data_format="NHWC"):
    """layers.image_resize."""
    return interpolate(x, size, method=method, data_format=data_format)


def image_resize_short(x, short_len, method="bilinear"):
    """layers.image_resize_short: scale so the short side is
    ``short_len``."""
    h, w = x.shape[1], x.shape[2]
    if h <= w:
        oh, ow = short_len, int(round(w * short_len / h))
    else:
        oh, ow = int(round(h * short_len / w)), short_len
    return interpolate(x, (oh, ow), method=method)


@register_op("resize_trilinear")
def resize_trilinear(x, size):
    """NDHWC volumetric resize (``trilinear_interp_op``)."""
    size = _triple(size) if not isinstance(size, tuple) else size
    return _resize(x, size, "trilinear")


@register_op("cvm")
def continuous_value_model(x, *, use_cvm=True):
    """``cvm_op``: the leading (show, click) counters become (log(show +
    1), log(click + 1) - log(show + 1)) with ``use_cvm``, else are
    dropped. x (B, D), D >= 2."""
    show = torch.log(x[:, :1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - show
    if use_cvm:
        return torch.cat([show, click, x[:, 2:]], -1)
    return x[:, 2:]


@register_op("filter_by_instag", has_grad=False)
def filter_by_instag(ins, ins_tags, filter_tags):
    """Rows whose tags meet ``filter_tags`` first (stable), with the
    mask and the order: ``(ins[order], keep[order], order)``; -1 pads
    ``ins_tags`` (B, T) and never matches."""
    match = (ins_tags[:, :, None] == filter_tags[None, None, :]) \
        & (filter_tags[None, None, :] >= 0)
    hit = match.any(dim=2).any(dim=1)
    order = torch.argsort((~hit).to(torch.int8), stable=True)
    return ins[order], hit[order], order

