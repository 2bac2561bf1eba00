"""Tensor manipulation ops (``paddle_tpu/ops/tensor.py``): fluid's
concat/split/reshape/transpose/gather/scatter/top_k/argsort/cast/fill
families and the creation and shape-query tail, over tensors.

Differences that follow from PyTorch, each kept to the reference's values:

- Index outputs (``argmax``, ``argsort``, ``top_k``, ``nonzero``,
  ``unique_with_counts``) and integer results (``size``, ``hash``,
  ``cumsum`` of ints) are int64 tensors; the reference's are int32 when
  JAX runs without x64. The values are the same.
- ``top_k`` (and so ``accuracy``) ranks by a stable descending sort:
  among equal values the lower index comes first, as ``lax.top_k``.
- Random ops take a ``torch.Generator`` where the reference takes a
  PRNG key (``gaussian_random``, ``uniform_random``, ``randint``,
  ``randperm``, ``sampling_id``, ``random_crop`` and the
  ``*_batch_size_like`` twins): the same distributions, not JAX's bits.
  Their device is the generator's.
- Creation ops with no tensor input (``fill_constant``, ``range``,
  ``linspace``, ``eye``, ``ones``, ``zeros``) take ``device``, CUDA by
  default (:func:`~paddle_tpu_torch.core.device.resolve_device`).
"""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.registry import register_op


def _axes(axis, ndim):
    """An int or a sequence of ints -> a tuple of non-negative axes."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % ndim for a in axes)


def _long(index):
    return index.long() if isinstance(index, torch.Tensor) else torch.as_tensor(
        index, dtype=torch.long)


@register_op("concat", reference=lambda xs, axis=0: np.concatenate(xs, axis))
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=axis)


@register_op("split")
def split(x, num_or_sections, axis=0):
    """fluid split_op: int -> equal parts; list -> section sizes."""
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"split: axis {axis} of {tuple(x.shape)} does "
                             f"not divide into {num_or_sections} parts")
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    return list(torch.split(x, list(num_or_sections), dim=axis))


@register_op("stack", reference=lambda xs, axis=0: np.stack(xs, axis))
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=axis)


@register_op("unstack", has_grad=True)
def unstack(x, axis=0):
    return list(torch.unbind(x, dim=axis))


@register_op("reshape", reference=lambda x, shape: np.reshape(x, shape))
def reshape(x, shape):
    return torch.reshape(x, tuple(shape))


@register_op("squeeze", reference=lambda x, axes=None: np.squeeze(x, tuple(axes) if axes else None))
def squeeze(x, axes=None):
    if not axes:
        return torch.squeeze(x)
    axes = _axes(axes, x.ndim)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"squeeze: axis {a} of {tuple(x.shape)} is not 1")
    return torch.squeeze(x, dim=axes)


@register_op("unsqueeze", reference=lambda x, axes: np.expand_dims(x, tuple(axes) if isinstance(axes, (list, tuple)) else axes))
def unsqueeze(x, axes):
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    out_nd = x.ndim + len(axes)
    for a in sorted(a % out_nd for a in axes):
        x = x.unsqueeze(a)
    return x


@register_op("flatten")
def flatten(x, axis=1):
    """fluid flatten_op: collapse dims before/after ``axis`` into a matrix."""
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


@register_op("transpose", reference=lambda x, perm: np.transpose(x, perm))
def transpose(x, perm):
    return x.permute(*perm)


def _sliced(x, axis, s):
    """``x`` sliced by the Python slice ``s`` along ``axis`` (a negative
    step too, which tensor indexing does not take)."""
    if s.step is None or s.step > 0:
        idx = [builtins.slice(None)] * x.ndim
        idx[axis] = s
        return x[tuple(idx)]
    rows = torch.arange(*s.indices(x.shape[axis]), device=x.device)
    return x.index_select(axis, rows)


@register_op("slice")
def slice(x, axes, starts, ends):  # noqa: A001 - fluid op name
    for ax, s, e in zip(axes, starts, ends):
        x = _sliced(x, ax, builtins.slice(s, e))
    return x


@register_op("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    for ax, s, e, st in zip(axes, starts, ends, strides):
        x = _sliced(x, ax, builtins.slice(s, e, st))
    return x


def _take(x, index, axis):
    """``jnp.take``: out shape x.shape[:axis] + index.shape +
    x.shape[axis+1:]."""
    axis %= x.ndim
    index = _long(index).to(x.device)
    out = x.index_select(axis, index.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


@register_op("gather", reference=lambda x, index: np.take(x, index, 0))
def gather(x, index, axis=0):
    return _take(x, index, axis)


@register_op("gather_nd")
def gather_nd(x, index):
    return x[tuple(_long(index).unbind(-1))]


@register_op("scatter")
def scatter(x, index, updates, overwrite=True):
    """fluid scatter_op: write rows of ``updates`` at ``index``."""
    return x.index_put((_long(index),), updates, accumulate=not overwrite)


@register_op("scatter_nd_add")
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(_long(index).unbind(-1)), updates,
                       accumulate=True)


@register_op("top_k", has_grad=False)
def top_k(x, k):
    """The ``k`` largest along the last axis, largest first, and their
    indices; ties keep the lower index first (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("argsort", has_grad=False,
             reference=lambda x, axis=-1: (np.sort(x, axis), np.argsort(x, axis, kind="stable")))
def argsort(x, axis=-1):
    return tuple(torch.sort(x, dim=axis, stable=True))


@register_op("argmax", has_grad=False, reference=lambda x, axis=-1: np.argmax(x, axis))
def argmax(x, axis=-1):
    return torch.argmax(x, dim=axis)


@register_op("argmin", has_grad=False, reference=lambda x, axis=-1: np.argmin(x, axis))
def argmin(x, axis=-1):
    return torch.argmin(x, dim=axis)


@register_op("cast", reference=lambda x, dtype: np.asarray(x).astype(dtype))
def cast(x, dtype):
    return x.to(convert_dtype(dtype))


@register_op("fill_constant", has_grad=False)
def fill_constant(shape, dtype, value, *, device="cuda"):
    return torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                      device=resolve_device(device))


@register_op("zeros_like", has_grad=False, reference=np.zeros_like)
def zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like", has_grad=False, reference=np.ones_like)
def ones_like(x):
    return torch.ones_like(x)


@register_op("assign", reference=np.asarray)
def assign(x):
    return x.clone() if isinstance(x, torch.Tensor) else torch.as_tensor(x)


@register_op("expand", reference=lambda x, times: np.tile(x, times))
def expand(x, expand_times):
    return torch.tile(x, tuple(expand_times))


@register_op("expand_as")
def expand_as(x, target):
    return torch.broadcast_to(x, target.shape)


@register_op("tile", reference=np.tile)
def tile(x, reps):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


@register_op("where", reference=np.where)
def where(cond, x, y):
    return torch.where(cond, x, y)


@register_op("masked_select", has_grad=False)
def masked_select(x, mask, size=None):
    """Static-shape variant (the reference's): requires ``size``; the
    first ``size`` selected values, padded with x's first value (the
    reference's fill index 0)."""
    if size is None:
        raise ValueError("masked_select needs a static `size`")
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)[:size]
    idx = F.pad(idx, (0, size - idx.numel()))
    return x.reshape(-1)[idx]


@register_op("range", has_grad=False, reference=lambda s, e, st: np.arange(s, e, st))
def arange(start, end, step=1, dtype=torch.int32, *, device="cuda"):
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=resolve_device(device))


@register_op("linspace", has_grad=False)
def linspace(start, stop, num, dtype=torch.float32, *, device="cuda"):
    return torch.linspace(start, stop, num, dtype=convert_dtype(dtype),
                          device=resolve_device(device))


@register_op("shape", has_grad=False)
def shape(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@register_op("eye", has_grad=False)
def eye(num_rows, num_cols=None, dtype=torch.float32, *, device="cuda"):
    return torch.eye(num_rows, num_rows if num_cols is None else num_cols,
                     dtype=convert_dtype(dtype), device=resolve_device(device))


@register_op("diag", has_grad=False)
def diag(x):
    return torch.diag(x)


@register_op("flip", reference=lambda x, axis: np.flip(x, axis))
def flip(x, axis):
    return torch.flip(x, _axes(axis, x.ndim))


@register_op("roll")
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@register_op("clip_by_norm")
def clip_by_norm(x, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


@register_op("isfinite", has_grad=False, reference=np.isfinite)
def isfinite(x):
    return torch.isfinite(x)


@register_op("isnan", has_grad=False, reference=np.isnan)
def isnan(x):
    return torch.isnan(x)


@register_op("increment")
def increment(x, value=1.0):
    return x + value


@register_op("accuracy", has_grad=False)
def accuracy(logits_or_topk, label, k=1):
    """fluid accuracy_op (operators/metrics/accuracy_op)."""
    _, pred = top_k(logits_or_topk, k)
    lbl = label.reshape(-1, 1)
    correct = torch.any(pred == lbl, dim=1)
    return torch.mean(correct.to(torch.float32))


# -- tensor long tail (root-op breadth) -------------------------------------

@register_op("tril", reference=lambda x, diagonal=0: np.tril(x, diagonal))
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@register_op("triu", reference=lambda x, diagonal=0: np.triu(x, diagonal))
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@register_op("meshgrid", has_grad=False)
def meshgrid(*xs, indexing="ij"):
    """fluid meshgrid_op (default 'ij' like the reference)."""
    return list(torch.meshgrid(*xs, indexing=indexing))


@register_op("kron", reference=np.kron)
def kron(x, y):
    return torch.kron(x, y)


@register_op("unique", has_grad=False)
def unique(x, return_counts=False):
    """fluid unique_op: sorted unique values (+ counts)."""
    return torch.unique(x.reshape(-1), sorted=True,
                        return_counts=return_counts)


@register_op("nonzero", has_grad=False)
def nonzero(x):
    """where_index_op: indices of nonzero elements, (N, ndim)."""
    return torch.nonzero(x)


@register_op("index_select",
             reference=lambda x, index, axis=0: np.take(x, index, axis))
def index_select(x, index, axis=0):
    return _take(x, index, axis)


@register_op("index_sample", reference=lambda x, index:
             np.take_along_axis(x, index, axis=1))
def index_sample(x, index):
    """index_sample_op: per-row gather — out[i, j] = x[i, index[i, j]]."""
    return torch.gather(x, 1, _long(index).to(x.device))


@register_op("multiplex", reference=lambda index, *xs:
             np.stack(xs)[index.ravel(), np.arange(index.size)])
def multiplex(index, *xs):
    """multiplex_op: row i of the output comes from candidate xs[index[i]]."""
    stacked = torch.stack(xs)                    # (C, B, ...)
    idx = _long(index).reshape(-1).to(stacked.device)
    return stacked[idx, torch.arange(idx.shape[0], device=stacked.device)]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@register_op("unfold", reference=None)
def unfold(x, kernel_size, stride=1, padding=0, dilation=1):
    """unfold_op (im2col): (N, C, H, W) -> (N, C*kh*kw, L), NCHW."""
    n, c, h, w = x.shape
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    xp = F.pad(x, (pw, pw, ph, ph))
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    cols = []
    for i in range(kh):
        for j in range(kw):
            cols.append(xp[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                           j * dw:j * dw + (ow - 1) * sw + 1:sw])
    out = torch.stack(cols, dim=2)               # (N, C, kh*kw, oh, ow)
    return out.reshape(n, c * kh * kw, oh * ow)


@register_op("pixel_shuffle", reference=None)
def pixel_shuffle(x, upscale_factor):
    """pixel_shuffle_op: (N, C*r^2, H, W) -> (N, C, H*r, W*r) (NCHW)."""
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@register_op("shuffle_channel", reference=None)
def shuffle_channel(x, group):
    """shuffle_channel_op (ShuffleNet): (N, C, H, W) group interleave."""
    n, c, h, w = x.shape
    x = x.reshape(n, group, c // group, h, w)
    return x.permute(0, 2, 1, 3, 4).reshape(n, c, h, w)


@register_op("temporal_shift", reference=None)
def temporal_shift(x, seg_num, shift_ratio=0.25):
    """temporal_shift_op (TSM): x (N*T, C, H, W); shift 1/4 channels one
    frame back, 1/4 one frame forward, rest unchanged."""
    nt, c, h, w = x.shape
    t = seg_num
    n = nt // t
    x = x.reshape(n, t, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    back = torch.cat([x[:, 1:, :c1], torch.zeros_like(x[:, :1, :c1])], dim=1)
    fwd = torch.cat([torch.zeros_like(x[:, :1, c1:c2]), x[:, :-1, c1:c2]],
                    dim=1)
    out = torch.cat([back, fwd, x[:, :, c2:]], dim=2)
    return out.reshape(nt, c, h, w)


@register_op("crop", reference=None)
def crop(x, offsets, shape):
    """crop_op / crop_tensor_op: a slice of ``shape`` at ``offsets``,
    clamped into ``x`` (``lax.dynamic_slice``)."""
    for ax, (o, s) in enumerate(zip(offsets, shape)):
        o = builtins.min(builtins.max(int(o), 0), x.shape[ax] - s)
        x = x.narrow(ax, o, s)
    return x


def _random_device(generator, device):
    """Where a random op's output lies: its generator's device, else
    ``device`` (the card unless the caller asks for the CPU)."""
    return generator.device if generator is not None else resolve_device(
        device)


@register_op("gaussian_random", has_grad=False)
def gaussian_random(generator, shape, mean=0.0, std=1.0, dtype=torch.float32,
                    *, device="cuda"):
    """gaussian_random_op with an explicit ``torch.Generator`` (the
    reference's PRNG key); the output lies on its device, or on
    ``device`` without one."""
    dev = _random_device(generator, device)
    return mean + std * torch.randn(tuple(shape), generator=generator,
                                    device=dev, dtype=convert_dtype(dtype))


@register_op("uniform_random", has_grad=False)
def uniform_random(generator, shape, min=-1.0, max=1.0, dtype=torch.float32,
                   *, device="cuda"):
    dev = _random_device(generator, device)
    u = torch.rand(tuple(shape), generator=generator, device=dev,
                   dtype=convert_dtype(dtype))
    return min + (max - min) * u


@register_op("randint", has_grad=False)
def randint(generator, low, high, shape, *, device="cuda"):
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=_random_device(generator, device))


@register_op("randperm", has_grad=False)
def randperm(generator, n, *, device="cuda"):
    return torch.randperm(n, generator=generator,
                          device=_random_device(generator, device))


@register_op("shard_index", has_grad=False)
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    """shard_index_op (PS-world id localization): ids owned by this shard
    map to local ids, others to ignore_value."""
    shard_size = (index_num + nshards - 1) // nshards
    owner = torch.div(x, shard_size, rounding_mode="floor")
    local = torch.remainder(x, shard_size)
    return torch.where(owner == shard_id, local,
                       torch.full_like(local, ignore_value))


# ---------------------------------------------------------------------------
# creation / shape-query tail (fill_constant_op.cc, scale_op.cc,
# sign_op.cc, rank/size/sum surfaces of fluid layers/tensor.py)
# ---------------------------------------------------------------------------

@register_op("ones", reference=None, has_grad=False)
def ones(shape, dtype=torch.float32, *, device="cuda"):
    """layers.ones (fill_constant value=1)."""
    return torch.ones(tuple(shape), dtype=convert_dtype(dtype),
                      device=resolve_device(device))


@register_op("zeros", reference=None, has_grad=False)
def zeros(shape, dtype=torch.float32, *, device="cuda"):
    """layers.zeros (fill_constant value=0)."""
    return torch.zeros(tuple(shape), dtype=convert_dtype(dtype),
                       device=resolve_device(device))


@register_op("scale", reference=None)
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    """scale_op: x*s + b (or (x+b)*s)."""
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@register_op("sign", reference=np.sign)
def sign(x):
    """sign_op."""
    return torch.sign(x)


@register_op("rank", reference=None, has_grad=False)
def rank(x):
    """layers.rank: 0-d int tensor with the rank."""
    return torch.tensor(x.ndim, dtype=torch.int32, device=x.device)


@register_op("size", reference=None, has_grad=False)
def size(x):
    """size_op: total element count (int64)."""
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@register_op("sum", reference=None)
def sum_op(xs):
    """sum_op: elementwise sum of a LIST of tensors (grad fan-out)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


sums = sum_op  # layers.sums alias


def _batch_shape(ref, shape, input_dim_idx, output_dim_idx):
    shape = list(shape)
    shape[output_dim_idx] = ref.shape[input_dim_idx]
    return tuple(shape)


@register_op("fill_constant_batch_size_like", reference=None,
             has_grad=False)
def fill_constant_batch_size_like(ref, shape, value, dtype=torch.float32,
                                  input_dim_idx=0, output_dim_idx=0):
    """fill_constant_batch_size_like_op: shape with one dim copied from a
    reference tensor's batch dim (on ``ref``'s device)."""
    return torch.full(_batch_shape(ref, shape, input_dim_idx, output_dim_idx),
                      value, dtype=convert_dtype(dtype), device=ref.device)


@register_op("gaussian_random_batch_size_like", reference=None,
             has_grad=False)
def gaussian_random_batch_size_like(ref, shape, generator, mean=0.0, std=1.0,
                                    input_dim_idx=0, output_dim_idx=0):
    """gaussian_random_batch_size_like_op (explicit generator; without
    one, on ``ref``'s device)."""
    return gaussian_random(generator, _batch_shape(
        ref, shape, input_dim_idx, output_dim_idx), mean, std,
        device=ref.device)


@register_op("uniform_random_batch_size_like", reference=None,
             has_grad=False)
def uniform_random_batch_size_like(ref, shape, generator, min=-1.0, max=1.0,
                                   input_dim_idx=0, output_dim_idx=0):
    """uniform_random_batch_size_like_op (without a generator, on
    ``ref``'s device)."""
    return uniform_random(generator, _batch_shape(
        ref, shape, input_dim_idx, output_dim_idx), min, max,
        device=ref.device)


@register_op("reverse", reference=None)
def reverse(x, axis):
    """reverse_op: flip along the given axes."""
    return torch.flip(x, _axes(axis, x.ndim))


@register_op("is_empty", reference=None, has_grad=False)
def is_empty(x):
    """is_empty_op."""
    return torch.tensor(x.numel() == 0, device=x.device)


@register_op("has_inf", reference=None, has_grad=False)
def has_inf(x):
    """isfinite_op variant: any(|x| == inf)."""
    return torch.isinf(x).any()


@register_op("has_nan", reference=None, has_grad=False)
def has_nan(x):
    """isfinite_op variant: any(x != x)."""
    return torch.isnan(x).any()


@register_op("sampling_id", reference=None, has_grad=False)
def sampling_id(probs, generator):
    """sampling_id_op: sample a column index per row of a probability
    matrix (explicit generator; the reference's key)."""
    return torch.multinomial(torch.clamp(probs, min=1e-20), 1,
                             generator=generator)[:, 0]


@register_op("random_crop", reference=None, has_grad=False)
def random_crop(x, crop_shape, generator):
    """random_crop_op: per-sample offsets (not shared across dim 0), as
    the reference's."""
    ndim = len(crop_shape)
    outs = []
    for img in x:
        starts = [int(torch.randint(0, img.shape[i] - crop_shape[i] + 1, (),
                                    generator=generator,
                                    device=_random_device(generator,
                                                          x.device)))
                  for i in range(ndim)]
        for i, (s, n) in enumerate(zip(starts, crop_shape)):
            img = img.narrow(i, s, n)
        outs.append(img)
    return torch.stack(outs)


@register_op("pad_constant_like", reference=None)
def pad_constant_like(ref, x, pad_value=0.0):
    """pad_constant_like_op: pad x up to ref's shape (trailing pads)."""
    pads = []
    for r, s in reversed(list(zip(ref.shape, x.shape))):
        pads += [0, r - s]
    return F.pad(x, pads, value=pad_value)


@register_op("scatter_nd", reference=None)
def scatter_nd(index, updates, shape):
    """scatter_nd_op: zeros(shape) with updates added at index rows."""
    out = torch.zeros(tuple(shape), dtype=updates.dtype, device=updates.device)
    return out.index_put(tuple(_long(index).unbind(-1)), updates,
                         accumulate=True)


@register_op("unique_with_counts", reference=None, has_grad=False)
def unique_with_counts(x, *, size=None):
    """unique_with_counts_op with the reference's static shapes: ``size``
    bounds the output (default len(x)); absent slots hold the first
    value of x and zero counts."""
    size = size or x.shape[0]
    uniq, idx, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True)
    uniq, counts = uniq[:size], counts[:size]
    pad = size - uniq.numel()
    uniq = torch.cat([uniq, x[:1].expand(pad)])
    counts = F.pad(counts, (0, pad))
    return uniq, idx, counts


_MASK32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """``a * c`` mod 2^32 for int64 ``a`` in [0, 2^32) (halves of c keep
    every product below 2^48)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


@register_op("hash", reference=None, has_grad=False)
def hash_op(x, mod_by=100000007, num_hash=1):
    """hash_op (Pyramid hash trick): the reference's multiplicative uint32
    hash (knuth constants), computed in int64 with 32-bit wrapping; the
    reference's values, as int64."""
    x = x.to(torch.int64) & _MASK32
    outs = []
    for i in range(num_hash):
        h = (_mul32(x, 2654435761) + ((i * 0x9E3779B9) & _MASK32)) & _MASK32
        h = h ^ (h >> 16)
        h = _mul32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        outs.append(h % mod_by)
    return outs[0] if num_hash == 1 else torch.stack(outs, -1)


def crop_tensor(x, shape, offsets=None):
    """layers.crop_tensor (crop_tensor_op): static-offset crop."""
    offsets = offsets or [0] * x.ndim
    for ax, (o, s) in enumerate(zip(offsets, shape)):
        x = x.narrow(ax, o, s)
    return x
