"""Linear-algebra ops (``paddle_tpu/ops/math.py``): fluid's mul, matmul,
fc and friends. The products are plain large matrix products, left to
``torch.matmul`` / ``torch.einsum`` (the reference leaves them to XLA's
dot); none of them is a Pallas kernel of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op


def _np_mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    xm = np.reshape(x, (int(np.prod(x.shape[:x_num_col_dims])), -1))
    ym = np.reshape(y, (int(np.prod(y.shape[:y_num_col_dims])), -1))
    out = xm @ ym
    return out.reshape(x.shape[:x_num_col_dims] + y.shape[y_num_col_dims:])


@register_op("mul", reference=_np_mul)
def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """Flatten-then-matmul (fluid mul_op: operators/mul_op.cc)."""
    xm = x.reshape(int(np.prod(x.shape[:x_num_col_dims])), -1)
    ym = y.reshape(int(np.prod(y.shape[:y_num_col_dims])), -1)
    out = torch.matmul(xm, ym)
    return out.reshape(tuple(x.shape[:x_num_col_dims])
                       + tuple(y.shape[y_num_col_dims:]))


def _np_matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0):
    if transpose_x:
        x = np.swapaxes(x, -1, -2) if np.ndim(x) > 1 else x
    if transpose_y:
        y = np.swapaxes(y, -1, -2) if np.ndim(y) > 1 else y
    return alpha * np.matmul(x, y)


@register_op("matmul", reference=_np_matmul)
def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0):
    """Batched matmul (fluid matmul_op)."""
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return out


@register_op("dot", reference=lambda x, y: np.sum(x * y, -1, keepdims=True))
def dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


@register_op("bmm", reference=np.matmul)
def bmm(x, y):
    return torch.matmul(x, y)


def _np_fc(x, w, b=None, num_flatten_dims=1):
    out = _np_mul(x, w, num_flatten_dims, 1)
    if b is not None:
        out = out + b
    return out


@register_op("fc", reference=_np_fc)
def fc(x, w, b=None, num_flatten_dims=1):
    """Fully-connected: mul + bias add (the target of fluid's
    fc_fuse_pass)."""
    out = mul(x, w, num_flatten_dims, 1)
    if b is not None:
        out = out + b
    return out


@register_op("addmm", reference=lambda inp, x, y, alpha=1.0, beta=1.0:
             beta * inp + alpha * (x @ y))
def addmm(input, x, y, alpha=1.0, beta=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@register_op("cholesky", reference=np.linalg.cholesky)
def cholesky(x):
    return torch.linalg.cholesky(x)


@register_op("norm", reference=lambda x, axis=-1, epsilon=1e-10:
             x / np.sqrt(np.sum(np.square(x), axis, keepdims=True) + epsilon))
def l2_normalize(x, axis=-1, epsilon=1e-10):
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                           + epsilon)


@register_op("cumsum", reference=lambda x, axis=-1: np.cumsum(x, axis))
def cumsum(x, axis=-1):
    return torch.cumsum(x, dim=axis)


@register_op("einsum", reference=np.einsum)
def einsum(subscripts, *operands):
    return torch.einsum(subscripts, *operands)
