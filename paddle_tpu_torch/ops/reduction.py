"""Reduction ops (``paddle_tpu/ops/reduction.py``): reduce_{sum, mean,
max, min, prod, all, any}, logsumexp and the global mean. ``dim`` is an
int, a list of ints or None (every axis), as fluid's."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op


def _norm_dim(dim):
    if dim is None:
        return None
    if isinstance(dim, (list, tuple)):
        return tuple(dim)
    return (dim,)


def _dims(x, dim):
    """The reduced axes as a tuple of non-negative ints."""
    dims = _norm_dim(dim)
    if dims is None:
        return tuple(range(x.ndim))
    return tuple(sorted(d % x.ndim for d in dims)) if x.ndim else ()


def _float(x):
    """Integer and bool inputs of a mean reduce in float32, as jnp.mean's
    default float type."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _prod(x, dim=None, keepdim=False):
    out = x
    for d in sorted(dim, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _reducer(tfn):
    def fn(x, dim=None, keepdim=False):
        dims = _dims(x, dim)
        if not dims:
            return x.clone()
        return tfn(x, dim=dims, keepdim=keepdim)
    return fn


def _make(name, tfn, nfn, has_grad=True):
    def ref(x, dim=None, keep_dim=False):
        return nfn(x, axis=_norm_dim(dim), keepdims=keep_dim)

    reducer = _reducer(tfn)

    @register_op(f"reduce_{name}", reference=ref, has_grad=has_grad)
    def op(x, dim=None, keep_dim=False):
        return reducer(x, dim, keep_dim)

    op.__name__ = f"reduce_{name}"
    op.__doc__ = f"reduce_{name} (fluid operators/reduce_ops/reduce_{name}_op)."
    return op


reduce_sum = _make("sum", torch.sum, np.sum)
reduce_mean = _make("mean", lambda x, **kw: torch.mean(_float(x), **kw),
                    np.mean)
reduce_max = _make("max", torch.amax, np.max)
reduce_min = _make("min", torch.amin, np.min)
reduce_prod = _make("prod", _prod, np.prod)
reduce_all = _make("all", torch.all, np.all, has_grad=False)
reduce_any = _make("any", torch.any, np.any, has_grad=False)


@register_op("logsumexp", reference=lambda x, dim=None, keep_dim=False:
             np.log(np.sum(np.exp(x), axis=_norm_dim(dim), keepdims=keep_dim)))
def logsumexp(x, dim=None, keep_dim=False):
    return torch.logsumexp(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("mean", reference=lambda x: np.mean(x))
def mean(x):
    """Global mean (fluid mean_op — the canonical loss reducer)."""
    return torch.mean(_float(x))
