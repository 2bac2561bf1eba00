"""Broadcasted elementwise binary ops (``paddle_tpu/ops/elementwise.py``).

Thin registrations over PyTorch's broadcasting, so the reference's op
surface and its ``axis``-style broadcasting exist: fluid's ``axis``
aligns y's dims starting at ``axis`` of x (x: [N, C, H, W], y: [C],
axis=1), reproduced by reshaping y. Then the comparison and logical ops
(bool outputs).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op


def _align(x, y, axis):
    """Expand y to x's rank with fluid's axis semantics."""
    if axis == -1 or x.ndim == y.ndim:
        return y
    trailing = x.ndim - axis - y.ndim
    if trailing < 0:
        raise ValueError(f"bad axis {axis} for shapes {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    return y.reshape(tuple(y.shape) + (1,) * trailing)


def _np_align(x, y, axis):
    x, y = np.asarray(x), np.asarray(y)
    if axis == -1 or x.ndim == y.ndim:
        return y
    return y.reshape(y.shape + (1,) * (x.ndim - axis - y.ndim))


def _tensor(y, like):
    return y if isinstance(y, torch.Tensor) else torch.as_tensor(
        y, device=like.device)


def _make(name, fn, np_fn):
    def ref(x, y, axis=-1):
        return np_fn(x, _np_align(x, y, axis))

    @register_op(f"elementwise_{name}", reference=ref)
    def op(x, y, axis=-1):
        return fn(x, _align(x, _tensor(y, x), axis))

    op.__name__ = f"elementwise_{name}"
    op.__doc__ = f"Broadcasted elementwise {name} (fluid elementwise_{name}_op)."
    return op


add = _make("add", torch.add, np.add)
sub = _make("sub", torch.sub, np.subtract)
mul = _make("mul", torch.mul, np.multiply)
div = _make("div", torch.true_divide, np.divide)
floordiv = _make("floordiv", torch.floor_divide, np.floor_divide)
mod = _make("mod", torch.remainder, np.mod)
max = _make("max", torch.maximum, np.maximum)
min = _make("min", torch.minimum, np.minimum)
pow = _make("pow", torch.pow, np.power)


# ---------------------------------------------------------------------------
# comparison + logical ops (fluid's compare_op.cc, logical_op.cc)
# ---------------------------------------------------------------------------

def _cmp(name, tfn, nfn):
    @register_op(name, reference=nfn, has_grad=False)
    def op(x, y, axis=-1):
        return tfn(x, _align(x, _tensor(y, x), axis))
    op.__name__ = name
    op.__doc__ = f"{name}_op: elementwise comparison, bool output."
    return op


equal = _cmp("equal", torch.eq, np.equal)
not_equal = _cmp("not_equal", torch.ne, np.not_equal)
less_than = _cmp("less_than", torch.lt, np.less)
less_equal = _cmp("less_equal", torch.le, np.less_equal)
greater_than = _cmp("greater_than", torch.gt, np.greater)
greater_equal = _cmp("greater_equal", torch.ge, np.greater_equal)
logical_and = _cmp("logical_and", torch.logical_and, np.logical_and)
logical_or = _cmp("logical_or", torch.logical_or, np.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor, np.logical_xor)


@register_op("logical_not", reference=np.logical_not, has_grad=False)
def logical_not(x):
    """logical_not_op."""
    return torch.logical_not(x)
