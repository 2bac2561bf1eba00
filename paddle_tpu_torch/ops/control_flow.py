"""Control flow with the reference's API names
(``paddle_tpu/ops/control_flow.py``): ``while_op``,
``conditional_block_op``, ``Switch``, ``StaticRNN``, the tensor arrays and
``py_func``.

PyTorch runs eagerly, so a loop or a branch is plain Python over tensors
with the reference's signatures and return structure: ``cond`` runs the
branch its predicate picks (reading the predicate on the host), ``scan``
stacks its per-step outputs in the reference's order (also when
``reverse``), and a :class:`TensorArray` write returns a new array.
Carries and outputs are pytrees (tensors in tuples, lists and dicts).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch.core.registry import register_op

__all__ = ["while_loop", "cond", "case", "scan", "fori_loop", "TensorArray",
           "create_array", "array_write", "array_read", "array_length",
           "tensor_array_to_tensor", "py_func"]


@register_op("while_loop")
def while_loop(cond: Callable, body: Callable, init: Any):
    """``while cond(x): x = body(x)`` (``while_op``)."""
    x = init
    while bool(cond(x)):
        x = body(x)
    return x


@register_op("cond")
def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """``conditional_block_op``: ``true_fn(*operands)`` if ``pred`` else
    ``false_fn(*operands)``."""
    return (true_fn if bool(pred) else false_fn)(*operands)


@register_op("case")
def case(index, branches: Sequence[Callable], *operands):
    """``layers.Switch``: the branch at ``index``, clamped into range as
    ``lax.switch`` clamps it."""
    i = min(max(int(index), 0), len(branches) - 1)
    return branches[i](*operands)


@register_op("scan")
def scan(fn: Callable, init: Any, xs: Any, *, length=None, reverse=False):
    """``StaticRNN``: ``carry, y = fn(carry, x)`` over the leading axis of
    ``xs`` (a pytree, or None with ``length``); returns ``(carry, ys)``
    with ``ys[i]`` the output of step ``i`` (walked from the end when
    ``reverse``)."""
    leaves, spec = pytree.tree_flatten(xs)     # None is an empty tree
    arrays = [leaf for leaf in leaves if leaf is not None]
    n = arrays[0].shape[0] if arrays else length
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, [None] * n
    for i in order:
        x = pytree.tree_unflatten(
            [None if leaf is None else leaf[i] for leaf in leaves], spec)
        carry, ys[i] = fn(carry, x)
    if n == 0:
        return carry, None
    flat = [pytree.tree_flatten(y)[0] for y in ys]
    stacked = [None if flat[0][j] is None else
               torch.stack([torch.as_tensor(f[j]) for f in flat])
               for j in range(len(flat[0]))]
    return carry, pytree.tree_unflatten(stacked,
                                        pytree.tree_flatten(ys[0])[1])


@register_op("fori_loop")
def fori_loop(lower, upper, body: Callable, init: Any):
    """``for i in range(lower, upper): val = body(i, val)``."""
    val = init
    for i in range(int(lower), int(upper)):
        val = body(i, val)
    return val


class TensorArray:
    """Write-once tensor array (``lod_tensor_array``) on a preallocated
    ``(size, *elem_shape)`` buffer; :meth:`write` returns a new array (the
    old one is unchanged) and clamps its index, as
    ``dynamic_update_index_in_dim``."""

    def __init__(self, size: int, elem_shape, dtype=torch.float32,
                 buffer=None, *, device=None):
        self.size = size
        self._buf = (buffer if buffer is not None
                     else torch.zeros((size,) + tuple(elem_shape),
                                      dtype=dtype, device=device))

    def _index(self, i):
        return min(max(int(i), 0), self.size - 1)

    def write(self, i, value) -> "TensorArray":
        i = self._index(i)
        buf = torch.cat([self._buf[:i], value[None].to(self._buf.dtype),
                         self._buf[i + 1:]])
        return TensorArray(self.size, value.shape, buffer=buf)

    def read(self, i):
        return self._buf[self._index(i)]

    def stack(self):
        return self._buf


def create_array(size, example):
    """layers.create_array: ``size`` slots shaped like ``example``, on its
    device."""
    return TensorArray(size, example.shape, example.dtype,
                       device=example.device)


def array_write(arr, i, x):
    """layers.array_write (returns the new array)."""
    return arr.write(i, x)


def array_read(arr, i):
    return arr.read(i)


def array_length(arr):
    return arr.size


def tensor_array_to_tensor(arr, axis=0):
    """``tensor_array_to_tensor_op``: stack (axis 0) or concatenate along
    an existing axis of the elements."""
    stacked = arr.stack()
    if axis == 0:
        return stacked
    return torch.cat(list(stacked.unbind(0)), dim=axis - 1)


def py_func(fn, args, out_shape_dtype):
    """``py_func_op``: run the host function ``fn`` on ``args`` as numpy
    arrays and return its results as tensors on the first argument's
    device. ``out_shape_dtype`` is a pytree of objects with ``shape`` and
    ``dtype`` (tensors, numpy arrays or ``jax.ShapeDtypeStruct``-like
    records): each result must have that shape, and takes that dtype."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    host = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
            for a in args]
    out = fn(*host)
    specs, spec_tree = pytree.tree_flatten(
        out_shape_dtype, is_leaf=lambda s: hasattr(s, "shape"))
    results = pytree.tree_flatten(out, is_leaf=lambda s: hasattr(
        s, "shape") or np.isscalar(s))[0]
    if len(results) != len(specs):
        raise ValueError(f"py_func returned {len(results)} values, "
                         f"expected {len(specs)}")
    tensors = []
    for r, s in zip(results, specs):
        r = np.asarray(r)
        if tuple(r.shape) != tuple(s.shape):
            raise ValueError(f"py_func result shape {r.shape}, expected "
                             f"{tuple(s.shape)}")
        dtype = (s.dtype if isinstance(s.dtype, torch.dtype)
                 else torch.from_numpy(np.zeros((), np.dtype(s.dtype))).dtype)
        tensors.append(torch.as_tensor(np.array(r)).to(device=device,
                                                        dtype=dtype))
    return pytree.tree_unflatten(tensors, spec_tree)
