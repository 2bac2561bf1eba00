"""OpTest harness (``paddle_tpu/testing.py``; fluid's ``op_test.py``):
an op's outputs against a numpy reference, and its autograd gradients
against central finite differences.

An op is a function of tensors: :func:`check_output` and
:func:`check_grad` pass numpy arrays in as CPU tensors (lists of arrays
as lists of tensors) and everything else as it is (shapes, axes,
dtypes); the finite differences evaluate the op in float64.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _is_array(a) -> bool:
    return isinstance(a, np.ndarray) or (
        isinstance(a, (list, tuple)) and a
        and all(isinstance(e, np.ndarray) for e in a))


def _tensors(a, requires_grad=False):
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.requires_grad_() if requires_grad else t
    if _is_array(a):
        return type(a)(_tensors(e) for e in a)
    return a


def _numpy(tree):
    return [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in pytree.tree_leaves(tree)]


def check_output(op_fn: Callable, reference: Callable, args, kwargs=None,
                 rtol=1e-5, atol=1e-6):
    """``op_fn`` on the arguments (arrays as tensors) against
    ``reference`` on the same numpy arguments, leaf by leaf."""
    kwargs = kwargs or {}
    got = _numpy(op_fn(*[_tensors(a) for a in args], **kwargs))
    want = [np.asarray(w) for w in pytree.tree_leaves(
        reference(*args, **kwargs))]
    assert len(got) == len(want), (
        f"output arity {len(got)} vs reference {len(want)}")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def numeric_grad(f: Callable, args: Sequence, wrt: int = 0, eps=1e-3):
    """Central finite differences of ``sum(f(*args))`` with respect to
    ``args[wrt]``, in float64 (``op_test.py``'s
    ``get_numeric_gradient``). ``f`` takes and returns numpy arrays."""
    args = [np.asarray(a, np.float64) if hasattr(a, "dtype") and
            np.issubdtype(np.asarray(a).dtype, np.floating)
            else a for a in args]
    x = np.array(args[wrt], np.float64)
    grad = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        orig = x[idx]
        x[idx] = orig + eps
        args[wrt] = x
        hi = float(np.sum(np.asarray(f(*args), np.float64)))
        x[idx] = orig - eps
        args[wrt] = x
        lo = float(np.sum(np.asarray(f(*args), np.float64)))
        x[idx] = orig
        grad[idx] = (hi - lo) / (2 * eps)
        it.iternext()
    args[wrt] = x
    return grad


def check_grad(op_fn: Callable, args, wrt=(0,), kwargs=None, eps=1e-3,
               rtol=5e-3, atol=1e-3):
    """The autograd gradient of ``sum(op_fn(...))`` with respect to each
    argument in ``wrt`` (float32 inputs) against float64 finite
    differences of the op (the reference's ``max_relative_error`` of
    0.005 by default)."""
    kwargs = kwargs or {}

    def numpy_op(*a):
        out = op_fn(*[_tensors(e) for e in a], **kwargs)
        return out.detach().numpy()

    for i in wrt:
        inputs = [_tensors(a, requires_grad=(j == i))
                  for j, a in enumerate(args)]
        op_fn(*inputs, **kwargs).sum().backward()
        numeric = numeric_grad(numpy_op, list(args), wrt=i, eps=eps)
        np.testing.assert_allclose(inputs[i].grad.numpy(), numeric,
                                   rtol=rtol, atol=atol,
                                   err_msg=f"grad mismatch wrt arg {i}")


def assert_trees_close(a, b, rtol=1e-5, atol=1e-6):
    """Every leaf of ``a`` (tensors or arrays, in dicts, lists, tuples)
    close to ``b``'s."""
    la, lb = _numpy(a), _numpy(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def subprocess_env(repo_on_path: bool = True) -> dict:
    """An environment for worker processes that tests and launchers
    spawn: this process's, with the repository on ``PYTHONPATH``."""
    env = dict(os.environ)
    if repo_on_path:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        extra = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = repo + (os.pathsep + extra if extra else "")
    return env


__all__ = ["assert_trees_close", "check_grad", "check_output",
           "numeric_grad", "subprocess_env"]
