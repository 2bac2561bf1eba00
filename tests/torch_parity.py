"""Helpers of the CPU parity tests: reference parameter trees flattened to
the port's names, and the tolerances of the recurrent and structured
slice's checks (losses 1e-5 relative, gradients atol 1e-5 / rtol 1e-4,
ops 1e-6 / 1e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
OP_ATOL, OP_RTOL = 1e-6, 1e-5


def flat(tree, prefix=""):
    """A nested ``{name: array}`` tree -> ``{"a.b": numpy array}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def init(layer, seed=0):
    """A reference layer's parameter tree (the shape of ``layer.init``'s)
    drawn from ``seed`` with numpy, faster than the reference's
    initializers: normal with std ``fan_in ** -0.5`` for matrices, 0.1
    for vectors (biases too, so they are not all zero), ``1 + 0.1 z``
    for scales and ``0.5 + |z|`` for variances."""
    rng = np.random.default_rng(seed)

    def build(lay):
        tree = {}
        for name, spec in lay._param_specs.items():
            shape = tuple(spec.shape)
            z = rng.standard_normal(shape).astype(np.float32)
            if name == "variance":
                v = 0.5 + np.abs(z)
            elif name == "scale":
                v = 1.0 + 0.1 * z
            elif len(shape) >= 2:
                v = z * np.float32(np.prod(shape[:-1]) ** -0.5)
            else:
                v = 0.1 * z
            tree[name] = v.astype(np.float32)
        for name, sub in lay._sublayers.items():
            tree[name] = build(sub)
        return tree

    return build(layer)


def to_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def close(got, want, atol=OP_ATOL, rtol=OP_RTOL, what=""):
    """``got`` (tensor or array) within the tolerance of ``want``;
    integers and bools exactly."""
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=what)
    else:
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64), err_msg=what)


def loss_close(got, want, what="loss"):
    g, w = float(torch.as_tensor(got).detach()), float(want)
    assert abs(g - w) <= LOSS_RTOL * max(abs(w), 1e-6), (what, g, w)


def grads_close(model, jax_grads, transpose=None):
    """Every parameter gradient of ``model`` against the reference's
    gradient tree (by the port's names; ``transpose`` maps a name to a
    function that brings the reference's layout to the port's)."""
    want = flat(jax_grads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want), set(got) ^ set(want)
    for name, g in got.items():
        w = want[name]
        if transpose and name in transpose:
            w = transpose[name](w)
        assert g is not None, name
        close(g, w, GRAD_ATOL, GRAD_RTOL, what=name)


#: the dense op library's modules; the rest of the registered ops
#: are held in ``test_torch_ops_registry_structured.py``, the detection
#: ops in ``test_torch_detection_ops.py``
DENSE_OPS = ("elementwise", "math", "reduction", "activation", "tensor")
DETECTION_OPS = ("detection",)


def op_module(name):
    """The port module that registers op ``name`` (its last component)."""
    from paddle_tpu_torch.core.registry import get_op
    return get_op(name).module.rsplit(".", 1)[-1]


def _to_jax(obj):
    if isinstance(obj, np.ndarray):
        return jnp.asarray(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_jax(o) for o in obj)
    return obj


def _arrays_only(obj):
    if isinstance(obj, (list, tuple)):
        return all(_arrays_only(o) for o in obj)
    return isinstance(obj, np.ndarray)


def op_equals_the_reference(name, jit=False):
    """The port's op ``name`` on its sample (``ops.samples``) against the
    JAX op on the same numpy inputs: floats within 1e-6 abs / 1e-5 rel,
    everything else exactly. ``jit`` runs the JAX op under ``jax.jit``
    (its keyword arguments fixed) where every positional input is an
    array: the detection ops' loops take seconds op by op."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.ops import samples
    args, kwargs = samples.sample(name, seed=0)
    fn = jreg.get_op(name).fn
    if jit and _arrays_only(args):
        want = jax.jit(functools.partial(fn, **kwargs))(*_to_jax(args))
    else:
        want = fn(*_to_jax(args), **kwargs)
    got = samples.run_op(name, args, kwargs, "cpu")
    errs = samples.close(got, samples.to_numpy(want), samples.ATOL,
                         samples.RTOL)
    assert not errs, errs
