"""Sample inputs for every op of the dense op library, and the battery
that holds each op to its numpy reference on a device.

:data:`SAMPLES` maps each registered name of :mod:`.elementwise`,
:mod:`.math`, :mod:`.reduction`, :mod:`.activation` and :mod:`.tensor`
to a function of a ``numpy.random.Generator`` giving ``(args, kwargs)``
in numpy (float32 arrays, integer and bool arrays, Python values), so
the same inputs reach the port's op, the JAX package's op (in the CPU
tests) and the numpy reference. The random ops (:data:`RANDOM`) take a
generator where the reference takes a key: :func:`check_random` holds
their shape, dtype, range or moments and their determinism under one
seed.

:func:`run_battery` runs every op on ``device`` in float32 against its
numpy reference (``OpInfo.reference``), or, where the reference has
none, against the same op on the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

# registers the ops the samples name
from paddle_tpu_torch.ops import (activation, elementwise,  # noqa: F401
                                  math, reduction, tensor)

#: ops whose first argument is a torch.Generator (the reference's key)
RANDOM = ("gaussian_random", "uniform_random", "randint", "randperm",
          "sampling_id", "random_crop", "gaussian_random_batch_size_like",
          "uniform_random_batch_size_like")
#: creation ops with no tensor input: the port's take ``device=``
CREATION = ("fill_constant", "range", "linspace", "eye", "ones", "zeros")
#: float outputs: the tolerance of the port against the JAX package and
#: of a device against the numpy reference (float32)
ATOL, RTOL = 1e-6, 1e-5
DEVICE_ATOL, DEVICE_RTOL = 1e-5, 1e-5


def _f(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _pos(r, *shape):
    return r.uniform(0.5, 2.0, shape).astype(np.float32)


def _i(r, lo, hi, *shape):
    return r.integers(lo, hi, shape).astype(np.int32)


def _b(r, *shape):
    return r.random(shape) < 0.5


def _bad(r):
    x = _f(r, 3, 4)
    x[0, 1], x[2, 2] = np.nan, np.inf
    return x


def _spd(r):
    m = _f(r, 4, 4)
    return (m @ m.T + 4 * np.eye(4)).astype(np.float32)


def _nd_index(r, n, *dims):
    return np.stack([r.integers(0, d, n) for d in dims], -1).astype(np.int32)


def _elementwise(r, name):
    x = _f(r, 2, 3, 4)
    if name in ("div", "floordiv", "mod"):
        return (x, _pos(r, 3)), {"axis": 1}
    if name == "pow":
        return (_pos(r, 2, 3, 4), _f(r, 4)), {}
    return (x, _f(r, 3)), {"axis": 1}


def _activation(r, name):
    x = _f(r, 3, 5)
    special = {
        "log": (_pos(r, 3, 5),), "sqrt": (_pos(r, 3, 5),),
        "rsqrt": (_pos(r, 3, 5),), "reciprocal": (_pos(r, 3, 5),),
        "acos": (r.uniform(-0.9, 0.9, (3, 5)).astype(np.float32),),
        "asin": (r.uniform(-0.9, 0.9, (3, 5)).astype(np.float32),),
        "round": (3 * x,), "hard_sigmoid": (3 * x,), "hard_swish": (3 * x,),
        "clip": (x, -0.5, 0.5), "prelu": (x, 0.25),
        "brelu": (10 * x,), "soft_relu": (30 * x,),
    }
    kwargs = {"pow": {"factor": 1.5}, "leaky_relu": {"alpha": 0.1},
              "elu": {"alpha": 1.2}, "softshrink": {"lambda_": 0.3},
              "thresholded_relu": {"threshold": 0.2},
              "brelu": {"t_min": -1.0, "t_max": 5.0},
              "soft_relu": {"threshold": 20.0}}.get(name, {})
    args = special.get(name, (_pos(r, 3, 5),) if name == "pow" else (x,))
    return args, kwargs


_ELEMENTWISE = ("add", "sub", "mul", "div", "floordiv", "mod", "max", "min",
                "pow")
_COMPARE = ("equal", "not_equal", "less_than", "less_equal", "greater_than",
            "greater_equal")
_LOGICAL = ("logical_and", "logical_or", "logical_xor")
_ACTIVATIONS = (
    "relu", "sigmoid", "tanh", "gelu", "softplus", "softsign", "exp", "log",
    "square", "sqrt", "rsqrt", "abs", "ceil", "floor", "round", "reciprocal",
    "sin", "cos", "swish", "leaky_relu", "elu", "relu6", "hard_sigmoid",
    "hard_swish", "prelu", "pow", "clip", "selu", "mish", "softshrink",
    "hard_shrink", "tanh_shrink", "thresholded_relu", "logsigmoid", "stanh",
    "acos", "asin", "atan", "brelu", "soft_relu")

SAMPLES: Dict[str, Callable] = {}
for _n in _ELEMENTWISE:
    SAMPLES[f"elementwise_{_n}"] = (lambda n: lambda r: _elementwise(r, n))(_n)
for _n in _COMPARE:
    SAMPLES[_n] = lambda r: ((_i(r, 0, 3, 2, 3, 4), _i(r, 0, 3, 3, 4)), {})
for _n in _LOGICAL:
    SAMPLES[_n] = lambda r: ((_b(r, 2, 3), _b(r, 2, 3)), {})
for _n in _ACTIVATIONS:
    SAMPLES[_n] = (lambda n: lambda r: _activation(r, n))(_n)

SAMPLES.update({
    "logical_not": lambda r: ((_b(r, 2, 3),), {}),
    # math
    "mul": lambda r: ((_f(r, 2, 3, 4), _f(r, 12, 5), 1, 1), {}),
    "matmul": lambda r: ((_f(r, 2, 3, 4), _f(r, 2, 5, 4)),
                         {"transpose_y": True, "alpha": 0.5}),
    "dot": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    "bmm": lambda r: ((_f(r, 2, 3, 4), _f(r, 2, 4, 5)), {}),
    "fc": lambda r: ((_f(r, 2, 3, 4), _f(r, 12, 5), _f(r, 5)),
                     {"num_flatten_dims": 1}),
    "addmm": lambda r: ((_f(r, 3, 5), _f(r, 3, 4), _f(r, 4, 5)),
                        {"alpha": 0.5, "beta": 2.0}),
    "cholesky": lambda r: ((_spd(r),), {}),
    "norm": lambda r: ((_f(r, 3, 4),), {"axis": -1}),
    "cumsum": lambda r: ((_f(r, 3, 4),), {"axis": 1}),
    "einsum": lambda r: (("ij,jk->ik", _f(r, 3, 4), _f(r, 4, 5)), {}),
    # reduction
    "reduce_sum": lambda r: ((_f(r, 2, 3, 4),),
                             {"dim": [0, 2], "keep_dim": True}),
    "reduce_mean": lambda r: ((_f(r, 2, 3, 4),), {"dim": 1}),
    "reduce_max": lambda r: ((_f(r, 2, 3, 4),), {}),
    "reduce_min": lambda r: ((_f(r, 2, 3, 4),), {"dim": -1, "keep_dim": True}),
    "reduce_prod": lambda r: ((_pos(r, 2, 3),), {"dim": 1}),
    "reduce_all": lambda r: ((_b(r, 2, 3),), {"dim": 1}),
    "reduce_any": lambda r: ((_b(r, 2, 3),), {}),
    "logsumexp": lambda r: ((_f(r, 2, 3, 4),), {"dim": [1, 2]}),
    "mean": lambda r: ((_f(r, 3, 4),), {}),
    # tensor
    "accuracy": lambda r: ((_f(r, 6, 5), _i(r, 0, 5, 6, 1)), {"k": 2}),
    "argmax": lambda r: ((_f(r, 3, 4),), {"axis": 0}),
    "argmin": lambda r: ((_f(r, 3, 4),), {}),
    "argsort": lambda r: ((_f(r, 3, 5),), {}),
    "assign": lambda r: ((_f(r, 3, 4),), {}),
    "cast": lambda r: ((3 * _f(r, 3, 4), "int32"), {}),
    "clip_by_norm": lambda r: ((_f(r, 3, 4), 1.0), {}),
    "concat": lambda r: (([_f(r, 2, 3), _f(r, 1, 3)],), {"axis": 0}),
    "crop": lambda r: ((_f(r, 4, 5), [1, 3], [2, 3]), {}),
    "diag": lambda r: ((_f(r, 4),), {}),
    "expand": lambda r: ((_f(r, 2, 3), [2, 1]), {}),
    "expand_as": lambda r: ((_f(r, 1, 3), _f(r, 4, 3)), {}),
    "eye": lambda r: ((3, 4), {}),
    "fill_constant": lambda r: (([2, 3], "float32", 1.5), {}),
    "fill_constant_batch_size_like": lambda r: ((_f(r, 4, 3), [1, 5], 2.0),
                                                {}),
    "flatten": lambda r: ((_f(r, 2, 3, 4),), {"axis": 2}),
    "flip": lambda r: ((_f(r, 2, 3), 1), {}),
    "gather": lambda r: ((_f(r, 5, 3), _i(r, 0, 5, 4)), {}),
    "gather_nd": lambda r: ((_f(r, 3, 4, 2), _nd_index(r, 5, 3, 4)), {}),
    "has_inf": lambda r: ((_bad(r),), {}),
    "has_nan": lambda r: ((_bad(r),), {}),
    "hash": lambda r: ((_i(r, -1000, 100000, 3, 4),), {"num_hash": 2}),
    "increment": lambda r: ((_f(r, 3),), {"value": 2.0}),
    "index_sample": lambda r: ((_f(r, 3, 5), _i(r, 0, 5, 3, 2)), {}),
    "index_select": lambda r: ((_f(r, 4, 3), _i(r, 0, 3, 5)), {"axis": 1}),
    "is_empty": lambda r: ((_f(r, 0, 3),), {}),
    "isfinite": lambda r: ((_bad(r),), {}),
    "isnan": lambda r: ((_bad(r),), {}),
    "kron": lambda r: ((_f(r, 2, 2), _f(r, 2, 3)), {}),
    "linspace": lambda r: ((0.0, 1.0, 7), {}),
    "masked_select": lambda r: ((_f(r, 3, 4), _b(r, 3, 4)), {"size": 5}),
    "meshgrid": lambda r: ((_f(r, 3), _f(r, 4)), {}),
    "multiplex": lambda r: ((_i(r, 0, 3, 4, 1), _f(r, 4, 2), _f(r, 4, 2),
                             _f(r, 4, 2)), {}),
    "nonzero": lambda r: ((_i(r, 0, 2, 3, 4),), {}),
    "ones": lambda r: (([2, 3],), {}),
    "ones_like": lambda r: ((_f(r, 2, 3),), {}),
    "pad_constant_like": lambda r: ((_f(r, 3, 4), _f(r, 2, 3)),
                                    {"pad_value": 1.5}),
    "pixel_shuffle": lambda r: ((_f(r, 1, 8, 2, 3), 2), {}),
    "range": lambda r: ((0, 10, 3), {}),
    "rank": lambda r: ((_f(r, 2, 3, 4),), {}),
    "reshape": lambda r: ((_f(r, 2, 6), [3, 4]), {}),
    "reverse": lambda r: ((_f(r, 2, 3), [0, 1]), {}),
    "roll": lambda r: ((_f(r, 3, 4), 1), {"axis": 1}),
    "scale": lambda r: ((_f(r, 3),), {"scale": 2.0, "bias": 1.0,
                                      "bias_after_scale": False}),
    "scatter": lambda r: ((_f(r, 5, 3), r.permutation(5)[:3].astype(np.int32),
                           _f(r, 3, 3)), {}),
    "scatter_nd": lambda r: ((_nd_index(r, 4, 3, 5), _f(r, 4), [3, 5]), {}),
    "scatter_nd_add": lambda r: ((_f(r, 3, 5), _nd_index(r, 4, 3, 5),
                                  _f(r, 4)), {}),
    "shape": lambda r: ((_f(r, 2, 3),), {}),
    "shard_index": lambda r: ((_i(r, 0, 20, 6), 20, 4, 1), {}),
    "shuffle_channel": lambda r: ((_f(r, 1, 6, 2, 2), 3), {}),
    "sign": lambda r: ((_f(r, 3, 4),), {}),
    "size": lambda r: ((_f(r, 2, 3),), {}),
    "slice": lambda r: ((_f(r, 4, 5, 6), [0, 2], [1, -4], [3, 10000]), {}),
    "split": lambda r: ((_f(r, 6, 4), [2, 4]), {"axis": 0}),
    "squeeze": lambda r: ((_f(r, 1, 3, 1, 2), [0, 2]), {}),
    "stack": lambda r: (([_f(r, 2, 3), _f(r, 2, 3)], 1), {}),
    "strided_slice": lambda r: ((_f(r, 6, 5), [0, 1], [5, 0], [0, 5],
                                 [-2, 2]), {}),
    "sum": lambda r: (([_f(r, 2, 3), _f(r, 2, 3), _f(r, 2, 3)],), {}),
    "temporal_shift": lambda r: ((_f(r, 4, 4, 2, 2), 2), {}),
    "tile": lambda r: ((_f(r, 2, 3), [2, 2]), {}),
    "top_k": lambda r: ((_f(r, 3, 6), 2), {}),
    "transpose": lambda r: ((_f(r, 2, 3, 4), [2, 0, 1]), {}),
    "tril": lambda r: ((_f(r, 4, 4),), {"diagonal": -1}),
    "triu": lambda r: ((_f(r, 4, 4), 1), {}),
    "unfold": lambda r: ((_f(r, 1, 2, 5, 5), 3), {"stride": 2, "padding": 1}),
    "unique": lambda r: ((_i(r, 0, 5, 10),), {"return_counts": True}),
    "unique_with_counts": lambda r: ((_i(r, 0, 5, 10),), {"size": 8}),
    "unsqueeze": lambda r: ((_f(r, 2, 3), [0, -1]), {}),
    "unstack": lambda r: ((_f(r, 2, 3), 1), {}),
    "where": lambda r: ((_b(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)), {}),
    "zeros": lambda r: (([2, 3],), {}),
    "zeros_like": lambda r: ((_f(r, 2, 3),), {}),
})


def sample(name: str, seed: int = 0):
    """``(args, kwargs)`` of ``name``'s sample, from ``seed``."""
    return SAMPLES[name](np.random.default_rng(seed))


def to_device(obj, device):
    """numpy arrays (in lists and tuples too) -> tensors on ``device``."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(o, device) for o in obj)
    return obj


def to_numpy(out):
    """An op's output (a tensor, or lists and tuples of them) -> numpy."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, (list, tuple)):
        return [to_numpy(o) for o in out]
    return np.asarray(out)


def run_op(name: str, args, kwargs, device):
    """The port's op ``name`` on ``args``/``kwargs`` (numpy) on
    ``device``."""
    from paddle_tpu_torch.core.registry import get_op
    kwargs = dict(kwargs)
    if name in CREATION:
        kwargs["device"] = device
    return get_op(name).fn(*to_device(args, device), **kwargs)


def close(got, want, atol, rtol) -> List[str]:
    """Mismatches between two outputs (nested lists of arrays): floats
    within the tolerance, everything else exactly."""
    got, want = to_numpy(got), to_numpy(want)
    if isinstance(want, list) or isinstance(got, list):
        if not (isinstance(got, list) and isinstance(want, list)
                and len(got) == len(want)):
            return [f"structure {type(got)} vs {type(want)}"]
        return [e for g, w in zip(got, want) for e in close(g, w, atol, rtol)]
    if got.shape != want.shape:
        return [f"shape {got.shape} vs {want.shape}"]
    if np.issubdtype(want.dtype, np.floating) or np.issubdtype(
            got.dtype, np.floating):
        if not np.allclose(got.astype(np.float64), want.astype(np.float64),
                           atol=atol, rtol=rtol, equal_nan=True):
            err = np.nanmax(np.abs(got.astype(np.float64)
                                   - want.astype(np.float64)))
            return [f"max |diff| {err:.3e}"]
        return []
    if not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
        return ["values differ"]
    return []


def check_random(name: str, device, seed: int = 0) -> List[str]:
    """A random op on ``device``: shape, dtype and range or moments, and
    the same values from two generators of one seed."""
    from paddle_tpu_torch.core.registry import get_op
    fn = get_op(name).fn

    def gen():
        return torch.Generator(device=device).manual_seed(seed)

    x = torch.arange(24, dtype=torch.float32, device=device).reshape(2, 3, 4)
    ref = torch.zeros((5, 2), device=device)
    probs = torch.tensor([[0.0, 1.0, 0.0], [0.5, 0.0, 0.5]], device=device)
    calls = {
        "gaussian_random": lambda g: fn(g, (4000,), mean=1.0, std=2.0),
        "uniform_random": lambda g: fn(g, (4000,), min=-2.0, max=3.0),
        "randint": lambda g: fn(g, 2, 7, (1000,)),
        "randperm": lambda g: fn(g, 50),
        "sampling_id": lambda g: fn(probs, g),
        "random_crop": lambda g: fn(x, (2, 2), g),
        "gaussian_random_batch_size_like": lambda g: fn(ref, (1, 2000), g,
                                                        mean=1.0, std=2.0),
        "uniform_random_batch_size_like": lambda g: fn(ref, (1, 800), g,
                                                       min=-2.0, max=3.0),
    }
    a, b = calls[name](gen()), calls[name](gen())
    errs = [] if torch.equal(a, b) else ["two generators of one seed differ"]
    if a.device.type != torch.device(device).type:
        errs.append(f"output on {a.device}")
    v = a.double().cpu()
    if name in ("gaussian_random", "gaussian_random_batch_size_like"):
        if abs(float(v.mean()) - 1.0) > 0.2 or abs(float(v.std()) - 2.0) > 0.2:
            errs.append(f"moments {float(v.mean()):.3f}, {float(v.std()):.3f}")
    elif name in ("uniform_random", "uniform_random_batch_size_like"):
        if float(v.min()) < -2.0 or float(v.max()) >= 3.0 or abs(
                float(v.mean()) - 0.5) > 0.2:
            errs.append("range or mean")
    elif name == "randint":
        if float(v.min()) < 2 or float(v.max()) > 6:
            errs.append("range")
    elif name == "randperm":
        if sorted(v.long().tolist()) != list(range(50)):
            errs.append("not a permutation")
    elif name == "sampling_id":
        if int(v[0]) != 1 or int(v[1]) not in (0, 2):
            errs.append(f"samples {v.tolist()} off the support")
    elif name == "random_crop":
        if tuple(a.shape) != (2, 2, 2) or not all(
                bool((x[i] == a[i][0, 0]).any()) for i in range(2)):
            errs.append("crop not of x")
    want_shape = {"gaussian_random_batch_size_like": (5, 2000),
                  "uniform_random_batch_size_like": (5, 800)}.get(name)
    if want_shape and tuple(a.shape) != want_shape:
        errs.append(f"shape {tuple(a.shape)}")
    return errs


def run_battery(device, seed: int = 0) -> Dict:
    """Every op of :data:`SAMPLES` on ``device`` in float32 against its
    numpy reference (or the op on the CPU where the reference has none),
    and every random op through :func:`check_random`. Returns
    ``{"ops", "against_numpy", "against_cpu", "random", "failures"}``
    (``failures``: name -> mismatches)."""
    from paddle_tpu_torch.core.registry import get_op
    failures: Dict[str, List[str]] = {}
    counts = {"against_numpy": 0, "against_cpu": 0}
    for name in sorted(SAMPLES):
        args, kwargs = sample(name, seed)
        info = get_op(name)
        try:
            got = run_op(name, args, kwargs, device)
            if info.reference is not None:
                want = info.reference(*args, **kwargs)
                counts["against_numpy"] += 1
            else:
                want = run_op(name, args, kwargs, "cpu")
                counts["against_cpu"] += 1
            errs = close(got, want, DEVICE_ATOL, DEVICE_RTOL)
        except Exception as err:      # noqa: BLE001 - reported per op
            errs = [f"{type(err).__name__}: {err}"]
        if errs:
            failures[name] = errs
    for name in RANDOM:
        errs = check_random(name, device, seed)
        if errs:
            failures[name] = errs
    return {"ops": len(SAMPLES) + len(RANDOM), **counts,
            "random": len(RANDOM), "failures": failures}
