"""Sample inputs for every registered op of the port, and the battery
that holds each op to its numpy reference on a device.

:data:`SAMPLES` maps each registered name of the dense op library
(:mod:`.elementwise`, :mod:`.math`, :mod:`.reduction`, :mod:`.activation`,
:mod:`.tensor`) and of :mod:`.nn`, :mod:`.crf`, :mod:`.sequence`,
:mod:`.control_flow`, :mod:`.quant`, :mod:`.metrics_ops`, :mod:`.niche`,
:mod:`.detection` and ``nn.nets`` (``glu``), but the beam-search ops, to
a function of a ``numpy.random.Generator`` giving ``(args, kwargs)`` in
numpy (float32 arrays, integer and bool arrays, Python values and
callables), so the same inputs reach the port's op, the JAX package's op (in the CPU tests)
and the numpy reference. The random ops (:data:`RANDOM`) draw from a
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
from paddle_tpu_torch.nn import nets  # noqa: F401
from paddle_tpu_torch.ops import (activation, control_flow,  # noqa: F401
                                  crf, detection, elementwise, math,
                                  metrics_ops, niche, nn, quant, reduction,
                                  sequence, tensor)

#: ops that draw from a torch.Generator (the reference's key)
RANDOM = ("gaussian_random", "uniform_random", "randint", "randperm",
          "sampling_id", "random_crop", "gaussian_random_batch_size_like",
          "uniform_random_batch_size_like", "dropout", "nce",
          "sampled_softmax_with_cross_entropy", "sample_logits")
#: creation ops with no tensor input: the port's take ``device=``
CREATION = ("fill_constant", "range", "linspace", "eye", "ones", "zeros",
            "prior_box", "density_prior_box", "anchor_generator")
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


def _np_probs(r, *shape):
    e = np.exp(_f(r, *shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


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



def _img(r, *shape):
    return _f(r, *shape)


def _lengths(r, b, t):
    """Ragged lengths with 0 and the full width in them."""
    ls = r.integers(1, t, b).astype(np.int32)
    ls[0], ls[-1] = 0, t
    return ls


def _unpool_indices(r, n, c, h, w, oh, ow):
    return np.stack([np.stack([r.choice(oh * ow, h * w, replace=False)
                               for _ in range(c)]) for _ in range(n)]
                    ).reshape(n, c, h, w).astype(np.int32)


def _tree_edges(r):
    # two trees of 5 nodes (1-based; a (0, 0) row pads the second)
    a = np.array([[1, 2], [1, 3], [2, 4], [2, 5]], np.int32)
    b = np.array([[1, 2], [2, 3], [3, 4], [0, 0]], np.int32)
    return np.stack([a, b])


SAMPLES.update({
    # nn: conv and pooling
    "conv2d": lambda r: ((_img(r, 2, 6, 5, 3), _f(r, 3, 3, 3, 4),
                          _f(r, 4)), {"stride": 2, "padding": "SAME"}),
    "conv2d_transpose": lambda r: ((_img(r, 2, 3, 4, 3), _f(r, 3, 3, 3, 2),
                                    _f(r, 2)),
                                   {"stride": 2, "padding": 1}),
    "depthwise_conv2d": lambda r: ((_img(r, 2, 5, 5, 3), _f(r, 3, 3, 3, 1)),
                                   {"padding": 1}),
    "pool2d": lambda r: ((_img(r, 2, 5, 6, 3),),
                         {"kernel": 3, "stride": 2, "padding": 1,
                          "pool_type": "avg"}),
    "adaptive_pool2d": lambda r: ((_img(r, 2, 4, 6, 3), (2, 3)),
                                  {"pool_type": "max"}),
    "conv3d": lambda r: ((_img(r, 1, 4, 5, 4, 2), _f(r, 2, 3, 3, 2, 3)),
                         {"padding": "SAME", "stride": (1, 2, 1)}),
    "conv3d_transpose": lambda r: ((_img(r, 1, 3, 3, 2, 2),
                                    _f(r, 2, 2, 2, 2, 3)), {"stride": 2}),
    "pool3d": lambda r: ((_img(r, 1, 4, 4, 5, 2),),
                         {"kernel": 2, "stride": 2, "padding": 1}),
    "adaptive_pool3d": lambda r: ((_img(r, 1, 4, 4, 6, 2), 2), {}),
    # nn: normalization
    "softmax": lambda r: ((_f(r, 3, 5),), {"axis": 0}),
    "log_softmax": lambda r: ((_f(r, 3, 5),), {}),
    "layer_norm": lambda r: ((_f(r, 4, 6), _pos(r, 6), _f(r, 6)),
                             {"begin_norm_axis": 1}),
    "batch_norm": lambda r: ((_img(r, 3, 2, 2, 4), _pos(r, 4), _f(r, 4),
                              _f(r, 4), _pos(r, 4)), {"training": True}),
    "group_norm": lambda r: ((_img(r, 2, 3, 3, 4), _pos(r, 4), _f(r, 4)),
                             {"groups": 2}),
    "instance_norm": lambda r: ((_img(r, 2, 3, 3, 4), _pos(r, 4), _f(r, 4)),
                                {"data_format": "NHWC"}),
    "lrn": lambda r: ((_img(r, 2, 2, 2, 6),), {"n": 3, "alpha": 0.1}),
    "data_norm": lambda r: ((_f(r, 4, 3), 10.0, _f(r, 3),
                             _pos(r, 3) * 20.0), {}),
    "spectral_norm": lambda r: ((_f(r, 4, 2, 3), _f(r, 4)),
                                {"power_iters": 2}),
    "affine_channel": lambda r: ((_img(r, 2, 2, 3, 4), _f(r, 4), _f(r, 4)),
                                 {}),
    # nn: embedding, resize, sampling grids
    "lookup_table": lambda r: ((_i(r, 0, 6, 2, 3), _f(r, 6, 4)),
                               {"padding_idx": 2}),
    "one_hot": lambda r: ((_i(r, 0, 5, 2, 3), 5), {}),
    "interpolate": lambda r: ((_img(r, 2, 5, 4, 3), (3, 7)),
                              {"method": "bilinear"}),
    "resize_trilinear": lambda r: ((_img(r, 1, 3, 4, 5, 2), (5, 2, 5)), {}),
    "grid_sampler": lambda r: ((_f(r, 2, 3, 4, 5),
                                r.uniform(-1.2, 1.2, (2, 3, 2, 2)).astype(
                                    np.float32)), {}),
    "affine_grid": lambda r: ((_f(r, 2, 2, 3), (2, 3, 4, 5)), {}),
    "im2sequence": lambda r: ((_img(r, 2, 5, 4, 3), 2),
                              {"stride": 2, "padding": 1}),
    "pad": lambda r: ((_f(r, 2, 3), [[1, 0], [2, 1]]), {"pad_value": 0.5}),
    "pad2d": lambda r: ((_img(r, 1, 3, 4, 2), (1, 2, 2, 1)),
                        {"mode": "reflect"}),
    "row_conv": lambda r: ((_f(r, 2, 5, 3), _f(r, 3, 3)), {}),
    "maxout": lambda r: ((_f(r, 2, 6, 3), 3), {"axis": 1}),
    "add_position_encoding": lambda r: ((_f(r, 2, 5, 6),),
                                        {"alpha": 0.5, "beta": 2.0}),
    "similarity_focus": lambda r: ((_f(r, 2, 3, 4, 4), 1, [0, 2]), {}),
    "cvm": lambda r: ((_pos(r, 3, 5),), {"use_cvm": True}),
    "filter_by_instag": lambda r: ((_f(r, 4, 3),
                                    np.array([[1, -1], [2, 3], [4, -1],
                                              [3, 1]], np.int32),
                                    np.array([3, -1], np.int32)), {}),
    "mean_iou": lambda r: ((_i(r, 0, 4, 20), _i(r, 0, 4, 20), 5), {}),
    # nn: losses
    "cross_entropy": lambda r: ((_np_probs(r, 4, 5), _i(r, 0, 5, 4, 1)),
                                {}),
    "softmax_with_cross_entropy": lambda r: (
        (_f(r, 4, 5), _i(r, 0, 5, 4, 1)),
        {"ignore_index": 2, "return_softmax": True}),
    "sigmoid_cross_entropy_with_logits": lambda r: (
        (_f(r, 3, 4), r.random((3, 4)).astype(np.float32)), {}),
    "square_error_cost": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    "smooth_l1": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {"sigma": 2.0}),
    "kldiv_loss": lambda r: ((_f(r, 3, 4), _np_probs(r, 3, 4)),
                             {"reduction": "sum"}),
    "margin_rank_loss": lambda r: ((np.sign(_f(r, 4)), _f(r, 4), _f(r, 4)),
                                   {}),
    "huber_loss": lambda r: ((_f(r, 4) * 2, _f(r, 4)), {"delta": 0.7}),
    "label_smooth": lambda r: ((_np_probs(r, 3, 5),), {"epsilon": 0.2}),
    "log_loss": lambda r: ((r.uniform(0.05, 0.95, (4,)).astype(np.float32),
                            (r.random(4) < 0.5).astype(np.float32)), {}),
    "rank_loss": lambda r: (((r.random(4) < 0.5).astype(np.float32),
                             _f(r, 4), _f(r, 4)), {}),
    "hinge_loss": lambda r: ((_f(r, 4), (r.random(4) < 0.5).astype(
        np.float32)), {}),
    "cos_sim": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    "bilinear_tensor_product": lambda r: ((_f(r, 3, 4), _f(r, 3, 2),
                                           _f(r, 5, 4, 2), _f(r, 5)), {}),
    "mse_loss": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    "dice_loss": lambda r: ((_np_probs(r, 4, 3), _i(r, 0, 3, 4)), {}),
    "bpr_loss": lambda r: ((_f(r, 4, 5), _i(r, 0, 5, 4)), {}),
    "npair_loss": lambda r: ((_f(r, 4, 3), _f(r, 4, 3),
                              np.array([0, 1, 0, 2], np.int32)), {}),
    "center_loss": lambda r: ((_f(r, 5, 3), _i(r, 0, 4, 5), _f(r, 4, 3)),
                              {"alpha": 0.3}),
    "teacher_student_sigmoid_loss": lambda r: (
        (20 * _f(r, 4), r.random(4).astype(np.float32)), {}),
    "hsigmoid": lambda r: ((_f(r, 4, 3), _f(r, 5, 3), _f(r, 5),
                            _i(r, 0, 6, 4)), {"num_classes": 6}),
    # crf
    "linear_chain_crf": lambda r: ((_f(r, 4, 5, 3), _i(r, 0, 3, 4, 5),
                                    _lengths(r, 4, 5), _f(r, 3, 3)),
                                   {"start": _f(r, 3), "stop": _f(r, 3)}),
    "crf_decoding": lambda r: ((_f(r, 4, 5, 3), _f(r, 3, 3),
                                _lengths(r, 4, 5)),
                               {"start": _f(r, 3), "stop": _f(r, 3)}),
    "warpctc": lambda r: ((_f(r, 3, 6, 5), np.array([6, 4, 2], np.int32),
                           _i(r, 1, 5, 3, 3), np.array([2, 3, 3], np.int32)),
                          {}),
    "ctc_greedy_decoder": lambda r: ((_f(r, 3, 7, 4),
                                      np.array([7, 3, 0], np.int32)), {}),
    "edit_distance": lambda r: ((_i(r, 0, 3, 3, 5),
                                 np.array([5, 2, 0], np.int32),
                                 _i(r, 0, 3, 3, 4),
                                 np.array([4, 0, 3], np.int32)), {}),
    # sequence
    "sequence_mask": lambda r: ((np.array([0, 3, 5], np.int32),),
                                {"maxlen": 5}),
    "sequence_pool": lambda r: ((_f(r, 3, 5, 2), _lengths(r, 3, 5)),
                                {"pool_type": "max"}),
    "sequence_softmax": lambda r: ((_f(r, 3, 5), _lengths(r, 3, 5)), {}),
    "sequence_reverse": lambda r: ((_f(r, 3, 5, 2), _lengths(r, 3, 5)), {}),
    "sequence_expand": lambda r: ((_f(r, 2, 3), 2), {}),
    "sequence_pad": lambda r: (([_f(r, 2, 3), _f(r, 4, 3)], 3), {}),
    "sequence_unpad": lambda r: ((_f(r, 3, 4, 2),
                                  np.array([0, 2, 4], np.int32)), {}),
    "sequence_conv": lambda r: ((_f(r, 3, 5, 2), _lengths(r, 3, 5),
                                 _f(r, 6, 4)), {"context_start": -1}),
    "sequence_slice": lambda r: ((_f(r, 3, 5, 2), _lengths(r, 3, 5),
                                  np.array([0, 1, 2], np.int32),
                                  np.array([2, 3, 2], np.int32)), {}),
    "sequence_erase": lambda r: ((_i(r, 0, 4, 3, 5), _lengths(r, 3, 5),
                                  [1, 2]), {}),
    "sequence_enumerate": lambda r: ((_i(r, 0, 9, 3, 5), _lengths(r, 3, 5),
                                      2), {"pad_value": -1}),
    "sequence_concat": lambda r: ((_f(r, 3, 4, 2), _lengths(r, 3, 4),
                                   _f(r, 3, 3, 2), _lengths(r, 3, 3)), {}),
    "segment_sum": lambda r: ((_f(r, 6, 2), np.array([0, 0, 1, 3, 3, 3],
                                                     np.int32), 4), {}),
    "segment_max": lambda r: ((_f(r, 6, 2), np.array([0, 0, 1, 3, 3, 3],
                                                     np.int32), 4), {}),
    "sequence_first_step": lambda r: ((_f(r, 3, 4, 2),
                                       _lengths(r, 3, 4)), {}),
    "sequence_last_step": lambda r: ((_f(r, 3, 4, 2), _lengths(r, 3, 4)),
                                     {}),
    "sequence_expand_as": lambda r: ((_f(r, 3, 2), _lengths(r, 3, 4), 4),
                                     {}),
    "sequence_reshape": lambda r: ((_f(r, 3, 4, 2),
                                    np.array([0, 2, 3], np.int32), 4), {}),
    "sequence_scatter": lambda r: ((_f(r, 3, 5), _i(r, 0, 5, 3, 2),
                                    _f(r, 3, 2), np.array([0, 1, 2],
                                                          np.int32)), {}),
    # control flow (plain callables: the same lambdas run on both
    # packages' arrays)
    "while_loop": lambda r: ((lambda x: x.sum() < 40.0,
                              lambda x: x * 1.5 + 1.0, _pos(r, 3)), {}),
    "cond": lambda r: ((np.array(False), lambda a, b: a * b,
                        lambda a, b: a - b, _f(r, 3), _f(r, 3)), {}),
    "case": lambda r: ((np.array(5, np.int32),
                        [lambda x: x + 1.0, lambda x: x * 2.0], _f(r, 3)),
                       {}),
    "scan": lambda r: ((lambda c, x: (c * 0.5 + x, c - x), _f(r, 3),
                        _f(r, 4, 3)), {"reverse": True}),
    "fori_loop": lambda r: ((1, 4, lambda i, v: v * 0.5 + i, _f(r, 3)), {}),
    # quant
    "fake_quantize_abs_max": lambda r: ((_f(r, 3, 4),), {"bit_length": 4}),
    "fake_channel_wise_quantize_abs_max": lambda r: ((_f(r, 3, 4),),
                                                     {"axis": 0}),
    "fake_quantize_moving_average_abs_max": lambda r: (
        (_f(r, 3, 4), 1.5), {"momentum": 0.8}),
    # metrics
    "auc": lambda r: ((r.random(20).astype(np.float32),
                       (r.random(20) < 0.4).astype(np.float32),
                       np.zeros(11, np.float32), np.zeros(11, np.float32)),
                      {}),
    "precision_recall": lambda r: ((r.random(20).astype(np.float32),
                                    (r.random(20) < 0.4).astype(np.float32),
                                    np.array([1, 2, 3], np.float32)), {}),
    # niche
    "modified_huber_loss": lambda r: ((2 * _f(r, 6),
                                       (r.random(6) < 0.5).astype(
                                           np.float32)), {}),
    "unpool": lambda r: ((_f(r, 1, 2, 2, 2), _unpool_indices(
        r, 1, 2, 2, 2, 4, 4), (4, 4)), {}),
    "spp": lambda r: ((_f(r, 2, 2, 5, 6), 3), {"pooling_type": "avg"}),
    "conv_shift": lambda r: ((_f(r, 2, 6), _f(r, 2, 3)), {}),
    "tree_conv": lambda r: ((_f(r, 2, 5, 3), _tree_edges(r),
                             _f(r, 3, 3, 2, 2)), {"max_depth": 3}),
    "var_conv_2d": lambda r: ((_f(r, 2, 2, 5, 6),
                               np.array([5, 3], np.int32),
                               np.array([4, 6], np.int32), _f(r, 3, 18)),
                              {"input_channel": 2, "output_channel": 3,
                               "stride_h": 2}),
    "sequence_topk_avg_pooling": lambda r: ((_f(r, 2, 2, 3, 5),
                                             np.array([3, 1], np.int32),
                                             np.array([5, 2], np.int32)),
                                            {"topks": (1, 3)}),
    # nets
    "glu": lambda r: ((_f(r, 3, 4),), {"axis": 1}),
})

def _boxes(r, n, size=16.0, lo=1.0):
    """``n`` xyxy boxes inside ``size`` pixels, each at least ``lo``
    wide and high."""
    xy = r.random((n, 2)) * size * 0.6
    wh = lo + r.random((n, 2)) * size * 0.4
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _tied_boxes(r):
    """8 boxes with exact duplicates and equal overlaps, and scores tied
    in threes (ties must keep the lower index, as the reference's)."""
    base = np.array([[0, 0, 4, 4], [0, 0, 4, 4], [1, 1, 5, 5],
                     [8, 8, 12, 12], [8, 8, 12, 12], [9, 8, 13, 12],
                     [2, 9, 6, 13], [0, 0, 4, 4]], np.float32)
    scores = np.array([0.9, 0.9, 0.5, 0.5, 0.5, 0.9, 0.3, 0.1], np.float32)
    return base, scores


def _grid_anchors(n=4, size=16.0):
    """n x n square anchors tiling a ``size`` image, normalised xyxy: many
    equal IoUs with an aligned ground truth."""
    step = 1.0 / n
    out = [[j * step, i * step, (j + 1) * step, (i + 1) * step]
           for i in range(n) for j in range(n)]
    return np.array(out, np.float32)


def _gt(r, b, g, norm=True):
    """Padded ground truths (b, g, 4) xyxy (normalised or in 16 pixels),
    labels in [1, 3) and a mask with the last row of the second image
    padding."""
    boxes = np.stack([_boxes(r, g, 1.0 if norm else 16.0,
                             0.2 if norm else 3.0) for _ in range(b)])
    labels = r.integers(1, 3, (b, g)).astype(np.int32)
    mask = np.ones((b, g), bool)
    mask[-1, -1] = False
    return boxes, labels, mask


def _quads(r):
    return np.array([[1, 1, 6, 1.5, 6.5, 5, 0.5, 4.5],
                     [2, 2, 7, 2, 7, 7, 2, 7]], np.float32)


def _deltas(r, *shape):
    return (0.3 * r.standard_normal(shape)).astype(np.float32)


SAMPLES.update({
    # detection: boxes and anchors
    "iou_similarity": lambda r: ((_tied_boxes(r)[0], _boxes(r, 5)), {}),
    "box_coder": lambda r: ((_boxes(r, 6), _boxes(r, 6)),
                            {"variances": (0.1, 0.1, 0.2, 0.2)}),
    "prior_box": lambda r: ((3, 4, 32, 32, (8.0, 16.0)),
                            {"max_sizes": (12.0, 24.0),
                             "aspect_ratios": (1.0, 2.0, 0.5)}),
    "density_prior_box": lambda r: ((2, 3, 32, 48),
                                    {"fixed_sizes": (8.0, 16.0),
                                     "fixed_ratios": (1.0, 2.0),
                                     "densities": (2, 1)}),
    "anchor_generator": lambda r: ((2, 3), {"anchor_sizes": (8, 16),
                                            "aspect_ratios": (0.5, 1.0),
                                            "stride": (8.0, 8.0)}),
    "box_clip": lambda r: ((_boxes(r, 6, 24.0) - 4.0,
                            np.array([10.0, 12.0], np.float32)), {}),
    "yolo_box": lambda r: ((_f(r, 2, 2 * 8, 3, 4),
                            np.array([[96, 128], [90, 120]], np.int32),
                            [(10, 13), (16, 30)], 3),
                           {"conf_thresh": 0.5, "downsample_ratio": 32}),
    "polygon_box_transform": lambda r: ((_f(r, 1, 8, 3, 4),), {}),
    "box_decoder_and_assign": lambda r: ((_boxes(r, 5), _deltas(r, 5, 12),
                                          np.array([[.2, .5, .5], [.9, .1, 0],
                                                    [.3, .3, .3], [0, 0, 1],
                                                    [.4, .4, .2]],
                                                   np.float32)),
                                         {"box_clip_value": 0.5}),
    # detection: NMS
    "nms": lambda r: (_tied_boxes(r), {"iou_threshold": 0.5,
                                       "score_threshold": 0.2,
                                       "max_outputs": 10}),
    "multiclass_nms": lambda r: ((_tied_boxes(r)[0], np.stack(
        [_tied_boxes(r)[1], _tied_boxes(r)[1][::-1].copy(),
         np.full(8, 0.4, np.float32)], 1)),
        {"iou_threshold": 0.5, "score_threshold": 0.2, "max_per_class": 4}),
    "matrix_nms": lambda r: (_tied_boxes(r), {"score_threshold": 0.2,
                                              "nms_top_k": 6,
                                              "keep_top_k": 8}),
    "generate_proposals": lambda r: ((np.repeat(r.random(6), 2).astype(
        np.float32), _deltas(r, 12, 4), _boxes(r, 12, 32.0, 4.0),
        np.array([32.0, 32.0], np.float32)),
        {"pre_nms_top_n": 10, "post_nms_top_n": 8, "nms_thresh": 0.5,
         "min_size": 2.0}),
    "collect_fpn_proposals": lambda r: (
        ([_boxes(r, 3), _boxes(r, 4)],
         [np.array([0.5, 0.7, 0.5], np.float32),
          np.array([0.7, -np.inf, 0.2, 0.5], np.float32)],
         [np.array([True, True, False]), np.array([True, False, True,
                                                   True])]),
        {"post_nms_top_n": 9}),
    "distribute_fpn_proposals": lambda r: ((_boxes(r, 6, 600.0, 4.0),), {}),
    "retinanet_detection_output": lambda r: (
        ([_deltas(r, 6, 4), _deltas(r, 4, 4)],
         [np.repeat(r.random((3, 3)), 2, 0).astype(np.float32),
          r.random((4, 3)).astype(np.float32)],
         [_boxes(r, 6, 32.0, 4.0), _boxes(r, 4, 32.0, 4.0)],
         np.array([32.0, 32.0], np.float32)),
        {"score_threshold": 0.2, "nms_top_k": 8, "keep_top_k": 6}),
    "detection_output": lambda r: ((_deltas(r, 2, 16, 4), np.repeat(
        _f(r, 2, 8, 3), 2, 1), _grid_anchors()),
        {"nms_top_k": 5, "keep_top_k": 6, "score_threshold": 0.2}),
    # detection: RoI sampling
    "roi_pool": lambda r: ((_f(r, 8, 9, 3), np.concatenate(
        [_boxes(r, 3, 8.0), np.array([[3, 3, 3, 3]], np.float32)])),
        {"output_size": (2, 3), "spatial_scale": 1.0}),
    "roi_align": lambda r: ((_f(r, 8, 9, 3), _boxes(r, 3, 16.0)),
                            {"output_size": (2, 3), "spatial_scale": 0.5}),
    "psroi_pool": lambda r: ((_f(r, 6, 7, 12), _boxes(r, 3, 7.0)),
                             {"output_size": 2}),
    "prroi_pool": lambda r: ((_f(r, 6, 7, 3), _boxes(r, 3, 7.0)),
                             {"output_size": (2, 2), "samples_per_bin": 2}),
    "deformable_roi_pooling": lambda r: ((_f(r, 6, 7, 3), _boxes(r, 3, 7.0),
                                          _f(r, 3, 2, 3, 2)),
                                         {"output_size": (2, 3)}),
    "deformable_conv": lambda r: ((_f(r, 1, 5, 5, 2), _f(r, 1, 3, 3, 18),
                                   _f(r, 3, 3, 2, 4)),
                                  {"mask": r.random((1, 3, 3, 9)).astype(
                                      np.float32)}),
    "roi_perspective_transform": lambda r: ((_f(r, 8, 9, 2), _quads(r)),
                                            {"output_size": (3, 4)}),
    # detection: matching and targets
    "bipartite_match": lambda r: ((np.array(
        [[0.5, 0.5, 0.1, 0.0, 0.5, 0.2], [0.5, 0.3, 0.5, 0.0, 0.1, 0.2],
         [0.9, 0.2, 0.2, 0.0, 0.9, 0.0], [0.7, 0.7, 0.7, 0.7, 0.7, 0.7]],
        np.float32), np.array([True, True, True, False])), {}),
    "target_assign": lambda r: ((_f(r, 4, 3), np.array(
        [2, -1, 0, 2, -1, 3], np.int32)), {"mismatch_value": -1.0}),
    "mine_hard_examples": lambda r: ((np.array(
        [0.5, 0.9, 0.5, 0.5, 0.1, 0.9, 0.5, 0.2, 0.3, 0.5], np.float32),
        np.array([-1, 0, -1, -1, -1, -1, 1, -1, -1, -1], np.int32)),
        {"neg_pos_ratio": 2.0}),
    "rpn_target_assign": lambda r: ((_boxes(r, 12, 16.0, 3.0),
                                     _boxes(r, 3, 16.0, 3.0),
                                     np.array([True, True, False])),
                                    {"im_shape": (16, 16),
                                     "batch_size_per_im": 6,
                                     "pos_threshold": 0.5}),
    "retinanet_target_assign": lambda r: (
        (_boxes(r, 12, 16.0, 3.0), _boxes(r, 3, 16.0, 3.0),
         np.array([1, 2, 1], np.int32), np.array([True, True, False])),
        {"negative_overlap": 0.3}),
    "generate_proposal_labels": lambda r: (
        (_boxes(r, 10, 16.0, 3.0), np.array([True] * 8 + [False] * 2),
         _boxes(r, 3, 16.0, 3.0), np.array([1, 2, 1], np.int32),
         np.array([True, True, False])),
        {"batch_size_per_im": 6, "fg_fraction": 0.5, "fg_thresh": 0.3,
         "bg_thresh_hi": 0.3, "return_matches": True}),
    "generate_mask_labels": lambda r: (
        (_boxes(r, 3, 16.0, 3.0), np.array([1, 0, -1], np.int32),
         np.array([True, True, False]),
         (r.random((2, 8, 8)) < 0.5).astype(np.float32)),
        {"resolution": 4, "im_size": 16}),
    # detection: losses
    "ssd_loss": lambda r: ((_deltas(r, 2, 16, 4), _f(r, 2, 16, 3),
                            _grid_anchors()) + _gt(r, 2, 3), {}),
    "sigmoid_focal_loss": lambda r: ((_f(r, 5, 3), np.array(
        [0, 1, 3, 2, 0], np.int32)), {"normalizer": 2.0}),
    "yolov3_loss": lambda r: ((_f(r, 2, 2 * 8, 4, 4), np.concatenate(
        [0.1 + 0.8 * r.random((2, 3, 2)), 0.05 + 0.5 * r.random((2, 3, 2))],
        -1).astype(np.float32), r.integers(0, 3, (2, 3)).astype(np.int32),
        np.array([[True, True, True], [True, True, False]])),
        {"anchors": [(10, 13), (16, 30), (33, 23), (30, 61)],
         "anchor_mask": (2, 3), "class_num": 3, "ignore_thresh": 0.5,
         "downsample_ratio": 8}),
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
    kwargs = {k: to_device(v, device) for k, v in kwargs.items()}
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
    emb = torch.linspace(-1, 1, 12, device=device).reshape(4, 3)
    table = torch.linspace(-2, 2, 150, device=device).reshape(50, 3)
    bias = torch.linspace(-1, 1, 50, device=device)
    label = torch.tensor([3, 0, 49, 3], device=device)
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
        "dropout": lambda g: fn(torch.ones(4000, device=device), g,
                                rate=0.25),
        "nce": lambda g: fn(emb, table, bias, label, g, num_neg=5,
                            num_classes=50),
        "sampled_softmax_with_cross_entropy": lambda g: fn(
            lambda ids: emb @ table[ids].T, label, g, num_samples=6,
            num_classes=50),
        "sample_logits": lambda g: torch.cat([
            o.reshape(4, -1).double() for o in fn(
                torch.arange(120, dtype=torch.float32,
                             device=device).reshape(4, 30) / 30.0,
                label[:, None] % 30, 8, g)], 1),
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
    elif name == "dropout":
        kept = v[v != 0]
        if abs(float((v == 0).double().mean()) - 0.25) > 0.05 or not bool(
                (kept == float(np.float32(1 / 0.75))).all()):
            errs.append("drop rate or survivor scale")
    elif name in ("nce", "sampled_softmax_with_cross_entropy"):
        if a.shape != () or not 0.0 < float(v) < 100.0:
            errs.append(f"loss {v.tolist()}")
    elif name == "sample_logits":
        samples = v[:, :9].long()
        if not (bool((samples[:, 0] == label.cpu() % 30).all())
                and bool((samples[:, 1:] == samples[:1, 1:]).all())
                and int(samples.min()) >= 0 and int(samples.max()) < 30):
            errs.append("samples: labels first, then shared negatives in "
                        "range")
    want_shape = {"gaussian_random_batch_size_like": (5, 2000),
                  "uniform_random_batch_size_like": (5, 800)}.get(name)
    if want_shape and tuple(a.shape) != want_shape:
        errs.append(f"shape {tuple(a.shape)}")
    return errs


def run_battery(device, seed: int = 0) -> Dict:
    """Every op of :data:`SAMPLES` on ``device`` in float32 against its
    numpy reference (or the op on the CPU where the reference has none),
    and every random op through :func:`check_random`. Returns
    ``{"ops", "against_numpy", "against_cpu", "random", "by_module",
    "failures"}`` (``by_module``: ops per registering module;
    ``failures``: name -> mismatches)."""
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
    by_module: Dict[str, int] = {}
    for name in list(SAMPLES) + list(RANDOM):
        mod = get_op(name).module.rsplit(".", 1)[-1]
        by_module[mod] = by_module.get(mod, 0) + 1
    return {"ops": len(SAMPLES) + len(RANDOM), **counts,
            "random": len(RANDOM), "by_module": by_module,
            "failures": failures}
