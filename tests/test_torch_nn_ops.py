"""The port's ``ops/nn.py``, ``nn/layers.py`` (``Conv2D``, ``Pool2D``,
``BatchNorm``), ``nn/nets.py``, ``ops/quant.py``, ``ops/control_flow.py``,
``ops/metrics_ops.py`` and ``ops/niche.py`` against the JAX package on the
CPU, beyond the one sample a registered op gets in
``test_torch_ops_registry.py``: the semantics where the two libraries
part (biased variance, exclusive average pooling, fluid's transposed-conv
size, ``jax.image.resize`` up and down, ``grid_sampler``'s corners),
gradients, the layers in train and eval, the HWIO -> OIHW conversion with
``fold_batch_norms``, straight-through gradients, control flow's
structures, and the draws of the random ops (the parts that do not draw
exactly; the draws by distribution and determinism)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import layers as JL
from paddle_tpu.nn import nets as JN
from paddle_tpu.nn.module import apply_state_updates, capture_state
from paddle_tpu.ops import control_flow as JCF
from paddle_tpu.ops import niche as JNI
from paddle_tpu.ops import nn as J
from paddle_tpu.ops import quant as JQ
from paddle_tpu_torch.inference import fold_batch_norms
from paddle_tpu_torch.models.convert import (load_jax, state_from_jax,
                                             state_tree)
from paddle_tpu_torch.nn import layers as PL
from paddle_tpu_torch.nn import nets as PN
from paddle_tpu_torch.ops import control_flow as PCF
from paddle_tpu_torch.ops import niche as PNI
from paddle_tpu_torch.ops import nn as P
from paddle_tpu_torch.ops import quant as PQ
from torch_parity import (GRAD_ATOL, GRAD_RTOL, close, flat, grads_close,
                          init, loss_close, to_torch)

torch.set_num_threads(2)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _both(name, *args, **kw):
    """op ``name`` of both packages on the same numpy arguments."""
    j = getattr(J, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in args], **kw)
    p = getattr(P, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in args], **kw)
    return p, j


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("size", [(9, 3), (2, 11), (5, 4), (1, 1)],
                         ids=["up_down", "down_up", "same", "to_1"])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_interpolate_is_jax_image_resize(method, size, fmt):
    x = _f(_rng(1), 2, 5, 4, 3) if fmt == "NHWC" else _f(_rng(1), 2, 3, 5, 4)
    p, j = _both("interpolate", x, size, method=method, data_format=fmt)
    close(p, j, what=f"{method} {size}")


def test_resize_aliases_and_trilinear_shrink():
    x = _f(_rng(2), 1, 6, 5, 4, 2)
    p, j = _both("resize_trilinear", x, (3, 7, 2))
    close(p, j)
    img = _f(_rng(3), 2, 6, 9, 2)
    for name, args in (("resize_bilinear", (img, (4, 4))),
                       ("resize_nearest", (img, (3, 12))),
                       ("image_resize_short", (img, 4))):
        p, j = _both(name, *args)
        close(p, j, what=name)


@pytest.mark.parametrize("kw", [
    dict(kernel=3, stride=2, padding=1, pool_type="avg"),
    dict(kernel=2, stride=1, padding=1, pool_type="max"),
    dict(kernel=(2, 3), stride=(2, 1), pool_type="avg", ceil_mode=True),
    dict(global_pooling=True, pool_type="avg", data_format="NCHW"),
], ids=["avg_pad", "max_pad", "avg_rect", "global_nchw"])
def test_pool2d_equals_the_reference(kw):
    p, j = _both("pool2d", _f(_rng(4), 2, 5, 6, 3), **kw)
    close(p, j)


@pytest.mark.parametrize("padding", [0, 1, (2, 0)])
@pytest.mark.parametrize("stride", [1, 2, (2, 3)])
def test_conv2d_transpose_size_and_values(stride, padding):
    r = _rng(5)
    x, w, b = _f(r, 2, 4, 3, 3), _f(r, 3, 3, 3, 2), _f(r, 2)
    p, j = _both("conv2d_transpose", x, w, b, stride=stride, padding=padding)
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    assert p.shape[1:3] == ((4 - 1) * sh + 3 - 2 * ph,
                            (3 - 1) * sw + 3 - 2 * pw)
    close(p, j, 1e-5, 1e-5)


@pytest.mark.parametrize("padding", ["SAME", "VALID", 1])
@pytest.mark.parametrize("stride,dilation,groups",
                         [(1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 1, 2)])
def test_conv2d_values_and_gradients(padding, stride, dilation, groups):
    r = _rng(6)
    x, w, b = _f(r, 2, 7, 6, 4), _f(r, 3, 3, 4 // groups, 6), _f(r, 6)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)

    def jloss(x, w, b):
        out = J.conv2d(x, w, b, **kw)
        return jnp.sin(out).sum(), out

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(*map(jnp.asarray,
                                                        (x, w, b)))
    pt = [t.requires_grad_(True) for t in to_torch(x, w, b)]
    out = P.conv2d(*pt, **kw)
    close(out, jo, 1e-5, 1e-5)
    torch.sin(out).sum().backward()
    for t, g in zip(pt, jg):
        close(t.grad, g, GRAD_ATOL, GRAD_RTOL)


def test_batch_norm_biased_variance_and_momentum():
    r = _rng(7)
    args = (_f(r, 4, 5, 3, 5), _f(r, 5), _f(r, 5), _f(r, 5),
            np.abs(_f(r, 5)) + 0.5)
    for training in (True, False):
        for fmt in ("NHWC", "NCHW"):
            p, j = _both("batch_norm", *args, momentum=0.7,
                         training=training, data_format=fmt)
            for g, w in zip(p, j):
                close(g, w, 1e-5, 1e-5, what=f"{training} {fmt}")


def test_grid_sampler_values_and_gradients():
    r = _rng(8)
    x = _f(r, 2, 3, 4, 5)
    grid = r.uniform(-1.3, 1.3, (2, 3, 4, 2)).astype(np.float32)
    grid[0, 0, 0] = (-1.0, -1.0)            # the corners map to pixels
    grid[0, 0, 1] = (1.0, 1.0)

    def jloss(x, g):
        out = J.grid_sampler(x, g)
        return (out ** 2).sum(), out

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(grid))
    xt, gt = (t.requires_grad_(True) for t in to_torch(x, grid))
    out = P.grid_sampler(xt, gt)
    close(out, jo)
    close(out[0, :, 0, 0], x[0, :, 0, 0], what="corner (-1, -1)")
    close(out[0, :, 0, 1], x[0, :, -1, -1], what="corner (1, 1)")
    (out ** 2).sum().backward()
    close(xt.grad, jg[0], GRAD_ATOL, GRAD_RTOL)
    close(gt.grad, jg[1], GRAD_ATOL, GRAD_RTOL)


# -- layers ----------------------------------------------------------------


def test_conv2d_layer_holds_oihw_and_loads_hwio(monkeypatch):
    jl = JL.Conv2D(4, 6, 3, stride=2, padding=1)
    params = init(jl, seed=1)
    pl = PL.Conv2D.from_jax(params, stride=2, padding=1, device="cpu")
    assert tuple(pl.weight.shape) == (6, 4, 3, 3)
    x = _f(_rng(9), 2, 7, 7, 4)
    close(pl(torch.from_numpy(x)), jl(params, jnp.asarray(x)), 1e-5, 1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.Conv2D.from_jax(params)


def test_batch_norm_layer_train_and_eval():
    jl, pl = JL.BatchNorm(5, momentum=0.8), PL.BatchNorm(5, momentum=0.8)
    params = init(jl, seed=2)
    r = _rng(10)
    load_jax(pl, params)
    x = _f(r, 3, 4, 4, 5)
    with capture_state() as tape:
        jo = jl(params, jnp.asarray(x), training=True)
    new = apply_state_updates(params, tape)
    po = pl.train()(torch.from_numpy(x))
    close(po, jo, 1e-5, 1e-5, what="train out")
    close(pl.mean, new["mean"], 1e-6, 1e-5, what="running mean")
    close(pl.variance, new["variance"], 1e-6, 1e-5, what="running var")
    jo = jl(new, jnp.asarray(x), training=False)
    close(pl.eval()(torch.from_numpy(x)), jo, 1e-5, 1e-5, what="eval")
    assert {n for n, _ in pl.named_parameters()} == {"scale", "bias"}


def test_simple_img_conv_pool_equals_the_reference():
    jm = JN.SimpleImgConvPool(3, 4, 3, pool_size=2, pool_stride=2,
                              conv_padding=1, act="relu")
    pm = PN.SimpleImgConvPool(3, 4, 3, pool_size=2, pool_stride=2,
                              conv_padding=1, act="relu")
    params = init(jm, seed=3)
    load_jax(pm, params)
    x = _f(_rng(11), 2, 6, 6, 3)

    def jloss(p):
        out = jm(p, jnp.asarray(x))
        return jnp.tanh(out).sum(), out

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    out = pm(torch.from_numpy(x))
    close(out, jo, 1e-5, 1e-5)
    torch.tanh(out).sum().backward()
    grads_close(pm, jg, transpose={
        "conv.weight": lambda w: np.transpose(w, (3, 2, 0, 1))})


def test_folded_conv_bn_equals_the_unfolded_model():
    """``Conv2D.from_jax`` (HWIO -> OIHW) of a ``SimpleImgConvPool``'s
    conv and a trained ``BatchNorm`` after it: ``fold_batch_norms`` over
    the port's state tree gives the same eval output."""
    jm = JN.SimpleImgConvPool(3, 4, 3, pool_size=2, pool_stride=2)
    params = init(jm, seed=4)

    class ConvBNPool(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = PL.Conv2D.from_jax(params["conv"], device="cpu")
            self.bn = PL.BatchNorm(4)
            self.pool = PL.Pool2D(2, 2)

        def forward(self, x):
            return self.pool(torch.relu(self.bn(self.conv(x))))

    model = ConvBNPool()
    r = _rng(12)
    with torch.no_grad():
        model.bn.scale.copy_(torch.from_numpy(_f(r, 4)))
        model.bn.bias.copy_(torch.from_numpy(_f(r, 4)))
        model.bn.mean.copy_(torch.from_numpy(_f(r, 4)))
        model.bn.variance.copy_(torch.from_numpy(np.abs(_f(r, 4)) + 0.5))
    x = torch.from_numpy(_f(r, 2, 6, 6, 3))
    want = model.eval()(x)
    folded = fold_batch_norms(state_tree(model))
    model.load_state_dict(state_from_jax(folded))
    torch.testing.assert_close(model(x), want, atol=1e-5, rtol=1e-5)
    assert float(model.bn.mean.abs().max()) == 0.0


def test_img_conv_group_train_and_eval():
    jm = JN.ImgConvGroup(3, [4, 5], pool_size=2, conv_act="relu",
                         conv_with_batchnorm=True, pool_stride=2)
    pm = PN.ImgConvGroup(3, [4, 5], pool_size=2, conv_act="relu",
                         conv_with_batchnorm=True, pool_stride=2)
    params = init(jm, seed=5)
    load_jax(pm, params)
    x = _f(_rng(13), 2, 6, 6, 3)
    for training in (True, False):
        load_jax(pm, params)
        jo = jm(params, jnp.asarray(x), training=training)
        close(pm.train(training)(torch.from_numpy(x)), jo, 1e-5, 1e-5,
              what=f"training={training}")


def test_sequence_conv_pool_and_glu():
    jm = JN.SequenceConvPool(4, 6, 4, act="tanh", pool_type="sqrt")
    pm = PN.SequenceConvPool(4, 6, 4, act="tanh", pool_type="sqrt")
    params = init(jm, seed=6)
    load_jax(pm, params)
    r = _rng(14)
    x, lengths = _f(r, 3, 7, 4), np.array([0, 4, 7], np.int32)
    close(pm(*to_torch(x, lengths)), jm(params, jnp.asarray(x),
                                        jnp.asarray(lengths)), 1e-5, 1e-5)
    y = _f(r, 3, 8)
    close(PN.glu(torch.from_numpy(y)), JN.glu(jnp.asarray(y)))


# -- random ops: what does not draw, exactly ---------------------------------


def test_nce_without_negatives_and_sampled_softmax_without_samples():
    r = _rng(15)
    emb, w, b = _f(r, 4, 3), _f(r, 10, 3), _f(r, 10)
    label = np.array([1, 9, 0, 1], np.int32)
    j = J.nce(*map(jnp.asarray, (emb, w, b, label)), jax.random.PRNGKey(0),
              num_neg=0, num_classes=10)
    p = P.nce(*to_torch(emb, w, b, label), torch.Generator(), num_neg=0,
              num_classes=10)
    loss_close(p, j)
    j = J.sampled_softmax_with_cross_entropy(
        lambda ids: jnp.asarray(emb) @ jnp.asarray(w)[ids].T,
        jnp.asarray(label), jax.random.PRNGKey(0), num_samples=0,
        num_classes=10)
    p = P.sampled_softmax_with_cross_entropy(
        lambda ids: torch.from_numpy(emb) @ torch.from_numpy(w)[ids].T,
        torch.from_numpy(label), torch.Generator(), num_samples=0,
        num_classes=10)
    loss_close(p, j)


def test_sample_logits_with_customized_samples():
    r = _rng(16)
    logits = _f(r, 3, 12)
    labels = np.array([[1], [5], [11]], np.int32)
    samples = np.concatenate([labels, np.tile([[5, 0, 5, 7]], (3, 1))], 1)
    probs = r.uniform(0.05, 0.9, (3, 5)).astype(np.float32)
    j = JNI.sample_logits(jnp.asarray(logits), jnp.asarray(labels), 4,
                          customized_samples=jnp.asarray(samples),
                          customized_probabilities=jnp.asarray(probs))
    p = PNI.sample_logits(*to_torch(logits, labels), 4,
                          customized_samples=torch.from_numpy(samples),
                          customized_probabilities=torch.from_numpy(probs))
    for g, w in zip(p, j):
        close(g, w)


@pytest.mark.parametrize("op", ["dropout", "nce", "sample_logits"])
def test_random_draws_follow_the_generator(op):
    r = _rng(17)
    x = torch.from_numpy(_f(r, 64, 8))

    def call(seed):
        g = torch.Generator().manual_seed(seed)
        if op == "dropout":
            return P.dropout(x, g, rate=0.5)
        if op == "nce":
            return P.nce(x[:4, :3], x[:20, :3], x[:20, 0], torch.arange(4), g,
                         num_neg=3, num_classes=20)
        return PNI.sample_logits(x[:4, :20], torch.zeros(4, 1,
                                                         dtype=torch.long),
                                 6, g)[0]

    torch.testing.assert_close(call(0), call(0), rtol=0, atol=0)
    assert not torch.equal(call(0), call(1))
    assert torch.equal(P.dropout(x, None, training=False), x)


# -- quant -----------------------------------------------------------------


@pytest.mark.parametrize("op", ["fake_quantize_abs_max",
                                "fake_channel_wise_quantize_abs_max",
                                "fake_quantize_moving_average_abs_max"])
def test_fake_quant_values_and_straight_through_gradients(op):
    r = _rng(18)
    x = _f(r, 4, 6)
    x[0, 0] = 2.5 / 127 * 7      # a half-way value: rounds to even
    extra = (np.float32(0.8),) if "moving" in op else ()

    def jloss(v):
        out, scale = getattr(JQ, op)(v, *extra)
        return (out * jnp.arange(24.0).reshape(4, 6)).sum(), (out, scale)

    (_, (jo, js)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, scale = getattr(PQ, op)(xt, *[float(e) for e in extra])
    close(out, jo)
    close(scale, js)
    (out * torch.arange(24.0).reshape(4, 6)).sum().backward()
    close(xt.grad, jg, GRAD_ATOL, GRAD_RTOL)


def test_quantize_weight_tree():
    r = _rng(19)
    tree = {"fc": {"weight": _f(r, 4, 3), "bias": _f(r, 3)},
            "emb": {"table": _f(r, 5, 2)}}
    j = JQ.quantize_weight_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    p = PQ.quantize_weight_tree(jax.tree_util.tree_map(torch.from_numpy,
                                                       tree))
    got = flat(p)
    for k, v in flat(j).items():
        close(got[k], v, what=k)


# -- control flow ------------------------------------------------------------


def test_scan_over_a_tuple_in_both_orders():
    r = _rng(20)
    xs = (_f(r, 5, 2), _f(r, 5, 3))
    init_c = _f(r, 2)

    def fn(c, x):
        a, b = x
        return c * 0.5 + a, {"s": c.sum() + b.sum(), "v": c - a}

    for reverse in (False, True):
        jc, jy = JCF.scan(fn, jnp.asarray(init_c),
                          tuple(map(jnp.asarray, xs)), reverse=reverse)
        pc, py = PCF.scan(fn, torch.from_numpy(init_c),
                          tuple(to_torch(*xs)), reverse=reverse)
        close(pc, jc)
        for k in ("s", "v"):
            close(py[k], jy[k], what=f"{k} reverse={reverse}")
    jc, _ = JCF.scan(lambda c, _: (c + 1.0, None), jnp.zeros(2), None,
                     length=3)
    pc, _ = PCF.scan(lambda c, _: (c + 1.0, None), torch.zeros(2), None,
                     length=3)
    close(pc, jc)


def test_tensor_arrays_and_py_func():
    x = torch.arange(6.0).reshape(2, 3)
    arr = PCF.create_array(3, x[0])
    arr2 = PCF.array_write(PCF.array_write(arr, 0, x[0]), 2, x[1])
    assert PCF.array_length(arr2) == 3
    assert float(arr.stack().abs().sum()) == 0.0    # writes return new
    torch.testing.assert_close(PCF.array_read(arr2, 2), x[1])
    torch.testing.assert_close(PCF.array_read(arr2, 7), x[1])  # clamped
    ja = JCF.array_write(JCF.array_write(JCF.create_array(
        3, jnp.zeros(3)), 0, jnp.arange(3.0)), 2, jnp.arange(3.0, 6.0))
    for axis in (0, 1):
        close(PCF.tensor_array_to_tensor(arr2, axis),
              JCF.tensor_array_to_tensor(ja, axis))
    out = PCF.py_func(lambda a, b: (a * 2, (a + b).sum()),
                      (x, x), (x, np.zeros((), np.float32)))
    torch.testing.assert_close(out[0], x * 2)
    assert out[1].shape == () and float(out[1]) == 30.0
    with pytest.raises(ValueError, match="shape"):
        PCF.py_func(lambda a: a, (x,), (np.zeros((3,), np.float32),))


# -- the layers' reference options (weight_init/bias_init, FC, LayerNorm's
# scale/shift, Embedding's padding_idx/weight_init) -----------------------

def _layer_parity(jl, pl, params, x, what):
    """forward and every parameter's gradient (of a fixed weighting of the
    output) of the reference layer and the port's, loaded from one tree,
    fp32 at rtol 1e-5 / atol 1e-6"""
    load_jax(pl, params)
    assert {n for n, _ in pl.named_parameters()} == set(flat(params)), what
    r = _rng(7)
    jx = jnp.asarray(x)
    jo = jl(params, jx)
    w = r.standard_normal(jo.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jl(p, jx) * w))(params)
    po = pl(torch.from_numpy(x))
    close(po, jo, 1e-6, 1e-5, what=f"{what} forward")
    (po * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in pl.named_parameters()}
    want = flat(jg)
    assert set(got) == set(want), what
    for name, g in got.items():
        close(g, want[name], 1e-6, 1e-5, what=f"{what} d{name}")
    return po


def test_linear_inits_and_fc_are_the_reference():
    from paddle_tpu.nn import initializer as JI
    from paddle_tpu_torch.nn import initializer as PI
    assert PL.FC is PL.Linear
    jl = JL.FC(5, 3, weight_init=JI.constant(0.25),
               bias_init=JI.constant(-0.5))
    pl = PL.FC(5, 3, weight_init=PI.constant(0.25),
               bias_init=PI.constant(-0.5))
    pl.reset_parameters()
    want = jl.init(jax.random.PRNGKey(0))
    close(pl.weight, want["weight"], 0, 0, what="weight_init")
    close(pl.bias, want["bias"], 0, 0, what="bias_init")
    _layer_parity(jl, pl, init(jl, seed=3), _f(_rng(4), 2, 4, 5), "fc")


@pytest.mark.parametrize("shape,scale,shift", [
    (6, True, True), (6, False, True), (6, True, False), (6, False, False),
    ((3, 4), True, True), ((3, 4), False, True)])
def test_layer_norm_scale_shift_options(shape, scale, shift):
    jl = JL.LayerNorm(shape, epsilon=1e-5, scale=scale, shift=shift)
    pl = PL.LayerNorm(shape, epsilon=1e-5, scale=scale, shift=shift)
    names = {n for n, _ in pl.named_parameters()}
    assert names == set(init(jl)) == \
        {n for n, on in (("scale", scale), ("bias", shift)) if on}
    pl.reset_parameters()
    dims = (shape,) if isinstance(shape, int) else shape
    x = _f(_rng(5), 2, 3, *dims)
    params = init(jl, seed=6)
    if not params:           # no parameter: forward only
        close(pl(torch.from_numpy(x)), jl(params, jnp.asarray(x)),
              1e-6, 1e-5, what="bare layer norm")
        return
    _layer_parity(jl, pl, params, x, f"layer_norm {shape} {scale} {shift}")


@pytest.mark.parametrize("padding_idx", [None, 0, 3])
def test_embedding_padding_idx_and_weight_init(padding_idx):
    from paddle_tpu.nn import initializer as JI
    from paddle_tpu_torch.nn import initializer as PI
    jl = JL.Embedding(7, 4, padding_idx=padding_idx,
                      weight_init=JI.constant(0.125))
    pl = PL.Embedding(7, 4, padding_idx, PI.constant(0.125))
    pl.reset_parameters()
    close(pl.weight, jl.init(jax.random.PRNGKey(0))["weight"], 0, 0,
          what="weight_init")
    ids = np.array([[0, 3, 5, 3, 1], [6, 0, 2, 3, 3]], np.int64)
    params = init(jl, seed=8)
    load_jax(pl, params)
    jo = jl(params, jnp.asarray(ids))
    w = _f(_rng(9), *jo.shape)
    jg = jax.grad(lambda p: jnp.sum(jl(p, jnp.asarray(ids)) * w))(params)
    po = pl(torch.from_numpy(ids))
    close(po, jo, 1e-6, 1e-5, what="embedding forward")
    (po * torch.from_numpy(w)).sum().backward()
    close(pl.weight.grad, jg["weight"], 1e-6, 1e-5, what="embedding grad")
    if padding_idx is not None:
        pad = torch.from_numpy(ids == padding_idx)
        assert bool(pad.any())
        assert torch.count_nonzero(po[pad]) == 0
        assert torch.count_nonzero(pl.weight.grad[padding_idx]) == 0
        assert float(pl.weight.detach()[padding_idx].abs().sum()) > 0


def test_sequential_and_layer_list_carry_the_reference_tree():
    from paddle_tpu.nn import module as JM
    from paddle_tpu_torch.nn import module as PM
    jseq = JM.Sequential(JL.Linear(6, 5), JL.LayerNorm(5, shift=False),
                         JL.Linear(5, 3))
    pseq = PM.Sequential(PL.Linear(6, 5), PL.LayerNorm(5, shift=False),
                         PL.Linear(5, 3))
    assert isinstance(pseq.layers, PM.LayerList) and len(pseq.layers) == 3
    params = init(jseq, seed=12)
    _layer_parity(jseq, pseq, params, _f(_rng(13), 2, 4, 6), "sequential")
    lst = PM.LayerList([PL.Linear(2, 2)]).append(PL.Linear(2, 2))
    assert [n for n, _ in lst.named_parameters()] == [
        "0.weight", "0.bias", "1.weight", "1.bias"]
