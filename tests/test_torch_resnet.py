"""The port's ResNet (``paddle_tpu_torch.models.resnet``) against the JAX
package on the CPU: ResNet-18 and ResNet-50 logits, losses and gradients
on the reference's weights, the space-to-depth stem (the port's s2d stem
equals its conv7 stem on converted weights, and the JAX s2d stem), and
BatchNorm's running statistics inside ``build_train_step``: with
``remat=True`` and with ``grad_accum_steps=2`` they equal the JAX
package's state tape after a step within 1e-6, and an eval step under the
bf16 policy returns bf16 logits. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu import train as jtrain
from paddle_tpu.core import dtypes as jdtypes
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.amp import make_amp_state, scaled_train_step
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.inference import fold_batch_norms
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.nn.layers import BatchNorm
from paddle_tpu_torch.nn.module import capture_state
from paddle_tpu_torch.train import (build_eval_step, build_train_step,
                                    make_train_state)
from torch_parity import (GRAD_ATOL, GRAD_RTOL, OP_ATOL, OP_RTOL, close,
                          flat, grads_close, init, loss_close)

torch.set_num_threads(2)

HWIO = {"weight"}


def _hwio_to_oihw(w):
    return np.transpose(w, (3, 2, 0, 1))


def _transposes(model):
    """Parameter names whose reference layout is HWIO."""
    out = {}
    for name, mod in model.named_modules():
        for pname in getattr(mod, "jax_layouts", {}):
            out[f"{name}.{pname}" if name else pname] = _hwio_to_oihw
    return out


def _pair(depth, width=8, classes=10, stem="conv7", seed=0):
    jm = jresnet.ResNet(depth, num_classes=classes, width=width, stem=stem)
    jm._assign_paths(())          # the state tape's paths, as init() sets
    params = init(jm, seed)
    pm = resnet.ResNet.from_jax(params, depth, num_classes=classes,
                                width=width, stem=stem, device="cpu")
    return jm, params, pm


def _batch(b=4, hw=32, classes=10, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            rng.integers(0, classes, b).astype(np.int32))


def params_only(tree):
    """A reference tree without BatchNorm's running statistics (the
    port's buffers, which take no gradient)."""
    if not isinstance(tree, dict):
        return tree
    return {k: params_only(v) for k, v in tree.items()
            if k not in ("mean", "variance")}


def _stats(tree):
    """Every BatchNorm's ``mean``/``variance`` of a reference tree."""
    return {k: v for k, v in flat(tree).items()
            if k.endswith((".mean", ".variance"))}


@pytest.mark.parametrize("depth", [18, 50])
def test_logits_loss_and_gradients_equal_the_reference(depth):
    """Eval logits, and the loss and gradients in eval and training mode
    for ResNet-18 and in eval mode for ResNet-50. At width 8 ResNet-50's
    training-mode loss and gradients are ill-conditioned under these
    weights (BatchNorm by the batch over 16 blocks): both packages' fp32
    numbers differ from an fp64 recompute of the port, the loss by up to
    7e-6 relative and the last stages' gradients by up to 1e-2 of their
    scale, so the two cannot agree to 1e-5."""
    jm, params, pm = _pair(depth)
    x, y = _batch(hw=64)
    want = jax.jit(lambda p, x: jm(p, x, training=False))(
        params, jnp.asarray(x))
    close(pm.eval()(torch.from_numpy(x)), want, 1e-5, 1e-4, "eval logits")
    for training in ((False, True) if depth == 18 else (False,)):
        (jl, jaux), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jnp.asarray(x), jnp.asarray(y),
                              training=training), has_aux=True))(params)
        pm.train(training)
        pm.zero_grad(set_to_none=True)
        loss, aux = pm.loss(torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        loss_close(loss, jl)
        close(aux["acc"], jaux["acc"], what="acc")
        grads_close(pm, params_only(jax.device_get(jg)),
                    transpose=_transposes(pm))


def test_s2d_stem_equals_conv7_stem_and_the_reference():
    jm7, p7, pm7 = _pair(50, width=16)
    jms = jresnet.ResNet(50, num_classes=10, width=16, stem="s2d")
    ps = init(jms, 0)
    ps["stem"]["conv"]["weight"] = np.asarray(jresnet.stem_weights_to_s2d(
        jnp.asarray(p7["stem"]["conv"]["weight"])))
    ps["stem"]["bn"] = p7["stem"]["bn"]
    pms = resnet.ResNet.from_jax(ps, 50, num_classes=10, width=16,
                                 stem="s2d", device="cpu")
    # the port's own conversion of its OIHW weights gives the same tensor
    close(resnet.stem_weights_to_s2d(pm7.stem.conv.weight.detach()),
          pms.stem.conv.weight.detach().numpy(), 0, 0, "converted weight")
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        s7 = pm7.eval().stem(xt)
        ss = pms.eval().stem(xt)
    assert float((s7 - ss).abs().max()) < 1e-4
    close(ss, jms.stem(ps["stem"], jnp.asarray(x)), 1e-5, 1e-4, "s2d stem")
    # space_to_depth's channel order is the reference's
    close(resnet.space_to_depth(xt), jresnet.space_to_depth(jnp.asarray(x)),
          0, 0, "space_to_depth")


def _jax_step(jm, params, x, y, **kw):
    optimizer = jopt.Momentum(learning_rate=0.1, momentum=0.9)
    state = {"params": params, "opt": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jtrain.build_train_step(
        lambda p, **b: jm.loss(p, **b, training=True), optimizer, **kw))
    state, metrics = step(state, image=jnp.asarray(x), label=jnp.asarray(y))
    return float(metrics["loss"]), jax.device_get(state["params"])


def _port_step(pm, x, y, **kw):
    pm.train()
    opt = popt.Momentum(pm.parameters(), learning_rate=0.1, momentum=0.9)
    state = make_train_state(pm, opt)
    step = build_train_step(lambda m, **b: m.loss(**b), opt, **kw)
    state, metrics = step(state, image=torch.from_numpy(x),
                          label=torch.from_numpy(y))
    return metrics


@pytest.mark.parametrize("kw", [{}, {"remat": True},
                                {"grad_accum_steps": 2}],
                         ids=["plain", "remat", "grad_accum_2"])
def test_running_statistics_after_a_step_equal_the_reference(kw):
    """One Momentum step of ResNet-18: the running statistics within 1e-6
    of the reference's state tape, the loss and the parameters as the
    reference's. With ``remat=True`` the port is held to the reference's
    step without remat, which a recompute must equal: the reference's
    own remat over a BatchNorm model leaks a tracer (its tape records
    inside ``jax.checkpoint``)."""
    jm, params, pm = _pair(18)
    x, y = _batch(b=4, hw=64)
    jkw = {k: v for k, v in kw.items() if k != "remat"}
    jl, jparams = _jax_step(jm, params, x, y, **jkw)
    metrics = _port_step(pm, x, y, **kw)
    loss_close(metrics["loss"], jl)
    want = _stats(jparams)
    got = dict(pm.named_buffers())
    assert set(got) == set(want)
    for name, w in want.items():
        close(got[name], w, 1e-6, 1e-6, name)
    # the parameters moved as the reference's did
    for name, p in pm.named_parameters():
        w = flat(jparams)[name]
        if name in _transposes(pm):
            w = _hwio_to_oihw(w)
        close(p, w, 1e-5, 1e-4, name)


def test_remat_and_accumulation_move_a_single_batchnorm_once():
    """The faults as first seen: one BatchNorm(3), one step; remat used to
    move channel 0's mean 1.9 times as far, and accumulation used to move
    it micro-batch after micro-batch."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 2, 2, 3)).astype(np.float32))

    def moved(**kw):
        bn = BatchNorm(3)
        w = torch.nn.Parameter(torch.ones(3))
        holder = torch.nn.Module()
        holder.bn, holder.w = bn, w
        opt = popt.SGD(holder.parameters(), learning_rate=0.1)
        step = build_train_step(
            lambda m, x: (m.bn(x) * m.w).square().mean(), opt, **kw)
        step(make_train_state(holder, opt), x=x)
        return bn.mean.clone(), bn.variance.clone()

    plain = moved()
    remat = moved(remat=True)
    torch.testing.assert_close(remat[0], plain[0], rtol=0, atol=0)
    torch.testing.assert_close(remat[1], plain[1], rtol=0, atol=0)
    # accumulation keeps the last micro-batch's statistics, computed from
    # the old ones
    accum = moved(grad_accum_steps=2)
    last = x[4:]
    want = 0.1 * last.mean(dim=(0, 1, 2))
    torch.testing.assert_close(accum[0], want, rtol=1e-6, atol=1e-7)
    # outside a capture the layer still writes in place; inside it reports
    bn = BatchNorm(3)
    with capture_state() as tape:
        bn(x)
    assert float(bn.mean.abs().sum()) == 0.0 and len(tape.updates) == 2
    ptr = bn.mean.data_ptr()
    tape.apply()
    assert bn.mean.data_ptr() == ptr and float(bn.mean.abs().sum()) > 0
    bn2 = BatchNorm(3)
    bn2(x)
    torch.testing.assert_close(bn2.mean, bn.mean, rtol=0, atol=0)


def test_bf16_eval_logits_stay_bf16_as_the_reference():
    jm, params, pm = _pair(18)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    x, _ = _batch(b=2, hw=32)
    jeval = jtrain.build_eval_step(
        lambda p, image: jm(p, image, training=False),
        policy=jdtypes.get_policy("bf16"))
    want = jeval(params, image=jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    step = build_eval_step(lambda m, image: m(image),
                           policy=dtypes.get_policy("bf16"))
    got = step(pm.eval(), image=torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # the buffers stay the fp32 masters
    assert all(b.dtype == torch.float32 for b in pm.buffers())
    # bf16 rounding apart, the same logits
    scale = float(np.abs(np.asarray(want.astype(jnp.float32))).max())
    err = float(np.abs(got.float().numpy()
                       - np.asarray(want.astype(jnp.float32))).max())
    assert err < 0.05 * scale, (err, scale)


def test_bf16_train_step_writes_fp32_statistics():
    _, _, pm = _pair(18, width=4, classes=5)
    x, y = _batch(b=4, hw=16, classes=5)
    before = {n: b.clone() for n, b in pm.named_buffers()}
    metrics = _port_step(pm, x, y, policy=dtypes.get_policy("bf16"))
    assert torch.isfinite(metrics["loss"])
    for n, b in pm.named_buffers():
        assert b.dtype == torch.float32
        assert not torch.equal(b, before[n]), n


def test_amp_step_keeps_statistics_on_a_skipped_step():
    _, _, pm = _pair(18, width=4, classes=5)
    x, y = _batch(b=4, hw=16, classes=5)
    pm.train()
    opt = popt.Momentum(pm.parameters(), learning_rate=0.1, momentum=0.9)
    state = make_amp_state(pm, opt)
    step = scaled_train_step(lambda m, **b: m.loss(**b), opt)
    before = {n: b.clone() for n, b in pm.named_buffers()}
    state["loss_scale"]["scale"].fill_(float("inf"))
    _, m = step(state, image=torch.from_numpy(x), label=torch.from_numpy(y))
    assert not bool(m["grads_finite"])
    for n, b in pm.named_buffers():
        assert torch.equal(b, before[n]), n
    state["loss_scale"]["scale"].fill_(1.0)     # a finite step moves them
    _, m = step(state, image=torch.from_numpy(x), label=torch.from_numpy(y))
    assert bool(m["grads_finite"])
    assert not torch.equal(pm.stem.bn.mean, before["stem.bn.mean"])


def test_fold_batch_norms_gives_the_eval_logits():
    _, _, pm = _pair(18, width=4, classes=5)
    x, _ = _batch(b=2, hw=16, classes=5)
    xt = torch.from_numpy(x)
    pm.eval()
    with torch.no_grad():
        want = pm(xt)
        folded = fold_batch_norms(convert.state_tree(pm))
        state = {k: torch.as_tensor(v) for k, v in flat(folded).items()}
        got = torch.func.functional_call(pm, state, (xt,))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
