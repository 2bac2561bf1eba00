"""The port's CRNN (``models/ocr.py``) and DCGAN (``models/gan.py``)
against the JAX package on the CPU, on the reference's weights: CRNN's
per-column logits, CTC loss and gradients (eval and training mode) and
its greedy decoding exactly; one ``gan_step`` on the same two latent
batches (drawn with the reference's key split): both losses, every
parameter after the two updates, and the running statistics: the
discriminator's from the real batch only, the generator's from its own
step's forward, as the reference's scoped tapes move them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gan as jgan
from paddle_tpu.models import ocr as jocr
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import gan, ocr
from paddle_tpu_torch.nn.module import capture_state
from paddle_tpu_torch.train import make_train_state
from test_torch_model_zoo_cv import _grads_close
from test_torch_resnet import _transposes
from torch_parity import close, flat, init, loss_close

torch.set_num_threads(2)

CRNN_KW = dict(in_ch=1, width=8, hidden=16, img_h=32)


def _crnn():
    jm = jocr.CRNN(12, **CRNN_KW)
    jm._assign_paths(())
    params = init(jm, 0)
    pm = ocr.CRNN.from_jax(params, 12, **CRNN_KW, device="cpu")
    rng = np.random.default_rng(5)
    image = rng.standard_normal((3, 32, 48, 1)).astype(np.float32)
    label = rng.integers(1, 12, (3, 5)).astype(np.int32)
    lengths = np.array([5, 3, 1], np.int32)
    return jm, params, pm, image, label, lengths


@pytest.mark.parametrize("training", [False, True])
def test_crnn_loss_and_gradients_equal_the_reference(training):
    jm, params, pm, image, label, lengths = _crnn()
    want = jm.logits(params, jnp.asarray(image), training=False)
    with torch.no_grad():
        close(pm.eval().logits(torch.from_numpy(image)), want, 1e-5, 1e-4,
              "logits")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(image), jnp.asarray(label),
                          jnp.asarray(lengths), training=training),
        has_aux=True))(params)
    pm.train(training)
    with capture_state():
        loss, _ = pm.loss(torch.from_numpy(image), torch.from_numpy(label),
                          torch.from_numpy(lengths))
    loss.backward()
    loss_close(loss, jl)
    _grads_close(pm, jg)


def test_crnn_greedy_decoding_equals_the_reference():
    jm, params, pm, image, _, _ = _crnn()
    tokens, lengths = jm.recognize(params, jnp.asarray(image))
    with torch.no_grad():
        got_t, got_l = pm.eval().recognize(torch.from_numpy(image))
    close(got_t, tokens, what="tokens")
    close(got_l, lengths, what="lengths")


def _gan_pair():
    jg_m = jgan.DCGANGenerator(zdim=16, base=8, n_up=3, out_ch=1)
    jd_m = jgan.DCGANDiscriminator(in_ch=1, base=8, n_down=3)
    jg_m._assign_paths(())
    jd_m._assign_paths(())
    gp, dp = init(jg_m, 0), init(jd_m, 1)
    pg = gan.DCGANGenerator.from_jax(gp, zdim=16, base=8, n_up=3, out_ch=1,
                                     device="cpu")
    pd = gan.DCGANDiscriminator.from_jax(dp, in_ch=1, base=8, n_down=3,
                                         device="cpu")
    return jg_m, jd_m, gp, dp, pg, pd


def _stats(module):
    return {n: b.clone() for n, b in module.named_buffers()}


def test_gan_step_equals_the_reference():
    jg_m, jd_m, gp, dp, pg, pd = _gan_pair()
    real = np.random.default_rng(6).uniform(
        -1, 1, (4, 32, 32, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    # Momentum, not Adam: Adam's first step is lr * sign(g), which flips
    # with rounding wherever a gradient is ~0
    jgo = jopt.Momentum(learning_rate=0.1, momentum=0.9)
    jdo = jopt.Momentum(learning_rate=0.1, momentum=0.9)
    jstep = jax.jit(jgan.gan_step(jg_m, jd_m, jgo, jdo))
    g_state = {"params": gp, "opt": jgo.init(gp)}
    d_state = {"params": dp, "opt": jdo.init(dp)}
    g_state, d_state, jm = jstep(g_state, d_state, jnp.asarray(real), key)
    z1, z2 = jax.random.split(key)
    z = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, (4, 16))))
              for k in (z1, z2))

    go = popt.Momentum(pg.parameters(), learning_rate=0.1, momentum=0.9)
    do = popt.Momentum(pd.parameters(), learning_rate=0.1, momentum=0.9)
    g_before, d_before = _stats(pg), _stats(pd)
    step = gan.gan_step(pg, pd, go, do)
    gs, ds = make_train_state(pg, go), make_train_state(pd, do)
    _, _, metrics = step(gs, ds, torch.from_numpy(real), z=z)
    loss_close(metrics["d_loss"], jm["d_loss"], "d_loss")
    loss_close(metrics["g_loss"], jm["g_loss"], "g_loss")
    assert int(gs["step"]) == 1 and int(ds["step"]) == 1
    for module, tree in ((pg, g_state["params"]), (pd, d_state["params"])):
        want = flat(jax.device_get(tree))
        tr = _transposes(module)
        got = dict(module.named_parameters())
        got.update(dict(module.named_buffers()))
        assert set(got) == set(want)
        for name, value in got.items():
            w = tr[name](want[name]) if name in tr else want[name]
            close(value, w, 1e-5, 1e-4, name)
    # which statistics moved: the discriminator's as one forward of the
    # real batch from the old ones; the generator's once
    pd2 = gan.DCGANDiscriminator.from_jax(dp, in_ch=1, base=8, n_down=3,
                                          device="cpu").train()
    pd2(torch.from_numpy(real))
    for name, b in pd.named_buffers():
        torch.testing.assert_close(b, dict(pd2.named_buffers())[name],
                                   rtol=1e-6, atol=1e-6)
    assert all(not torch.equal(b, g_before[n])
               for n, b in pg.named_buffers())
    assert all(not torch.equal(b, d_before[n])
               for n, b in pd.named_buffers())


def test_gan_step_draws_from_the_generator():
    *_, pg, pd = _gan_pair()
    go = popt.Adam(pg.parameters(), learning_rate=1e-3)
    do = popt.Adam(pd.parameters(), learning_rate=1e-3)
    step = gan.gan_step(pg, pd, go, do)
    real = torch.zeros(2, 32, 32, 1)
    gs, ds = make_train_state(pg, go), make_train_state(pd, do)
    _, _, a = step(gs, ds, real, torch.Generator().manual_seed(0))
    assert np.isfinite(float(a["d_loss"])) and np.isfinite(
        float(a["g_loss"]))
    with torch.no_grad():
        out = pg.eval()(torch.zeros(2, 16))
    assert out.shape == (2, 32, 32, 1) and float(out.abs().max()) <= 1.0
