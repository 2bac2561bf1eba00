"""The port's ``nn/moe.py`` and ``nn/distributions.py`` against the JAX
package on the CPU. MoE: outputs, ``aux_loss`` and gradients within
tolerance and ``expert_counts`` exactly, top-1 and top-2 at a capacity
that drops tokens, router noise only in training with a generator.
Distributions: ``log_prob``, ``entropy``, ``probs`` and KL within float
tolerance; ``sample`` by shape, moments and same-generator determinism
(a ``torch.Generator`` cannot give JAX's bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import distributions as JD
from paddle_tpu.nn import moe as JM
from paddle_tpu_torch.models.convert import load_jax
from paddle_tpu_torch.nn import distributions as PD
from paddle_tpu_torch.nn import moe as PM
from torch_parity import GRAD_ATOL, GRAD_RTOL, close, grads_close, init

torch.set_num_threads(2)
D, F, E = 8, 12, 4


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 0.75), (2, 0.5),
                                                   (2, 2.0)])
def test_moe_equals_the_reference(top_k, capacity_factor):
    jm = JM.MoEFeedForward(D, F, E, top_k=top_k,
                           capacity_factor=capacity_factor)
    pm = PM.MoEFeedForward(D, F, E, top_k=top_k,
                           capacity_factor=capacity_factor)
    params = init(jm, seed=top_k)
    load_jax(pm, params)
    x = np.random.default_rng(3).standard_normal((3, 10, D)).astype(
        np.float32)

    def jloss(p):
        y, aux = jm(p, jnp.asarray(x))
        return (y ** 2).sum() + aux["aux_loss"], (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    y, aux = pm.eval()(torch.from_numpy(x))
    close(y, jy, 1e-5, 1e-5, what="y")
    close(aux["aux_loss"], jaux["aux_loss"], 1e-6, 1e-5, what="aux_loss")
    close(aux["expert_counts"], jaux["expert_counts"], what="counts")
    cap = pm.capacity(30)
    assert cap == max(1, int(capacity_factor * 30 * top_k / E))
    if capacity_factor < 1:     # some expert overflowed: tokens dropped
        assert int(aux["expert_counts"].max()) > cap
    ((y ** 2).sum() + aux["aux_loss"]).backward()
    grads_close(pm, jg)


def test_moe_router_noise_only_in_training_with_a_generator():
    pm = PM.MoEFeedForward(D, F, E, router_noise=1.0)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, D, generator=torch.Generator().manual_seed(1))
    quiet = pm.eval()(x, generator=torch.Generator().manual_seed(2))[0]
    torch.testing.assert_close(pm.train()(x)[0], quiet, rtol=0, atol=0)
    a = pm(x, generator=torch.Generator().manual_seed(2))[1]
    b = pm(x, generator=torch.Generator().manual_seed(2))[1]
    assert torch.equal(a["expert_counts"], b["expert_counts"])
    assert pm.param_sharding["w1"] == ("ep", None, "tp")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(kind, r):
    if kind == "uniform":
        lo = r.uniform(-1, 0, (3,)).astype(np.float32)
        hi = lo + r.uniform(0.5, 2, (3,)).astype(np.float32)
        return JD.Uniform(lo, hi), PD.Uniform(lo, hi, device="cpu")
    if kind == "normal":
        loc = r.standard_normal(3).astype(np.float32)
        sc = r.uniform(0.5, 2, 3).astype(np.float32)
        return JD.Normal(loc, sc), PD.Normal(loc, sc, device="cpu")
    if kind == "categorical":
        lg = r.standard_normal((2, 5)).astype(np.float32)
        lg[1, 2] = -np.inf                        # a masked action
        return JD.Categorical(lg), PD.Categorical(lg, device="cpu")
    loc = r.standard_normal(3).astype(np.float32)
    cov = np.diag(r.uniform(0.5, 2, 3)).astype(np.float32)
    cov[0, 1] = 7.0                               # ignored, as the reference
    return (JD.MultivariateNormalDiag(loc, cov),
            PD.MultivariateNormalDiag(loc, cov, device="cpu"))


KINDS = ["uniform", "normal", "categorical", "mvn"]


@pytest.mark.parametrize("kind", KINDS)
def test_densities_entropy_and_kl_equal_the_reference(kind):
    r = _rng(KINDS.index(kind))
    (jp, pp), (jq, pq) = _pair(kind, r), _pair(kind, r)
    if kind == "categorical":
        value = np.array([4, 3], np.int32)
        close(pp.probs, jp.probs)
    elif kind == "uniform":
        value = np.array([-0.5, 0.2, 5.0], np.float32)   # one outside
    else:
        value = r.standard_normal(3).astype(np.float32)
    close(pp.log_prob(value), jp.log_prob(jnp.asarray(value)))
    close(pp.prob(value), jp.prob(jnp.asarray(value)))
    close(pp.entropy(), jp.entropy())
    close(PD.kl_divergence(pp, pq), JD.kl_divergence(jp, jq))
    close(pp.kl_divergence(pp), jp.kl_divergence(jp), 1e-6, 1e-5)
    with pytest.raises(TypeError):
        pp.kl_divergence(object())


def test_categorical_gradients_stay_finite_at_masked_actions():
    lg = torch.tensor([[0.5, -np.inf, 1.0]], requires_grad=True)
    d = PD.Categorical(lg)
    (d.entropy().sum() + d.kl_divergence(PD.Categorical(
        torch.zeros(1, 3))).sum()).backward()
    assert torch.isfinite(lg.grad).all()
    jg = jax.grad(lambda l: JD.Categorical(l).entropy().sum()
                  + JD.Categorical(l).kl_divergence(
                      JD.Categorical(jnp.zeros((1, 3)))).sum())(
        jnp.asarray(lg.detach().numpy()))
    close(lg.grad, jg, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_samples_by_shape_moments_and_generator(kind):
    _, d = _pair(kind, _rng(5))

    def draw(seed, shape=(4000,)):
        return d.sample(shape, generator=torch.Generator().manual_seed(seed))

    a = draw(0)
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))
    if kind == "categorical":
        assert a.shape == (4000, 2)
        freq = torch.stack([(a[:, 0] == k).double().mean()
                            for k in range(5)])
        torch.testing.assert_close(freq, d.probs[0].double(), atol=0.03,
                                   rtol=0)
        assert not bool((a[:, 1] == 2).any())    # never the masked one
        return
    assert a.shape == (4000, 3)
    if kind == "uniform":
        assert bool(((a >= d.low) & (a < d.high)).all())
        mean = (d.low + d.high) / 2
    else:
        mean = d.loc
        std = d.scale if kind == "normal" else torch.sqrt(
            torch.diagonal(d.scale))
        torch.testing.assert_close(a.std(0), std, atol=0.1 * float(
            std.max()), rtol=0)
    torch.testing.assert_close(a.mean(0), mean, atol=0.1, rtol=0)


def test_parameters_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.Normal(0.0, 1.0)
    # tensors keep their device
    assert PD.Normal(torch.zeros(2), 1.0).scale.device.type == "cpu"
