"""The port's optimizers, schedules, clipping and regularizers against
the JAX package's ``update`` on the CPU: the same random parameter tree
and the same per-step random gradients (numpy, seeded) for 5 steps.
Tolerance fp32 atol/rtol 1e-6.

The reference increments its step before it reads the learning rate, and
AdamW decays with that new step's rate times the parameter from before
the step; a schedule that varies per step (warmup over polynomial decay)
catches an off-by-one in either."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import lr_scheduler as jsched
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.optimizer import lr_scheduler as sched

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"w": (4, 6), "b": (6,), "scale": (3, 2, 2)}
STEPS = 5


def _tree(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _warmup_poly(mod):
    return mod.linear_lr_warmup(
        mod.polynomial_decay(0.05, decay_steps=8, end_learning_rate=0.001),
        warmup_steps=2, start_lr=0.0, end_lr=0.05)


def _jax_step(js):
    return js["step"] if "step" in js else js["inner"]["step"]


def _run(make_jax, make_torch, seed=0):
    rng = np.random.default_rng(seed)
    params0 = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jo = make_jax()
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    js = jo.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params0.items()}
    to = make_torch(list(tp.values()))
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        to.step()
    assert to.num_steps == int(_jax_step(js)) == STEPS
    want = jo.view(jp, js) if hasattr(jo, "view") else jp
    got = to.view() if hasattr(to, "view") else list(tp.values())
    for k, t in zip(SHAPES, got):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


class _JaxAveraged:
    """SGD steps, then an averager (EMA, ModelAverage) over the params;
    the result is the averager's ``apply``."""

    def __init__(self, avg):
        self.sgd, self.avg = jopt.SGD(0.1), avg

    def init(self, p):
        return {"opt": self.sgd.init(p), "avg": self.avg.init(p),
                "step": jnp.zeros((), jnp.int32)}

    def update(self, g, s, p):
        p, o = self.sgd.update(g, s["opt"], p)
        return p, {"opt": o, "avg": self.avg.update(s["avg"], p),
                   "step": o["step"]}

    def view(self, p, s):
        return self.avg.apply(s["avg"])


class _TorchAveraged:
    def __init__(self, params, make_avg):
        self.sgd = opt.SGD(params, 0.1)
        self.avg = make_avg(params)

    @property
    def num_steps(self):
        return self.sgd.num_steps

    def step(self):
        self.sgd.step()
        self.avg.update()

    def view(self):
        return self.avg.apply()


class _JaxDGC:
    """DGC's sparsified gradients into SGD."""

    def __init__(self, **kw):
        self.dgc, self.inner = jopt.compression.DGC(**kw), jopt.SGD(0.1)

    def init(self, p):
        return {"dgc": self.dgc.init(p), "opt": self.inner.init(p),
                "step": jnp.zeros((), jnp.int32)}

    def update(self, g, s, p):
        g, d = self.dgc.transform(g, s["dgc"])
        p, o = self.inner.update(g, s["opt"], p)
        return p, {"dgc": d, "opt": o, "step": o["step"]}


class _TorchDGC:
    def __init__(self, params, **kw):
        self.params = params
        self.dgc, self.inner = opt.DGC(**kw), opt.SGD(params, 0.1)
        self.state = self.dgc.init(params)

    @property
    def num_steps(self):
        return self.inner.num_steps

    def step(self):
        outs, self.state = self.dgc.transform([p.grad for p in self.params],
                                              self.state)
        for p, g in zip(self.params, outs):
            p.grad = g
        self.inner.step()


CASES = {
    "sgd": (lambda: jopt.SGD(0.1), lambda p: opt.SGD(p, 0.1)),
    "momentum": (lambda: jopt.Momentum(0.1, momentum=0.9),
                 lambda p: opt.Momentum(p, 0.1, momentum=0.9)),
    "nesterov": (lambda: jopt.Momentum(0.05, use_nesterov=True),
                 lambda p: opt.Momentum(p, 0.05, use_nesterov=True)),
    "adam": (lambda: jopt.Adam(1e-2), lambda p: opt.Adam(p, 1e-2)),
    "adam_schedule": (lambda: jopt.Adam(_warmup_poly(jsched)),
                      lambda p: opt.Adam(p, _warmup_poly(sched))),
    "adamw": (lambda: jopt.AdamW(1e-2, weight_decay=0.1),
              lambda p: opt.AdamW(p, 1e-2, weight_decay=0.1)),
    "adamw_mask_schedule": (
        lambda: jopt.AdamW(_warmup_poly(jsched), weight_decay=0.2,
                           decay_mask_fn=lambda t: {k: v.ndim > 1
                                                    for k, v in t.items()}),
        lambda p: opt.AdamW(p, _warmup_poly(sched), weight_decay=0.2,
                            decay_mask_fn=lambda t: t.ndim > 1)),
    "clip_global_norm": (
        lambda: jopt.Adam(1e-2, grad_clip=jopt.GradientClipByGlobalNorm(0.5)),
        lambda p: opt.Adam(p, 1e-2,
                           grad_clip=opt.GradientClipByGlobalNorm(0.5))),
    "l2_decay": (
        lambda: jopt.Momentum(0.1, regularization=jopt.L2Decay(0.05)),
        lambda p: opt.Momentum(p, 0.1, regularization=opt.L2Decay(0.05))),
    "clip_by_norm_value": (
        lambda: jopt.SGD(0.1, grad_clip=jopt.GradientClipByNorm(1.0)),
        lambda p: opt.SGD(p, 0.1, grad_clip=opt.GradientClipByNorm(1.0))),
    "lars": (lambda: jopt.LarsMomentum(0.1, lars_weight_decay=0.01),
             lambda p: opt.LarsMomentum(p, 0.1, lars_weight_decay=0.01)),
    "adagrad": (lambda: jopt.Adagrad(0.1, initial_accumulator_value=0.1),
                lambda p: opt.Adagrad(p, 0.1, initial_accumulator_value=0.1)),
    "adamax": (lambda: jopt.Adamax(1e-2), lambda p: opt.Adamax(p, 1e-2)),
    "decayed_adagrad": (lambda: jopt.DecayedAdagrad(0.05),
                        lambda p: opt.DecayedAdagrad(p, 0.05)),
    "adadelta": (lambda: jopt.Adadelta(1.0, rho=0.9),
                 lambda p: opt.Adadelta(p, 1.0, rho=0.9)),
    "rmsprop": (lambda: jopt.RMSProp(1e-2), lambda p: opt.RMSProp(p, 1e-2)),
    "rmsprop_centered": (
        lambda: jopt.RMSProp(1e-2, momentum=0.5, centered=True),
        lambda p: opt.RMSProp(p, 1e-2, momentum=0.5, centered=True)),
    "ftrl": (lambda: jopt.Ftrl(0.1, l1=0.01, l2=0.01),
             lambda p: opt.Ftrl(p, 0.1, l1=0.01, l2=0.01)),
    "ftrl_lr_power": (lambda: jopt.Ftrl(0.1, l1=0.01, lr_power=-1.0),
                      lambda p: opt.Ftrl(p, 0.1, l1=0.01, lr_power=-1.0)),
    "lamb": (lambda: jopt.Lamb(1e-2, lamb_weight_decay=0.05),
             lambda p: opt.Lamb(p, 1e-2, lamb_weight_decay=0.05)),
    "dpsgd_sigma0": (
        lambda: jopt.Dpsgd(0.1, clip=0.5, sigma=0.0),
        lambda p: opt.Dpsgd(p, 0.1, clip=0.5, sigma=0.0)),
    "adam_lazy_named": (
        lambda: jopt.Adam(1e-2, lazy_mode=True, name="a"),
        lambda p: opt.Adam(p, 1e-2, lazy_mode=True, name="a")),
    "lookahead": (
        lambda: jopt.LookaheadOptimizer(jopt.Adam(1e-2), alpha=0.5, k=2),
        lambda p: opt.LookaheadOptimizer(opt.Adam(p, 1e-2), alpha=0.5, k=2)),
    "ema": (lambda: _JaxAveraged(jopt.ExponentialMovingAverage(0.9)),
            lambda p: _TorchAveraged(
                p, lambda q: opt.ExponentialMovingAverage(q, 0.9))),
    "model_average": (lambda: _JaxAveraged(jopt.ModelAverage()),
                      lambda p: _TorchAveraged(p, opt.ModelAverage)),
    "dgc": (lambda: _JaxDGC(sparsity=0.5),
            lambda p: _TorchDGC(p, sparsity=0.5)),
    "dgc_rampup": (lambda: _JaxDGC(momentum=0.8, sparsity=0.9,
                                   rampup_steps=3),
                   lambda p: _TorchDGC(p, momentum=0.8, sparsity=0.9,
                                       rampup_steps=3)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_optimizer_matches_reference_update(case):
    make_jax, make_torch = CASES[case]
    _run(make_jax, make_torch)


SCHEDULES = {
    "noam": lambda m: m.noam_decay(64, 4),
    "exponential": lambda m: m.exponential_decay(0.1, 3, 0.5),
    "exponential_stair": lambda m: m.exponential_decay(0.1, 3, 0.5, True),
    "natural_exp": lambda m: m.natural_exp_decay(0.1, 3, 0.5),
    "inverse_time": lambda m: m.inverse_time_decay(0.1, 3, 0.5, True),
    "polynomial": lambda m: m.polynomial_decay(0.1, 6, 0.01, power=2.0),
    "polynomial_cycle": lambda m: m.polynomial_decay(0.1, 4, cycle=True),
    "piecewise": lambda m: m.piecewise_decay([2, 5], [0.1, 0.05, 0.01]),
    "cosine": lambda m: m.cosine_decay(0.1, 2, 5),
    "cosine_steps": lambda m: m.cosine_decay_steps(0.1, 7, 0.001),
    "warmup_poly": _warmup_poly,
}


@pytest.mark.parametrize("name", list(SCHEDULES), ids=list(SCHEDULES))
def test_schedule_matches_reference(name):
    ours, ref = SCHEDULES[name](sched), SCHEDULES[name](jsched)
    for step in range(0, 12):
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-9, err_msg=str(step))


def test_clip_and_regularizers_leave_inputs_alone():
    g = [torch.full((3,), 4.0), torch.full((2, 2), -3.0)]
    p = [torch.ones(3), torch.ones(2, 2)]
    clipped = opt.GradientClipByGlobalNorm(1.0)(g)
    np.testing.assert_allclose(float(opt.global_norm(clipped)), 1.0,
                               rtol=1e-6)
    assert torch.all(g[0] == 4.0)
    assert torch.all(opt.GradientClipByValue(2.0)(g)[1] == -2.0)
    assert torch.all(opt.L1Decay(0.5)(g, p)[0] == 4.5)
    assert torch.all(opt.L2Decay(0.5)(g, p)[1] == -2.5)


def test_frozen_parameters_are_untouched_by_adamw():
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(3))
    o = opt.AdamW([a, b], 0.1, weight_decay=0.5)
    a.grad = torch.ones(3)
    o.step()
    assert torch.all(b == 1.0) and not torch.all(a == 1.0)


# -- bf16 parameters: slot and parameter dtypes as the reference's ------------

BF16_STEPS = 50


def _bf16_run(make_jax, make_torch, mask=None, seed=0):
    """``BF16_STEPS`` random steps on bf16 parameters (gradients rounded
    to bf16, handed to both packages in the parameter's current dtype, as
    gradients arrive). Returns the JAX (params, slots) and the port's
    (params, optimizer)."""
    rng = np.random.default_rng(seed)
    p0 = {"w": rng.standard_normal((16, 16)).astype(np.float32),
          "b": rng.standard_normal(256).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(BF16_STEPS)]
    jo = make_jax()
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    js = jo.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v).to(torch.bfloat16))
          for k, v in p0.items()}
    to = make_torch(list(tp.values()))
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v, jnp.bfloat16).astype(
            jp[k].dtype) for k, v in g.items()}, js, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]).to(torch.bfloat16).to(p.dtype)
        to.step()
    return jp, js, tp, to


def _as_f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_f6_bf16_params_keep_fp32_slots_bitwise(name):
    """F6: Adam and Lamb compute m and v from float32 gradients, so their
    slots are float32 for bf16 parameters; 50 steps leave slots and
    parameters bit-identical to the reference's."""
    makers = {"adam": (lambda: jopt.Adam(1e-2), lambda p: opt.Adam(p, 1e-2)),
              "lamb": (lambda: jopt.Lamb(1e-2), lambda p: opt.Lamb(p, 1e-2))}
    jp, js, tp, to = _bf16_run(*makers[name])
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16 and jp[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      _as_f32(jp[k]), err_msg=k)
        for s in ("m", "v"):
            slot = to.state[p][s]
            assert slot.dtype == torch.float32
            assert js["slots"][s][k].dtype == jnp.float32
            np.testing.assert_array_equal(slot.numpy(),
                                          np.asarray(js["slots"][s][k]))


def test_f7_adamw_promotes_decayed_bf16_params_to_fp32():
    """F7, the choice: as in the reference, AdamW's decay ``lr * wd * p``
    is float32 (``lr`` is a float32 array), so a decayed bf16 parameter
    becomes float32 at its first step, in place (the same Parameter
    object and state entry); a parameter the mask spares stays bf16.
    Slots are bitwise the reference's. Parameters: dtypes equal, values
    within 1e-6 relative: PyTorch's CPU sqrt is not IEEE-exact (it differs
    from numpy's in the last bit for ~0.7% of inputs; the card's is
    exact), and float32 parameters show that bit where bf16 ones round it
    away (test_f6_bf16_params_keep_fp32_slots_bitwise)."""
    def mask_j(t):
        return {k: k == "w" for k in t}

    jp, js, tp, to = _bf16_run(
        lambda: jopt.AdamW(1e-2, weight_decay=0.01, decay_mask_fn=mask_j),
        lambda p: opt.AdamW(p, 1e-2, weight_decay=0.01,
                            decay_mask_fn=lambda q: q.ndim > 1))
    assert tp["w"].dtype == torch.float32 and jp["w"].dtype == jnp.float32
    assert tp["b"].dtype == torch.bfloat16 and jp["b"].dtype == jnp.bfloat16
    assert to.state[tp["w"]]["m"].dtype == torch.float32
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   _as_f32(jp[k]), rtol=1e-6, atol=0,
                                   err_msg=k)
        for s in ("m", "v"):
            np.testing.assert_array_equal(to.state[p][s].numpy(),
                                          np.asarray(js["slots"][s][k]))


def test_f7_promotion_keeps_the_parameter_object_and_state():
    p = torch.nn.Parameter(torch.ones(4, 4, dtype=torch.bfloat16))
    o = opt.AdamW([p], 0.1, weight_decay=0.5)
    slots = o.state[p]
    p.grad = torch.ones(4, 4, dtype=torch.bfloat16)
    o.step()
    assert p.dtype == torch.float32 and o.state[p] is slots
    assert o.params()[0] is p


def test_sgd_and_momentum_promote_bf16_like_the_reference():
    """SGD's and Momentum's ``p - lr * upd`` is float32 in the reference
    (``lr`` is a float32 array): the bf16 parameter becomes float32 at its
    first step, and Momentum's velocity, bf16 for the first step, float32
    from the second. SGD's values match within 1e-6. Momentum's are held
    to their dtypes only: the reference rounds the Python constant
    ``momentum`` to bf16 before it scales the bf16 velocity (a weak-typed
    scalar takes the array's dtype), PyTorch applies it in float32, so the
    second step differs by that rounding."""
    for name, make_j, make_t in [
            ("sgd", lambda: jopt.SGD(0.1), lambda p: opt.SGD(p, 0.1)),
            ("momentum", lambda: jopt.Momentum(0.1),
             lambda p: opt.Momentum(p, 0.1))]:
        jp, js, tp, to = _bf16_run(make_j, make_t)
        for k, p in tp.items():
            assert p.dtype == torch.float32 and jp[k].dtype == jnp.float32
            if name == "sgd":
                np.testing.assert_allclose(p.detach().numpy(),
                                           _as_f32(jp[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=k)
            for s, slot in to.state[p].items():
                assert slot.dtype == torch.float32
                assert js["slots"][s][k].dtype == jnp.float32


# -- the multi-tensor path against the plain rule -----------------------------

MULTI = {
    "sgd": lambda p, **kw: opt.SGD(p, 0.1, **kw),
    "momentum": lambda p, **kw: opt.Momentum(p, 0.1, **kw),
    "nesterov": lambda p, **kw: opt.Momentum(p, 0.05, use_nesterov=True,
                                             **kw),
    "adam_schedule": lambda p, **kw: opt.Adam(p, _warmup_poly(sched), **kw),
    "adamw_mask": lambda p, **kw: opt.AdamW(
        p, 1e-2, weight_decay=0.1, decay_mask_fn=lambda t: t.ndim > 1, **kw),
}


@pytest.mark.parametrize("name", list(MULTI), ids=list(MULTI))
def test_multi_tensor_rule_equals_the_plain_rule_bitwise(name):
    """``foreach=True`` (one ``torch._foreach_*`` chain over the float32
    parameters) against ``foreach=False`` (the per-parameter rule), with a
    frozen parameter and a bf16 one (which takes the plain rule in both):
    8 steps, every parameter and slot bit-identical."""
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (3,), (2, 2, 2), (7,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    runs = []
    for foreach in (False, True):
        ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
        ps[3].data = ps[3].data.to(torch.bfloat16)
        o = MULTI[name](ps, foreach=foreach)
        for i in range(8):
            g = np.random.default_rng(100 + i)
            for j, p in enumerate(ps):
                p.grad = None if j == 2 else torch.from_numpy(
                    g.standard_normal(shapes[j]).astype(np.float32)).to(
                        p.dtype)
            o.step()
        runs.append((ps, o))
    (pa, oa), (pb, ob) = runs
    assert ob.num_steps == oa.num_steps == 8
    for a, b in zip(pa, pb):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
        for s in oa.SLOTS:
            assert torch.equal(oa.state[a][s], ob.state[b][s])
    assert torch.equal(pa[2], torch.from_numpy(p0[2]))


def test_step_count_and_lr_live_on_the_parameters_device():
    p = torch.nn.Parameter(torch.ones(3))
    o = opt.Adam([p], _warmup_poly(sched))
    assert o.state_step.dtype == torch.int32 and o.state_step.ndim == 0
    lr = o.lr_at(torch.tensor(3, dtype=torch.int32))
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
    np.testing.assert_allclose(float(lr), _warmup_poly(jsched)(jnp.int32(3)),
                               rtol=1e-6)
    p.grad = torch.ones(3)
    o.step()
    assert o.num_steps == 1 and int(o.state_step) == 1


@pytest.mark.parametrize("name", list(SCHEDULES), ids=list(SCHEDULES))
def test_schedule_on_a_device_step_tensor(name):
    """A 0-d int32 step tensor (the optimizer's) gives a float32 0-d
    tensor, equal to the Python-number path's value."""
    ours, ref = SCHEDULES[name](sched), SCHEDULES[name](jsched)
    for step in range(0, 12):
        got = ours(torch.tensor(step, dtype=torch.int32))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert float(got) == ours(step)
        np.testing.assert_allclose(float(got), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-9, err_msg=str(step))


def test_dpsgd_noise_repeats_per_seed_and_has_its_std():
    """sigma > 0: the same seed gives the same trajectory; another seed
    another one; the noise of one step has std sigma * clip / batch."""
    def run(seed):
        p = torch.nn.Parameter(torch.zeros(200_000))
        o = opt.Dpsgd([p], 1.0, clip=1.0, batch_size=4, sigma=2.0, seed=seed)
        p.grad = torch.zeros(200_000)
        o.step()
        return p.detach().clone()
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.std()) == pytest.approx(2.0 * 1.0 / 4, rel=0.02)


def test_aliases_name_the_same_classes():
    for alias in ("SGD", "Momentum", "Adagrad", "Adam", "Adamax",
                  "Adadelta", "RMSProp", "Ftrl", "Lamb", "DecayedAdagrad",
                  "LarsMomentum"):
        assert getattr(opt, alias + "Optimizer") is getattr(opt, alias)
        assert hasattr(jopt, alias + "Optimizer")


def test_recompute_matches_the_plain_function():
    lin = torch.nn.Linear(4, 4)
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    f = lambda t: torch.tanh(lin(t)).sum()   # noqa: E731
    f(x).backward()
    want = lin.weight.grad.clone()
    lin.weight.grad = None
    opt.recompute(f)(x).backward()
    assert torch.equal(lin.weight.grad, want)


# -- remat saving policies (``recompute(fn, policy=)``) ----------------------

POLICIES = ["nothing_saveable", "dots_with_no_batch_dims_saveable",
            "dots_saveable", "everything_saveable"]


def _remat_inputs(block, seed=0):
    r = np.random.default_rng(seed)
    if block == "mlp":
        shapes = {"w1": (8, 16), "b1": (16,), "w2": (16, 4), "b2": (4,)}
    else:
        shapes = {"wq": (8, 8), "wk": (8, 8), "wv": (8, 8), "wo": (8, 8)}
    p = {k: (r.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    x = r.standard_normal((2, 5, 8)).astype(np.float32)
    return p, x


def _block(block, lib):
    """The block written once over ``lib`` (jnp or torch)."""
    softmax = (lambda s: torch.softmax(s, -1)) if lib is torch else \
        (lambda s: jax.nn.softmax(s, -1))

    def mlp(p, x):
        h = lib.tanh(x @ p["w1"] + p["b1"])
        return lib.sum(lib.tanh(h @ p["w2"] + p["b2"]) ** 2)

    def attn(p, x):
        b, s, d = x.shape
        q, k, v = ((x @ p[n]).reshape(b, s, 2, d // 2)
                   for n in ("wq", "wk", "wv"))
        a = softmax(lib.einsum("bqhd,bkhd->bhqk", q, k) / 2.0)
        o = lib.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, s, d)
        return lib.sum(lib.tanh(o @ p["wo"]) ** 2)

    return mlp if block == "mlp" else attn


class _Recorder:
    """A policy that defers to the port's and records, in the forward,
    the outputs of the ops it keeps."""

    def __init__(self, policy):
        self.policy, self.saved = policy, []

    def __call__(self, ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy
        out = self.policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE:
            outs = ctx.op_output
            for t in (outs if isinstance(outs, (tuple, list)) else [outs]):
                if isinstance(t, torch.Tensor):
                    self.saved.append((str(op), tuple(t.shape), t.nbytes))
        return out


def _autograd_kept(fn, pn, xn):
    """``fn``'s gradients without a checkpoint, and the tensors autograd
    keeps for its backward beyond the inputs, one entry per storage"""
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pn.items()}
    x = torch.from_numpy(xn)
    inputs = {t.untyped_storage().data_ptr() for t in (x, *tp.values())}
    kept = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in inputs:
            kept[ptr] = ("autograd", tuple(t.shape),
                         t.untyped_storage().nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(tp, x)
    out.backward()
    return {k: v.grad for k, v in tp.items()}, list(kept.values())


def _fold(shape):
    """a matrix product's output as (rows, cols): torch reaches ``mm``
    with the leading dims of ``(B, S, D) @ (D, F)`` folded into rows, and
    ``bmm`` with the batch dims folded into one"""
    return (int(np.prod(shape[:-1])), shape[-1])


@pytest.mark.parametrize("block", ["mlp", "attention"])
def test_remat_policies_keep_the_gradients_and_order_the_saved_bytes(block):
    from jax._src.ad_checkpoint import saved_residuals
    pn, xn = _remat_inputs(block)
    jf, tf = _block(block, jnp), _block(block, torch)
    jp = {k: jnp.asarray(v) for k, v in pn.items()}

    def port_grads(fn):
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pn.items()}
        fn(tp, torch.from_numpy(xn)).backward()
        return {k: v.grad for k, v in tp.items()}

    plain = port_grads(tf)
    saved = {}
    for name in POLICIES:
        policy = getattr(opt.checkpoint_policies, name)
        assert repr(policy) == f"checkpoint_policies.{name}"
        if name == "everything_saveable":
            # runs ``fn`` as it is: what it keeps is what autograd keeps
            assert opt.recompute(tf, policy=policy) is tf
            got, kept = _autograd_kept(tf, pn, xn)
            rec = types.SimpleNamespace(saved=kept)
        else:
            rec = _Recorder(policy)
            got = port_grads(opt.recompute(tf, policy=rec))
        jpol = getattr(jax.checkpoint_policies, name)
        want = jax.grad(jopt.recompute(jf, policy=jpol))(jp, jnp.asarray(xn))
        for k in pn:
            np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {k} vs no remat")
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {k} vs reference")
        saved[name] = rec.saved
        if name.startswith("dots"):
            # the matrix products kept, against the reference's residuals
            # (its inputs aside): the same products, one for one by size;
            # as shapes, folded as torch reaches mm (the MLP), while an
            # einsum's bmm may order its free dims otherwise than JAX's
            # dot_general (the attention's second einsum)
            res = [tuple(a.shape) for a, src in saved_residuals(
                jopt.recompute(jf, policy=jpol), jp, jnp.asarray(xn))
                if "from the argument" not in src]
            assert sorted(int(np.prod(s)) for _, s, _ in rec.saved) == \
                sorted(int(np.prod(s)) for s in res), name
            if block == "mlp":
                assert sorted(_fold(s) for _, s, _ in rec.saved) == \
                    sorted(_fold(s) for s in res), name
            assert all(op.split(".")[1] in ("mm", "addmm", "bmm")
                       for op, _, _ in rec.saved)
    nbytes = {n: sum(b for _, _, b in s) for n, s in saved.items()}
    assert nbytes["nothing_saveable"] == 0
    assert 0 < nbytes["dots_with_no_batch_dims_saveable"] <= \
        nbytes["dots_saveable"] <= nbytes["everything_saveable"]
    if block == "attention":    # the two score einsums carry batch dims
        assert nbytes["dots_with_no_batch_dims_saveable"] < \
            nbytes["dots_saveable"]
    # no policy: plain recompute, the same gradients
    for k, g in port_grads(opt.recompute(tf)).items():
        assert torch.equal(g, plain[k])


def test_dots_policy_recomputes_the_flash_op_and_everything_keeps_it(
        monkeypatch):
    """``ptt::flash_fwd`` is no dot (a ``pallas_call`` is none in JAX):
    ``dots_saveable`` runs it again in the backward, ``everything``
    keeps its output."""
    from paddle_tpu_torch.ops import attention as A
    calls = []
    real = A.flash_fwd_plain
    monkeypatch.setattr(A, "flash_fwd_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2, 8, 16)).astype(
        np.float32)).requires_grad_() for _ in range(3))

    def f(q, k, v):
        return (A.flash_attention(q, k, v) ** 2).sum()

    runs = {}
    for name in ("nothing_saveable", "dots_saveable", "everything_saveable"):
        calls.clear()
        opt.recompute(f, policy=getattr(opt.checkpoint_policies, name))(
            q, k, v).backward()
        runs[name] = len(calls)
    assert runs == {"nothing_saveable": 2, "dots_saveable": 2,
                    "everything_saveable": 1}


def test_recompute_refuses_what_is_no_policy():
    with pytest.raises(TypeError, match="checkpoint_policies"):
        opt.recompute(lambda t: t, policy="dots_saveable")
