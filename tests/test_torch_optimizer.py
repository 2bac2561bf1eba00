"""The port's optimizers, schedules, clipping and regularizers against
the JAX package's ``update`` on the CPU: the same random parameter tree
and the same per-step random gradients (numpy, seeded) for 5 steps.
Tolerance fp32 atol/rtol 1e-6.

The reference increments its step before it reads the learning rate, and
AdamW decays with that new step's rate times the parameter from before
the step; a schedule that varies per step (warmup over polynomial decay)
catches an off-by-one in either."""

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
    assert to.num_steps == int(js["step"]) == STEPS
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   err_msg=k, **TOL)


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
