"""Loss scaling and rematerialisation of the port against the JAX package
on the CPU.

``DynamicLossScale``: scale/unscale, the finite check and a seeded
sequence of finite and overflowing steps (grow, back off, clip) equal to
``paddle_tpu.amp``'s, exactly. ``scaled_train_step`` on a tiny BERT
(float32 policy, so both packages compute the same function): three
clean steps and a fourth forced to overflow by a scale of 2**127; losses
within 1e-5 relative, parameters within 1e-4 (the key third of the QKV
bias held to its drift bound, as in ``test_torch_train.py``); the
overflowing step leaves parameters, slots and both step counts unchanged
and backs the scale off (to 2**126, clipped to ``max_scale``), in both
packages. ``remat=True`` gives the same
losses and parameters as ``remat=False``, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import dtypes as jdtypes
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.models import state_from_jax
from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.train import build_train_step, make_train_state

from test_torch_bert import jax_bert, make_batch, torch_batch
from test_torch_train import _assert_params

torch.set_num_threads(2)

CFG = dict(dropout=0.0, attn_dropout=0.0)


def _loss(m, **b):
    return m.loss(**b)


def test_loss_scale_sequence_matches_reference():
    cfg = dict(init_scale=2.0 ** 4, growth_interval=3, max_scale=2.0 ** 6,
               min_scale=2.0)
    jls = jamp.DynamicLossScale(jamp.LossScaleConfig(**cfg))
    tls = amp.DynamicLossScale(amp.LossScaleConfig(**cfg))
    js, ts = jls.init(), tls.init(device="cpu")
    rng = np.random.default_rng(0)
    finite = rng.random(40) < 0.8
    for f in finite:
        js = jls.update(js, jnp.asarray(bool(f)))
        ts = tls.update(ts, torch.tensor(bool(f)))
        assert float(ts["scale"]) == float(js["scale"])
        assert int(ts["growth_counter"]) == int(js["growth_counter"])
        assert ts["scale"].dtype == torch.float32
        assert ts["growth_counter"].dtype == torch.int32
    g = [rng.standard_normal(5).astype(np.float32) for _ in range(2)]
    jg = jls.unscale([jnp.asarray(x) for x in g], js)
    tg = tls.unscale([torch.from_numpy(x) for x in g], ts)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    loss = np.float32(1.25)
    assert float(tls.scale(torch.tensor(loss), ts)) == \
        float(jls.scale(jnp.asarray(loss), js))
    bad = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert bool(tls.grads_finite(bad[:1])) and not bool(tls.grads_finite(bad))


def _jax_scaled(model, params, batches, overflow_at):
    optimizer = jopt.AdamW(1e-3)
    ls = jamp.DynamicLossScale()
    state = {"params": params, "opt": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32), "loss_scale": ls.init()}
    step = jax.jit(jamp.scaled_train_step(
        lambda p, **b: model.loss(p, **b), optimizer,
        policy=jdtypes.get_policy("full"), loss_scale=ls))
    out = []
    for i, batch in enumerate(batches):
        if i == overflow_at:
            state = dict(state, loss_scale=dict(
                state["loss_scale"], scale=jnp.asarray(2.0 ** 127,
                                                       jnp.float32)))
        state, m = step(state, **{k: jnp.asarray(v) for k, v in
                                  batch.items()})
        out.append((float(m["loss"]), bool(m["grads_finite"]),
                    float(m["loss_scale"]), int(state["step"]),
                    int(state["opt"]["step"])))
    return out, state


def test_scaled_train_step_matches_reference_with_a_forced_overflow():
    jcfg, jmodel, params = jax_bert(seed=8)
    batches = [make_batch(jcfg, 2, 16, seed=30 + i) for i in range(4)]
    j_out, j_state = _jax_scaled(jmodel, params, batches, overflow_at=3)

    model = BertForPretraining.from_jax(BertConfig.tiny(**CFG),
                                        jax.device_get(params), device="cpu")
    optimizer = opt.AdamW(model.parameters(), 1e-3)
    state = amp.make_amp_state(model, optimizer)
    step = amp.scaled_train_step(_loss, optimizer,
                                 policy=dtypes.get_policy("full"))
    out = []
    for i, batch in enumerate(batches):
        if i == 3:
            state["loss_scale"]["scale"].fill_(2.0 ** 127)
            before = [t.clone() for t in list(optimizer.params())
                      + optimizer.state_tensors()]
        state, m = step(state, **torch_batch(batch))
        out.append((float(m["loss"]), bool(m["grads_finite"]),
                    float(m["loss_scale"]), int(state["step"]),
                    optimizer.num_steps))
    for got, want in zip(out, j_out):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert got[1:] == want[1:]
    assert [o[1] for o in out] == [True, True, True, False]
    # backed off to 2**126, clipped to the default max_scale 2**24
    assert out[3][2] == 2.0 ** 24 and out[3][3] == out[3][4] == 3
    after = list(optimizer.params()) + optimizer.state_tensors()
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    _assert_params(model, state_from_jax(jax.device_get(
        j_state["params"])), steps=3)


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w).to(torch.bfloat16))


@pytest.mark.parametrize("rule", ["momentum", "adagrad"])
def test_a_skipped_step_restores_the_slots_the_reference_promotes(rule):
    """bf16 parameters under Momentum and Adagrad: the reference's
    promotion makes the parameter float32 at step 1 and its slot float32
    at step 2, which is forced to overflow (an infinite scale). The
    skipped step gives every parameter and slot back its value from
    before the step, in the promoted dtype (``where`` promotes), and
    steps 3-4 train on. The loss is ``sum(w * x)`` with ``x`` exact in
    bf16, so the gradient is ``x`` in both packages and the two agree bit
    for bit, dtypes included, after every step."""
    rng = np.random.default_rng(11)
    bf16 = lambda a: (a.astype(np.float32).view(np.uint32)
                      & 0xFFFF0000).view(np.float32)
    w0, x = bf16(rng.standard_normal((4, 3))), bf16(rng.standard_normal(
        (4, 3)))
    make_j, make_t = {
        "momentum": (lambda: jopt.Momentum(0.1),
                     lambda p: opt.Momentum(p, 0.1)),
        "adagrad": (lambda: jopt.Adagrad(0.1, initial_accumulator_value=0.5),
                    lambda p: opt.Adagrad(p, 0.1,
                                          initial_accumulator_value=0.5)),
    }[rule]
    slot = make_j().SLOTS[0]

    jo, jls = make_j(), jamp.DynamicLossScale()
    params = {"w": jnp.asarray(w0, jnp.bfloat16)}
    jstate = {"params": params, "opt": jo.init(params),
              "step": jnp.zeros((), jnp.int32), "loss_scale": jls.init()}
    jstep = jamp.scaled_train_step(
        lambda p, x: jnp.sum(p["w"] * x), jo,
        policy=jdtypes.get_policy("full"), loss_scale=jls)
    model = _Linear(w0)
    to = make_t(model.parameters())
    state = amp.make_amp_state(model, to)
    step = amp.scaled_train_step(lambda m, x: torch.sum(m.w * x), to,
                                 policy=dtypes.get_policy("full"))
    p = model.w
    for i in range(4):
        if i == 1:
            jstate["loss_scale"] = dict(jstate["loss_scale"],
                                        scale=jnp.asarray(np.inf, jnp.float32))
            state["loss_scale"]["scale"].fill_(float("inf"))
            before = (p.detach().clone(), to.state[p][slot].clone())
        jstate, jm = jstep(jstate, x=jnp.asarray(x))
        state, m = step(state, x=torch.from_numpy(x))
        assert bool(m["grads_finite"]) == bool(jm["grads_finite"]) == (i != 1)
        jw = np.asarray(jstate["params"]["w"].astype(jnp.float32))
        js = jstate["opt"]["slots"][slot]["w"]
        assert str(p.dtype).split(".")[1] == str(jstate["params"]["w"].dtype)
        assert str(to.state[p][slot].dtype).split(".")[1] == str(js.dtype)
        np.testing.assert_array_equal(p.detach().float().numpy(), jw)
        np.testing.assert_array_equal(
            to.state[p][slot].float().numpy(),
            np.asarray(js.astype(jnp.float32)))
        assert int(state["step"]) == int(jstate["step"]) == to.num_steps
        if i == 1:
            assert to.state[p][slot].dtype == torch.float32
            assert torch.equal(p.detach(), before[0].float())
            assert torch.equal(to.state[p][slot], before[1].float())
    assert int(state["step"]) == 3


@pytest.mark.parametrize("grad_accum_steps", [1, 2])
def test_remat_gives_the_same_losses_and_parameters(grad_accum_steps):
    batch = torch_batch(make_batch(BertConfig.tiny(), 4, 16, seed=5))
    runs = []
    for remat in (False, True):
        model = BertForPretraining(BertConfig.tiny(**CFG), device="cpu",
                                   seed=3)
        state = make_train_state(model, opt.AdamW(model.parameters(), 1e-3))
        step = build_train_step(_loss, state["opt"], remat=remat,
                                grad_accum_steps=grad_accum_steps,
                                policy=dtypes.get_policy("bf16"))
        losses = [float(step(state, **batch)[1]["loss"]) for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_remat_with_dropout_recomputes_the_same_masks():
    """Dropout under remat: the checkpoint restores the feeds' device's
    RNG state for the recompute, so the gradients are those of the masks
    the forward drew: one step from the same seed equals the step without
    remat."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)))
    finals = []
    for remat in (False, True):
        model = GPT(GPTConfig.tiny(dropout=0.2), device="cpu", seed=1)
        model.train()
        state = make_train_state(model, opt.SGD(model.parameters(), 0.5))
        step = build_train_step(lambda m, **b: m.loss(**b), state["opt"],
                                remat=remat)
        torch.manual_seed(7)
        state, m = step(state, ids=ids)
        finals.append((float(m["loss"]),
                       [p.detach().clone() for p in model.parameters()]))
    assert finals[0][0] == finals[1][0]
    for a, b in zip(finals[0][1], finals[1][1]):
        assert torch.equal(a, b)
