"""The port's training path against the JAX package on the CPU:
``build_train_step`` steps of tiny BERT (per-step losses within 1e-5
relative, final parameters within 1e-4), gradient accumulation,
``Trainer.fit``, the bf16 policy, ``GPT.loss`` and dropout. Inputs are
made with numpy from seeds; weights start from the JAX initialisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu import train as jtrain
from paddle_tpu.core import dtypes as jdtypes
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.models import state_from_jax
from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import layers
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.train import (build_eval_step, build_train_step,
                                    make_train_state)
from paddle_tpu_torch.trainer import Trainer

from test_torch_bert import jax_bert, make_batch, torch_batch

torch.set_num_threads(2)

CFG = dict(dropout=0.0, attn_dropout=0.0)


def _port_bert(params, **kw):
    return BertForPretraining.from_jax(BertConfig.tiny(**CFG, **kw),
                                       jax.device_get(params), device="cpu")


def _bert_loss(m, **b):
    return m.loss(**b)


def _jax_steps(model, params, batches, grad_accum_steps=1):
    optimizer = jopt.AdamW(learning_rate=1e-3)
    state = {"params": params, "opt": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jtrain.build_train_step(
        lambda p, **b: model.loss(p, **b), optimizer,
        policy=jdtypes.get_policy("full"),
        grad_accum_steps=grad_accum_steps))
    losses = []
    for batch in batches:
        state, metrics = step(state, **{k: jnp.asarray(v)
                                        for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses, state_from_jax(jax.device_get(state["params"]))


def _port_steps(model, batches, grad_accum_steps=1):
    state = make_train_state(model, opt.AdamW(model.parameters(),
                                              learning_rate=1e-3))
    step = build_train_step(_bert_loss, state["opt"],
                            policy=dtypes.get_policy("full"),
                            grad_accum_steps=grad_accum_steps)
    losses = []
    for batch in batches:
        state, metrics = step(state, **torch_batch(batch))
        losses.append(float(metrics["loss"]))
    assert state["step"] == len(batches) == state["opt"].num_steps
    return losses


def _assert_params(model, want, steps):
    """Final parameters within 1e-4. One slice is held to less: the key
    third of each ``qkv_proj.bias`` has a zero gradient in exact
    arithmetic (a constant added to every score of a row cancels in the
    softmax), so both frameworks feed Adam rounding noise, which Adam
    normalises into steps of about the learning rate in either
    direction. There only the size of the drift is held: at most
    ``steps`` times the learning rate."""
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy().copy(), want[name].numpy().copy()
        if name.endswith("attn.qkv_proj.bias"):
            d = got.shape[0] // 3
            assert np.abs(got[d:2 * d] - ref[d:2 * d]).max() <= 2 * steps * 1e-3
            got[d:2 * d] = ref[d:2 * d]
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_three_train_steps_match_reference():
    jcfg, jmodel, params = jax_bert(seed=4)
    batches = [make_batch(jcfg, 2, 16, seed=10 + i) for i in range(3)]
    j_losses, j_params = _jax_steps(jmodel, params, batches)
    model = _port_bert(params)
    losses = _port_steps(model, batches)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _assert_params(model, j_params, steps=3)


def test_grad_accumulation_matches_reference():
    jcfg, jmodel, params = jax_bert(seed=5)
    batches = [make_batch(jcfg, 4, 16, seed=20)]
    j_losses, j_params = _jax_steps(jmodel, params, batches,
                                    grad_accum_steps=2)
    model = _port_bert(params)
    losses = _port_steps(model, batches, grad_accum_steps=2)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _assert_params(model, j_params, steps=1)


def test_grad_accumulation_of_a_mean_loss_equals_one_step():
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 12)))
    finals = []
    for n in (1, 2):
        model = GPT(GPTConfig.tiny(), device="cpu", seed=1)
        state = make_train_state(model, opt.SGD(model.parameters(), 0.5))
        step = build_train_step(lambda m, **b: m.loss(**b), state["opt"],
                                grad_accum_steps=n)
        state, metrics = step(state, ids=ids)
        finals.append((float(metrics["loss"]),
                       [p.detach().clone() for p in model.parameters()]))
    np.testing.assert_allclose(finals[0][0], finals[1][0], rtol=1e-6)
    for a, b in zip(finals[0][1], finals[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_trainable_mask_freezes_parameters():
    _, _, params = jax_bert(seed=6)
    model = _port_bert(params)
    frozen = "bert.embeddings.word.weight"
    before = model.state_dict()[frozen].clone()
    state = make_train_state(model, opt.AdamW(model.parameters(), 1e-2))
    step = build_train_step(_bert_loss, state["opt"],
                            trainable_mask={frozen: False})
    jcfg = BertConfig.tiny()
    step(state, **torch_batch(make_batch(jcfg, 2, 8, seed=1)))
    assert torch.equal(model.state_dict()[frozen], before)
    assert not torch.equal(model.bert.pooler.weight.detach(),
                           torch.from_numpy(np.array(
                               params["bert"]["pooler"]["weight"])))


def test_trainer_fit_lowers_the_loss_and_counts_steps():
    model = BertForPretraining(BertConfig.tiny(**CFG), device="cpu", seed=0)
    state = make_train_state(model, opt.AdamW(model.parameters(), 3e-3))
    step = build_train_step(_bert_loss, state["opt"])
    batch = torch_batch(make_batch(BertConfig.tiny(), 4, 16, seed=2))
    reg, logs, seen = MetricsRegistry(), [], []
    trainer = Trainer(step, state, log_every=2, log_fn=logs.append,
                      registry=reg,
                      hooks=[lambda t, n, m: seen.append(float(m["loss"]))])
    last = trainer.fit(iter([batch] * 100), steps_per_epoch=5)
    assert len(seen) == 5 and seen[-1] < seen[0]
    assert last["loss"] == pytest.approx(seen[-1])
    assert trainer.step_count == 5
    assert reg.counter("train_steps_total").value() == 5
    assert reg.counter("train_examples_total").value() == 20
    assert reg.counter("train_tokens_total").value() == 5 * 4 * 16
    assert reg.histogram("train_step_seconds").summary()["count"] == 5
    assert any("step 4" in line for line in logs)
    evals = trainer.evaluate(build_eval_step(_bert_loss), [batch])
    with torch.no_grad():
        want = float(_bert_loss(model, **batch)[0])
    assert float(evals[0][0]) == pytest.approx(want, rel=1e-6)
    preds = trainer.predict(
        build_eval_step(lambda m, **b: m(b["input_ids"])), [batch])
    assert preds[0][0].shape == (4, 16, 128)
    assert isinstance(preds[0][0], np.ndarray)


def test_bf16_policy_runs_on_cpu_near_fp32():
    _, _, params = jax_bert(seed=7)
    batch = torch_batch(make_batch(BertConfig.tiny(), 2, 16, seed=3,
                                   lengths=[16, 5]))
    firsts = {}
    for name in ("full", "bf16"):
        model = _port_bert(params)
        state = make_train_state(model, opt.AdamW(model.parameters(), 1e-3))
        step = build_train_step(_bert_loss, state["opt"],
                                policy=dtypes.get_policy(name))
        state, metrics = step(state, **batch)
        firsts[name] = float(metrics["loss"])
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in model.parameters())
    assert abs(firsts["bf16"] - firsts["full"]) < 2e-2
    assert firsts["bf16"] != firsts["full"]


def test_policy_casts_floating_tensors_only():
    pol = dtypes.get_policy("bf16")
    tree = {"x": torch.ones(2), "ids": torch.ones(2, dtype=torch.int64),
            "m": torch.ones(2, dtype=torch.bool), "n": [torch.ones(1)]}
    out = pol.cast_to_compute(tree)
    assert out["x"].dtype == torch.bfloat16
    assert out["n"][0].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64 and out["m"].dtype == torch.bool
    assert dtypes.get_policy("bf16_full").param_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        dtypes.get_policy("fp8")


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
def test_gpt_loss_matches_reference(dropout):
    jcfg = JaxGPTConfig.tiny(dropout=dropout, attn_impl="xla")
    jmodel = JaxGPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    ids = np.random.default_rng(4).integers(0, 128, (2, 17)).astype(np.int32)
    j_loss, j_aux = jmodel.loss(params, jnp.asarray(ids))
    model = GPT.from_jax(GPTConfig.tiny(dropout=dropout),
                         jax.device_get(params), device="cpu")
    assert not model.training      # eval: dropout is the identity
    loss, aux = model.loss(torch.from_numpy(ids))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ppl"]), float(j_aux["ppl"]),
                               rtol=1e-5)
    if dropout:
        model.train()
        gen = torch.Generator().manual_seed(0)
        loss_t, _ = model.loss(torch.from_numpy(ids), generator=gen)
        assert float(loss_t) != pytest.approx(float(loss), rel=1e-6)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200_000)
    drop = layers.Dropout(0.25)
    a = drop(x, torch.Generator().manual_seed(11))
    b = drop(x, torch.Generator().manual_seed(11))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    drop.eval()
    assert drop(x) is x
    assert layers.dropout(x, 0.0) is x
