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


@pytest.mark.parametrize("rows", [2, 64], ids=["masked", "segments"])
def test_embedding_gradient_is_the_plain_sum_in_a_fixed_order(rows):
    """The port's embedding backward (a small table: one masked float32
    reduction per row; a larger one: ids sorted stably, rows reduced in
    float32 segment by segment) gives F.embedding's gradient within fp32
    rounding, bf16 gradients for a bf16 table, and the same bits on every
    call, with ids that repeat many times (one id over half the batch, as
    BERT's token types) and ids never seen."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, rows - rows // 4, (6, 40)))
    ids[:3] = 1
    g = torch.from_numpy(rng.standard_normal((6, 40, 16)).astype(np.float32))
    w = torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal((rows, 16)).astype(np.float32)))
    grads = []
    for _ in range(2):
        w.grad = None
        layers.embedding(ids, w).backward(g)
        grads.append(w.grad.clone())
    assert torch.equal(grads[0], grads[1])
    w.grad = None
    torch.nn.functional.embedding(ids, w).backward(g)
    torch.testing.assert_close(grads[0], w.grad, atol=1e-5, rtol=1e-6)
    assert torch.all(grads[0][rows - rows // 4:] == 0)
    wb = torch.nn.Parameter(w.detach().to(torch.bfloat16))
    layers.embedding(ids, wb).backward(g.to(torch.bfloat16))
    assert wb.grad.dtype == torch.bfloat16
    torch.testing.assert_close(wb.grad.float(), grads[0], atol=0.1,
                               rtol=2e-2)


def test_evaluate_streams_metrics_as_the_reference():
    """``Trainer.evaluate(metrics=)``: the NSP head's accuracy and AUC over
    four batches of tiny BERT stream into ``metrics.Accuracy``/``Auc``
    in both packages from one weight tree, within 1e-6, with the eval
    telemetry the reference records."""
    from paddle_tpu import metrics as jmetrics
    from paddle_tpu import observability as jobs
    from paddle_tpu.trainer import Trainer as JaxTrainer
    from paddle_tpu_torch import metrics

    jcfg, jmodel, params = jax_bert(seed=9)
    batches = [make_batch(jcfg, 6, 12, seed=20 + i) for i in range(4)]

    def jax_eval(p, **b):
        return jmodel(p, b["input_ids"], b["token_type_ids"],
                      b["attention_mask"])

    def jax_extract(name):
        def extract(out, batch):
            nsp = np.asarray(out[1])
            if name == "acc":
                return nsp, np.asarray(batch["nsp_labels"])
            prob = np.exp(nsp[:, 1]) / np.exp(nsp).sum(-1)
            return prob, np.asarray(batch["nsp_labels"])
        return extract

    jreg = jobs.default()
    jsteps0 = jreg.counter("eval_steps_total").value()
    jex0 = jreg.counter("eval_examples_total").value()
    jtrainer = JaxTrainer(None, {"params": params}, log_fn=lambda s: None)
    want = jtrainer.evaluate(
        jax.jit(jax_eval), [{k: jnp.asarray(v) for k, v in b.items()}
                            for b in batches],
        metrics={"acc": (jmetrics.Accuracy(), jax_extract("acc")),
                 "auc": (jmetrics.Auc(num_thresholds=255),
                         jax_extract("auc"))})
    assert jreg.counter("eval_steps_total").value() - jsteps0 == 4
    assert jreg.counter("eval_examples_total").value() - jex0 == 24

    def port_extract(name):
        def extract(out, batch):
            nsp = out[1]
            if name == "acc":
                return nsp, batch["nsp_labels"]
            return torch.softmax(nsp, -1)[:, 1], batch["nsp_labels"]
        return extract

    model = _port_bert(params)
    state = make_train_state(model, opt.SGD(model.parameters(), 0.1))
    reg = MetricsRegistry()
    trainer = Trainer(None, state, registry=reg, log_fn=lambda s: None)
    got = trainer.evaluate(
        build_eval_step(lambda m, **b: m(b["input_ids"],
                                         b["token_type_ids"],
                                         b["attention_mask"])),
        [torch_batch(b) for b in batches],
        metrics={"acc": (metrics.Accuracy(), port_extract("acc")),
                 "auc": (metrics.Auc(num_thresholds=255),
                         port_extract("auc"))})
    assert set(got) == set(want) == {"acc", "auc"}
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-6, (k, got[k], want[k])
    assert 0.0 < got["auc"] < 1.0
    assert reg.counter("eval_steps_total").value() == 4
    assert reg.counter("eval_examples_total").value() == 24
    assert reg.histogram("eval_step_seconds").summary()["count"] == 4
    quiet = MetricsRegistry()
    outs = Trainer(None, state, registry=quiet, telemetry=False).evaluate(
        build_eval_step(lambda m, **b: m(b["input_ids"])),
        [torch_batch(batches[0])])
    assert len(outs) == 1 and quiet.metrics() == []


@pytest.mark.parametrize("name", ["full", "bf16", "bf16_full"])
def test_policy_casts_and_is_floating_equal_the_reference(name):
    pol, jpol = dtypes.get_policy(name), jdtypes.get_policy(name)
    tree = {"x": np.ones(2, np.float32), "h": np.ones(1, np.float16),
            "ids": np.ones(2, np.int32), "m": np.ones(2, bool)}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for cast in ("cast_to_compute", "cast_to_param", "cast_to_output"):
        want = getattr(jpol, cast)({k: jnp.asarray(v)
                                    for k, v in tree.items()})
        got = getattr(pol, cast)(ttree)
        for k in tree:
            assert str(got[k].dtype).replace("torch.", "") == \
                str(want[k].dtype), (cast, k)
    for dt in ("float32", "bfloat16", "float16", "float64", "int8", "int32",
               "int64", "bool", "uint8", "complex64", np.float32, np.int64):
        assert dtypes.is_floating(dt) == jdtypes.is_floating(dt), dt
    assert dtypes.is_floating(torch.bfloat16)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable",
                                    "everything_saveable"])
def test_remat_policy_steps_equal_the_plain_step(policy):
    """``recompute(layer.forward, policy=<saving policy>)`` on every
    encoder layer of tiny BERT: two AdamW steps (dropout on, so the
    recompute must draw the same masks) give the plain step's losses and
    parameters within 1e-6."""
    _, _, params = jax_bert(seed=11)
    batches = [torch_batch(make_batch(BertConfig.tiny(), 2, 16, seed=s))
               for s in (4, 5)]
    runs = {}
    for remat in (False, True):
        model = BertForPretraining.from_jax(
            BertConfig.tiny(dropout=0.1, attn_dropout=0.0),
            jax.device_get(params), device="cpu")
        if remat:
            for layer in model.bert.encoder:
                layer.forward = opt.recompute(
                    layer.forward,
                    policy=getattr(opt.checkpoint_policies, policy))
        state = make_train_state(model, opt.AdamW(model.parameters(), 1e-3))
        step = build_train_step(_bert_loss, state["opt"])
        torch.manual_seed(0)
        losses = [float(step(state, **b)[1]["loss"]) for b in batches]
        runs[remat] = (losses, [p.detach().clone()
                                for p in model.parameters()])
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    for a, b in zip(runs[True][1], runs[False][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_per_layer_recompute_under_the_bf16_policy(policy):
    """``recompute(layer.forward, policy=)`` on every encoder layer of
    tiny BERT inside a bf16-policy train step: the recompute reads the
    forward's compute-dtype casts (the step swaps them in only for the
    forward), so two steps give the plain step's losses and parameters
    bit for bit."""
    _, _, params = jax_bert(seed=12)
    batches = [torch_batch(make_batch(BertConfig.tiny(), 2, 16, seed=s))
               for s in (6, 7)]
    runs = {}
    for remat in (False, True):
        model = _port_bert(params)
        if remat:
            for layer in model.bert.encoder:
                layer.forward = opt.recompute(
                    layer.forward,
                    policy=getattr(opt.checkpoint_policies, policy))
        state = make_train_state(model, opt.AdamW(model.parameters(), 1e-3))
        step = build_train_step(_bert_loss, state["opt"],
                                policy=dtypes.get_policy("bf16"))
        losses = [float(step(state, **b)[1]["loss"]) for b in batches]
        runs[remat] = (losses, [p.detach().clone()
                                for p in model.parameters()])
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
