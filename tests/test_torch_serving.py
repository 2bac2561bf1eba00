"""The slice as a whole: the port's ServingEngine on the CPU must produce
greedy tokens IDENTICAL to ``paddle_tpu.serving.ServingEngine`` on the
same weights and prompts — mixed prompt lengths over several prefill
chunks, prefix sharing on and off (with a verbatim duplicate prompt
that forces a copy-on-write), early EOS, a prefill budget below one
chunk, and one case against the reference's Pallas kernels in interpret
mode. The reference engine is not warmed (that only saves compiles)."""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import scheduler as jax_scheduler
from paddle_tpu_torch.inference import make_serving_engine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.serving import LoadShedError, scheduler

torch.set_num_threads(2)

DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **DIMS))
    params = jmodel.init(jax.random.PRNGKey(3))
    model = GPT.from_jax(GPTConfig(**DIMS), jax.device_get(params),
                         device="cpu")
    return jmodel, params, model


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, n).astype(np.int32) for n in lens]


def _both(models, prompts, max_new, eos_id=None, attn_impl="lax", **kw):
    jmodel, params, model = models
    jeng = jax_serving.ServingEngine(jmodel, params, attn_impl=attn_impl,
                                     registry=jax_obs.MetricsRegistry(), **kw)
    ref = jeng.generate_many(prompts, max_new_tokens=max_new, eos_id=eos_id,
                             max_steps=500)
    reg = MetricsRegistry()
    eng = make_serving_engine(model, device="cpu", registry=reg, **kw)
    got = eng.generate_many(prompts, max_new_tokens=max_new, eos_id=eos_id,
                            max_steps=500)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0
    return eng, reg, got


def test_mixed_lengths_over_several_prefill_chunks(models):
    prompts = _prompts(3, [5, 9, 3, 21, 7, 30, 12])
    _both(models, prompts, 6, num_slots=3, page_size=4, prefill_chunk=8)


@pytest.mark.parametrize("share", [False, True], ids=["no_share", "share"])
def test_prefix_sharing_with_cow_duplicate(models, share):
    rng = np.random.default_rng(20)
    prefix = rng.integers(1, 64, 10).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 64, t).astype(np.int32)])
               for t in (3, 5, 2, 7)]
    prompts.append(prompts[1].copy())           # verbatim duplicate: CoW
    eng, reg, _ = _both(models, prompts, 5, num_slots=2, page_size=4,
                        prefill_chunk=8, prefix_sharing=share)
    computed = reg.counter("serving_prefill_tokens_total").value()
    submitted = reg.counter("serving_prompt_tokens_total").value()
    if share:
        assert computed < submitted
        assert eng.cache.cow_copies_total > 0
        assert reg.counter("serving_prefix_cow_total").value() > 0
    else:
        assert computed == submitted


def test_early_eos(models):
    prompts = _prompts(5, [6, 11])
    jmodel, params, _ = models
    full = jax_serving.ServingEngine(
        jmodel, params, num_slots=2, page_size=4, attn_impl="lax",
        registry=jax_obs.MetricsRegistry()).generate_many(
            prompts[:1], max_new_tokens=12)[0]
    eos = int(full[3])
    _, _, got = _both(models, prompts, 12, eos_id=eos, num_slots=2,
                      page_size=4)
    stop = int(np.argmax(full == eos)) + 1
    np.testing.assert_array_equal(got[0], full[:stop])
    assert len(got[0]) < 12


def test_prefill_budget_below_one_chunk(models):
    prompts = _prompts(13, [30, 29, 27, 25])
    eng, reg, _ = _both(models, prompts, 2, num_slots=4, page_size=4,
                        prefill_chunk=8, prefill_budget=2)
    assert reg.counter("serving_prefill_tokens_total").value() == sum(
        map(len, prompts))


def test_against_reference_pallas_interpret(models):
    _both(models, _prompts(4, [4, 10]), 5, attn_impl="pallas_interpret",
          num_slots=2, page_size=4, prefill_chunk=8)


def test_warmup_runs_every_bucket_and_leaves_state_untouched(models):
    _, _, model = models
    kw = dict(num_slots=3, page_size=4, prefill_chunk=8, device="cpu")
    prompts = _prompts(8, [5, 13, 2])
    cold = make_serving_engine(model, **kw).generate_many(prompts, 4)
    eng = make_serving_engine(model, **kw)
    eng.warmup()
    assert eng.warmed_signatures == set(eng.warmup_plan())
    assert ("decode", eng.cache.config.max_pages_per_slot) in \
        eng.warmed_signatures
    assert eng.cache.pages_in_use == 0
    for a, b in zip(eng.generate_many(prompts, 4), cold):
        np.testing.assert_array_equal(a, b)


def test_metrics_and_load_shedding(models):
    _, _, model = models
    reg = MetricsRegistry()
    eng = make_serving_engine(model, num_slots=1, page_size=4,
                              max_queue_depth=2, registry=reg, device="cpu")
    prompts = _prompts(9, [5, 6, 7])
    rids = [eng.submit(p, 3) for p in prompts[:2]]
    with pytest.raises(LoadShedError) as exc:
        eng.submit(prompts[2], 3)
    assert exc.value.reject.reason == "queue_full"
    assert reg.counter("serving_rejected_total").value(
        reason="queue_full") == 1
    while not eng.scheduler.idle():
        eng.step()
    assert all(eng.result(r).shape == (3,) for r in rids)
    assert eng.result(rids[0]) is None          # pop-on-read
    assert reg.histogram("serving_ttft_seconds").summary()["count"] == 2
    assert reg.counter("serving_tokens_total").value() == 6
    with pytest.raises(ValueError, match="per-slot limit"):
        eng.submit(np.ones(62, np.int32), 3)


def test_reject_vocabulary_is_the_reference_one():
    assert scheduler.REJECT_REASONS == jax_scheduler.REJECT_REASONS


def test_engine_refuses_a_model_on_another_device(models):
    _, _, model = models
    with pytest.raises(ValueError, match="attn_impl"):
        make_serving_engine(model, device="cpu", attn_impl="lax")
    meta = GPT(GPTConfig.tiny(), device="cpu").to("meta")
    with pytest.raises(ValueError, match="model lives on"):
        make_serving_engine(meta, device="cpu")


def test_histogram_quantiles_match_the_reference_registry():
    vals = np.random.default_rng(0).exponential(0.3, 200)
    ours = MetricsRegistry().histogram("t", buckets=(0.01, 0.1, 0.5, 1, 5))
    ref = jax_obs.MetricsRegistry().histogram("t",
                                              buckets=(0.01, 0.1, 0.5, 1, 5))
    for v in vals:
        ours.observe(v)
        ref.observe(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == pytest.approx(ref.quantile(q))
    assert ours.summary() == pytest.approx(ref.summary())
