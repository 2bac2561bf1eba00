"""Exact speculative decoding in the port, held against the JAX package on
the CPU: a draft model proposes ``spec_k`` tokens per slot, the target
verifies them in one batched-prefill call, and the accept-prefix and
cursor rewind keep greedy output identical to non-speculative decoding.
Each port engine's tokens must equal the JAX speculative engine's AND the
port's own non-speculative engine's, under a perfect draft (every
proposal accepted), a weak draft (constant rollback), EOS inside an
accepted chunk and int8 pools; both caches end empty and consistent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.inference import make_serving_engine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.observability import MetricsRegistry

torch.set_num_threads(2)

DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)
# the reference test's weak draft: a smaller model sharing the vocabulary
DRAFT_DIMS = dict(vocab_size=64, hidden_size=8, num_layers=1, num_heads=2,
                  ffn_size=16, max_position=64)
KW = dict(num_slots=3, page_size=4, prefill_chunk=8)


def _pair(dims, seed):
    jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **dims))
    params = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, params, GPT.from_jax(GPTConfig(**dims),
                                        jax.device_get(params), device="cpu")


@pytest.fixture(scope="module")
def target():
    return _pair(DIMS, 0)


@pytest.fixture(scope="module")
def weak_draft():
    return _pair(DRAFT_DIMS, 9)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, n).astype(np.int32) for n in lens]


def _port(model, prompts, max_new, eos_id=None, **kw):
    reg = MetricsRegistry()
    eng = make_serving_engine(model, device="cpu", registry=reg, **KW, **kw)
    outs = eng.generate_many(prompts, max_new_tokens=max_new, eos_id=eos_id,
                             max_steps=500)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0
    if eng.speculative:
        eng.draft_cache.check_invariants()
        assert eng.draft_cache.pages_in_use == 0
    return outs, reg


def _held(target, prompts, max_new, draft=None, eos_id=None, spec_k=4,
          cache_dtype=None):
    """Port speculative == JAX speculative == port non-speculative."""
    jmodel, params, model = target
    jdraft, dparams, dmodel = draft or target
    jkw = {} if cache_dtype is None else dict(cache_dtype=jnp.int8)
    pkw = {} if cache_dtype is None else dict(cache_dtype=torch.int8)
    ref = jax_serving.ServingEngine(
        jmodel, params, attn_impl="lax", draft_model=jdraft,
        draft_params=dparams, spec_k=spec_k,
        registry=jax_obs.MetricsRegistry(), **KW, **jkw).generate_many(
            prompts, max_new_tokens=max_new, eos_id=eos_id, max_steps=500)
    base, _ = _port(model, prompts, max_new, eos_id, prefix_sharing=False,
                    **pkw)
    spec, reg = _port(model, prompts, max_new, eos_id, draft_model=dmodel,
                      spec_k=spec_k, **pkw)
    for i, (s, r, b) in enumerate(zip(spec, ref, base)):
        np.testing.assert_array_equal(s, r, err_msg=f"request {i} vs JAX")
        np.testing.assert_array_equal(s, b, err_msg=f"request {i} vs plain")
    return (reg.counter("serving_spec_proposed_total").value(),
            reg.counter("serving_spec_accepted_total").value(), reg)


def test_self_draft_accepts_every_proposal(target):
    prop, acc, reg = _held(target, _prompts(3, [5, 9, 3, 12, 7]), 7)
    assert prop > 0 and acc == prop
    assert reg.histogram("serving_spec_accept_rate").summary()["count"] > 0


def test_weak_draft_rolls_back(target, weak_draft):
    prop, acc, _ = _held(target, _prompts(5, [6, 11, 4]), 8,
                         draft=weak_draft)
    assert prop > 0 and acc < prop


def test_eos_inside_an_accepted_chunk(target):
    _, _, model = target
    prompt = _prompts(6, [6])[0]
    full, _ = _port(model, [prompt], 12)
    eos = int(full[0][3])
    stop = int(np.argmax(full[0] == eos)) + 1
    spec, _ = _port(model, [prompt], 12, eos_id=eos, draft_model=model)
    np.testing.assert_array_equal(spec[0], full[0][:stop])
    _held(target, [prompt], 12, eos_id=eos)


def test_int8_pools_with_speculation(target):
    prop, acc, _ = _held(target, _prompts(7, [9, 4, 6]), 5, spec_k=3,
                         cache_dtype=torch.int8)
    assert prop > 0 and acc == prop


def test_speculation_turns_prefix_sharing_off_and_shares_geometry(
        target, weak_draft):
    _, _, model = target
    _, _, dmodel = weak_draft
    eng = make_serving_engine(model, device="cpu", num_slots=2, page_size=4,
                              draft_model=dmodel,
                              draft_cache_dtype=torch.int8)
    assert not eng.cache.config.share_prefix
    assert not eng.draft_cache.config.share_prefix
    dc, tc = eng.draft_cache.config, eng.cache.config
    assert (dc.num_slots, dc.page_size, dc.num_pages,
            dc.max_pages_per_slot) == (tc.num_slots, tc.page_size,
                                       tc.num_pages, tc.max_pages_per_slot)
    assert dc.num_layers == 1 and dc.head_dim == 4 and dc.quantized
    assert not tc.quantized


def test_bad_configurations_raise(target):
    _, _, model = target
    with pytest.raises(ValueError, match="spec_k"):
        make_serving_engine(model, device="cpu", draft_model=model, spec_k=1)
    other = GPT(GPTConfig.tiny(vocab_size=32), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        make_serving_engine(model, device="cpu", draft_model=other)
    meta = GPT(GPTConfig.tiny(vocab_size=64), device="cpu").to("meta")
    with pytest.raises(ValueError, match="draft_model lives on"):
        make_serving_engine(model, device="cpu", draft_model=meta)


def test_warmup_plan_swaps_decode_for_draft_and_verify(target, weak_draft):
    _, _, model = target
    _, _, dmodel = weak_draft
    prompts = _prompts(12, [9, 4, 6, 13])
    cold, _ = _port(model, prompts, 5, draft_model=dmodel, spec_k=3)
    eng = make_serving_engine(model, device="cpu", draft_model=dmodel,
                              spec_k=3, max_tokens_per_slot=32, **KW)
    plan = eng.warmup_plan()
    kinds = {sig[0] for sig in plan}
    assert {"draft", "verify", "draft_prefill"} <= kinds
    assert "decode" not in kinds
    eng.warmup()
    assert eng.warmed_signatures == set(plan)
    assert eng.cache.pages_in_use == eng.draft_cache.pages_in_use == 0
    for a, b in zip(eng.generate_many(prompts, 5), cold):
        np.testing.assert_array_equal(a, b)
