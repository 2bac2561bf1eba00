"""Cached dense decoding of the port's GPT held against the JAX package on
the same numpy weights (``GPT.from_jax``): prefill and decode-step
logits, greedy ``generate`` with and without the cache, the pow2-bucketed
``generate_bucketed`` (tokens, builds per bucket, the overflow guard),
sampling under one ``torch.Generator`` seed, and the initializers' fans
and moments against the reference's."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.observability import capture_count

torch.set_num_threads(2)

DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=32)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **DIMS))
    params = jmodel.init(jax.random.PRNGKey(0))
    port = GPT.from_jax(GPTConfig(**DIMS), jax.device_get(params),
                        device="cpu")
    return jmodel, params, port


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def test_prefill_and_decode_step_logits_match_the_reference(models):
    jmodel, params, port = models
    ids = _ids(1, (2, 9))
    jcache = jmodel.init_cache(2, 16)
    jpf, jcache = jmodel.prefill(params, jnp.asarray(ids[:, :8]), jcache)
    jstep, _ = jmodel.decode_step(params, jnp.asarray(ids[:, 8]),
                                  jnp.asarray(8), jcache)
    cache = port.init_cache(2, 16)
    pf, cache = port.prefill(torch.from_numpy(ids[:, :8]), cache)
    step, cache = port.decode_step(torch.from_numpy(ids[:, 8]),
                                   torch.tensor(8), cache)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jpf), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=1e-5,
                               rtol=1e-5)
    # the step's k/v landed in place at position 8, and the full forward
    # over all 9 tokens gives the step's logits
    with torch.no_grad():
        full = port(torch.from_numpy(ids).long())[:, 8]
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert cache[0][0][:, :, 9:].abs().sum() == 0


@pytest.mark.parametrize("use_cache", [False, True],
                         ids=["uncached", "cached"])
def test_greedy_generate_equals_the_reference(models, use_cache):
    jmodel, params, port = models
    prompt = _ids(3, (2, 5))
    want = np.asarray(jmodel.generate(params, jnp.asarray(prompt),
                                      max_new_tokens=10))
    got = port.generate(torch.from_numpy(prompt), max_new_tokens=10,
                        use_cache=use_cache)
    assert got.dtype == torch.int32 and got.shape == (2, 15)
    np.testing.assert_array_equal(got.numpy(), want)


def test_one_new_token(models):
    jmodel, params, port = models
    prompt = np.zeros((1, 3), np.int32)
    want = np.asarray(jmodel.generate(params, jnp.asarray(prompt),
                                      max_new_tokens=1, use_cache=True))
    for use_cache in (False, True):
        got = port.generate(torch.from_numpy(prompt), max_new_tokens=1,
                            use_cache=use_cache)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s0", [5, 9, 16])
def test_bucketed_generate_equals_cached_generate(models, s0):
    jmodel, params, port = models
    prompt = np.random.default_rng(0).integers(1, 64, (2, s0)).astype(
        np.int32)
    got = port.generate_bucketed(prompt, max_new_tokens=6)
    want = port.generate(torch.from_numpy(prompt), max_new_tokens=6,
                         use_cache=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = np.asarray(jmodel.generate_bucketed(params, prompt,
                                              max_new_tokens=6))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_second_length_in_a_bucket_builds_nothing(models):
    _, _, port = models
    rng = np.random.default_rng(1)
    before = capture_count()
    port.generate_bucketed(rng.integers(1, 64, (2, 9)).astype(np.int32),
                           max_new_tokens=6)           # the (16, 8) bucket
    built = capture_count() - before
    assert built <= 1
    for s0 in (10, 12, 14):
        mark = capture_count()
        port.generate_bucketed(rng.integers(1, 64, (2, s0)).astype(np.int32),
                               max_new_tokens=6)
        assert capture_count() == mark, f"built at prompt length {s0}"
    # another batch size is another bucket, built once
    mark = capture_count()
    port.generate_bucketed(rng.integers(1, 64, (3, 9)).astype(np.int32), 6)
    port.generate_bucketed(rng.integers(1, 64, (3, 11)).astype(np.int32), 6)
    assert capture_count() == mark + 1


def test_bucketed_overflow_guard(models):
    _, _, port = models                        # max_position = 32
    with pytest.raises(ValueError):
        port.generate_bucketed(np.zeros((1, 30), np.int32), max_new_tokens=8)


def test_bucketed_horizon_past_max_position_keeps_tokens(models):
    # 20 + 9 <= 32, but the 16-token horizon bucket decodes positions up
    # to 34: the position embedding clamps, the kept tokens are exact
    _, _, port = models
    prompt = _ids(4, (1, 20))
    got = port.generate_bucketed(prompt, max_new_tokens=9)
    want = port.generate(torch.from_numpy(prompt), max_new_tokens=9,
                         use_cache=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sampling_consumes_the_generator_alike_cached_and_uncached(models):
    _, _, port = models
    prompt = torch.from_numpy(_ids(4, (2, 4)))
    outs = []
    for use_cache in (False, True):
        gen = torch.Generator().manual_seed(7)
        outs.append(port.generate(prompt, max_new_tokens=8, temperature=0.8,
                                  generator=gen, use_cache=use_cache))
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    greedy = port.generate(prompt, max_new_tokens=8, use_cache=True)
    assert not torch.equal(outs[0], greedy)


def test_cache_dtype_defaults_to_the_weights():
    port = GPT(GPTConfig(**DIMS), device="cpu", dtype=torch.bfloat16, seed=2)
    cache = port.init_cache(1, 8)
    assert cache[0][0].dtype == torch.bfloat16
    assert port.init_cache(1, 8, dtype=torch.float32)[0][0].dtype == \
        torch.float32
    out = port.generate(torch.zeros((1, 3), dtype=torch.int32), 4,
                        use_cache=True, cache_dtype=torch.float32)
    assert out.shape == (1, 7)


SHAPES = [(7,), (12, 20), (3, 3, 4, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_initializer_fans_equal_the_reference(shape):
    assert I._fans(shape) == JI._fans(shape)
    assert I._fans(shape, 3, 5) == JI._fans(shape, 3, 5) == (3, 5)
    assert I._fans(()) == JI._fans(()) == (1, 1)


INITS = [("constant", (0.5,)), ("uniform", (-0.3, 0.7)),
         ("normal", (0.1, 0.5)), ("truncated_normal", (0.2, 0.5)),
         ("xavier_uniform", ()), ("xavier_normal", ()),
         ("msra_uniform", ()), ("msra_normal", ())]
BOUNDED = {"constant", "uniform", "truncated_normal", "xavier_uniform",
           "msra_uniform"}


@pytest.mark.parametrize("name,args", INITS, ids=[n for n, _ in INITS])
def test_initializer_moments_equal_the_reference(name, args):
    shape = (3, 3, 32, 64)           # 18,432 draws; fans 288 and 576
    want = np.asarray(getattr(JI, name)(*args)(jax.random.PRNGKey(0),
                                               shape), np.float64)
    gen = torch.Generator().manual_seed(0)
    t = getattr(I, name)(*args)(torch.empty(shape), gen)
    got = t.double().numpy()
    assert got.shape == want.shape
    std = want.std()
    # moments of 18,432 draws: mean within 4 standard errors, std within 4%
    tol = 4 * std / math.sqrt(want.size) + 1e-12
    assert abs(got.mean() - want.mean()) <= 2 * tol
    np.testing.assert_allclose(got.std(), std, rtol=0.04, atol=1e-12)
    if name in BOUNDED:
        # the same support: extremes within 2% of the range
        span = max(want.max() - want.min(), 1e-12)
        np.testing.assert_allclose([got.min(), got.max()],
                                   [want.min(), want.max()],
                                   atol=0.02 * span)


def test_layers_draw_through_the_initializers():
    lin = GPT(GPTConfig(**DIMS), device="cpu", seed=5).blocks[0].attn.qkv_proj
    limit = math.sqrt(6.0 / (16 + 48))
    gen = torch.Generator().manual_seed(11)
    want = torch.empty(16, 48).uniform_(-limit, limit, generator=gen)
    gen = torch.Generator().manual_seed(11)
    lin.reset_parameters(gen)
    assert torch.equal(lin.weight.detach(), want)
    assert torch.equal(lin.bias.detach(), torch.zeros(48))
