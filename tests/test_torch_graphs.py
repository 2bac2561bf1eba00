"""The engine's warmup plan and its step builds on the CPU, held against
the JAX engine: the port's ``warmup_plan()`` and ``reachable_signatures()``
equal the JAX engine's, page-IO signatures (``("page_read",)``,
``("page_write",)``) included, for plain and speculative engines at two geometries
(3 and 5 slots, odd page counts per slot); the plan covers the reachable
set; after ``warmup()`` serving builds nothing (the counterpart of zero
recompiles, which on the card is zero CUDA graph captures); an engine
that was not warmed counts its first-use builds, and the detector counts
those after its first check as recompiles; page tensors keep their
addresses, which captured graphs bake in."""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.inference import make_serving_engine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.observability import MetricsRegistry, capture_count

torch.set_num_threads(2)

DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)
DRAFT_DIMS = dict(vocab_size=64, hidden_size=8, num_layers=1, num_heads=2,
                  ffn_size=16, max_position=64)
#: 3 slots x 9 pages and 5 slots x 5 pages of 4 tokens (odd widths: the
#: last bucket is the capacity, not a power of two)
GEOMETRIES = [dict(num_slots=3, page_size=4, max_tokens_per_slot=36),
              dict(num_slots=5, page_size=4, max_tokens_per_slot=20)]


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, dims, seed in (("target", DIMS, 0), ("draft", DRAFT_DIMS, 9)):
        jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla",
                                          **dims))
        params = jmodel.init(jax.random.PRNGKey(seed))
        out[name] = (jmodel, params, GPT.from_jax(
            GPTConfig(**dims), jax.device_get(params), device="cpu"))
    return out


def _prompts(seed, lens, prefix=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 64, prefix).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 64, n).astype(np.int32)])
            for n in lens]


def _engine(models, spec, **kw):
    _, _, model = models["target"]
    draft = models["draft"][2] if spec else None
    return make_serving_engine(model, device="cpu", draft_model=draft,
                               spec_k=3, prefill_chunk=8,
                               registry=MetricsRegistry(), **kw)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=["3x9", "5x5"])
def test_plan_and_reachable_set_equal_the_reference_without_page_io(
        models, geom, spec):
    jmodel, params, _ = models["target"]
    jkw = {}
    if spec:
        jdraft, dparams, _ = models["draft"]
        jkw = dict(draft_model=jdraft, draft_params=dparams)
    ref = jax_serving.ServingEngine(
        jmodel, params, attn_impl="lax", spec_k=3, prefill_chunk=8,
        registry=jax_obs.MetricsRegistry(), **geom, **jkw)
    eng = _engine(models, spec, **geom)
    # the name predates the page IO: the plan now equals the reference's
    # with ("page_read",) and ("page_write",)
    assert eng.warmup_plan() == ref.warmup_plan()
    assert eng.reachable_signatures() == ref.reachable_signatures()
    assert eng.reachable_signatures() <= set(eng.warmup_plan())
    assert len(eng.warmup_plan()) == len(set(eng.warmup_plan()))


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_warmed_engine_builds_nothing_while_serving(models, spec):
    eng = _engine(models, spec, **GEOMETRIES[0])
    cold = _engine(models, spec, **GEOMETRIES[0])
    prompts = _prompts(1, [9, 3, 14, 6, 11], prefix=10)
    want = cold.generate_many(prompts, 6, max_steps=400)
    eng.warmup()
    assert eng.warmed_signatures == set(eng.warmup_plan())
    assert eng.graphs.signatures() == set(eng.warmup_plan())
    assert eng.graphs.builds == len(eng.warmup_plan())
    before = (eng.graphs.builds, capture_count())
    # the second pass finds the first's published prompt pages: the
    # non-speculative engine copies each borrowed tail page
    for _ in range(2):
        got = eng.generate_many(prompts, 6, max_steps=400)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    assert (eng.graphs.builds, capture_count()) == before
    assert eng.health()["recompiles"] == 0
    assert eng.recompile_detector.recompiles == 0
    assert set(eng.graphs.calls) <= set(eng.warmup_plan())
    assert (("copy_page",) in eng.graphs.calls) == (not spec)


def test_unwarmed_engine_counts_first_use_builds(models):
    eng = _engine(models, False, **GEOMETRIES[1])
    base = capture_count()
    prompts = _prompts(2, [3, 9, 7, 1], prefix=5)
    for p in prompts:
        eng.submit(p, 5)
    at_first_check = None
    while not eng.scheduler.idle():
        eng.step()
        if at_first_check is None and eng.health()["steps"] == 1:
            at_first_check = eng.graphs.builds
    built = eng.graphs.signatures()
    assert eng.graphs.builds == len(built) == capture_count() - base > 0
    assert built <= eng.reachable_signatures()
    # builds the detector saw after its first (warmup) check count as
    # recompiles, as the reference counts post-warmup XLA compiles
    assert eng.health()["recompiles"] == eng.graphs.builds - at_first_check
    eng.warmup()
    assert eng.graphs.builds == len(eng.warmup_plan())


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_page_tensors_keep_their_addresses(models, spec):
    eng = _engine(models, spec, **GEOMETRIES[0])
    caches = [eng.cache] + ([eng.draft_cache] if spec else [])

    def ptrs():
        return [t.data_ptr() for c in caches for layer in c.pages
                for t in layer]

    before = ptrs()
    eng.warmup()
    assert ptrs() == before
    eng.generate_many(_prompts(3, [5, 13, 8], prefix=6), 7, max_steps=400)
    assert ptrs() == before
