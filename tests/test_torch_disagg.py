"""Disaggregated prefill/decode tiers, the host spill tier and prefix-page
exchange of the port's serving engine, held against the JAX engine on the
same numpy weights: a prefill-tier engine hands each prefill-done slot to
a decode-tier engine through ``poll_handoffs``/``restore_slot`` with the
colocated tokens; the decode tier's refusals, the ``decode_in_place``
fallback and the handoff stamps; per-tier ``warmup_plan()`` and
``reachable_signatures()`` equal to the JAX engine's; the host page pool
(LRU, byte-identical restores, a corrupt page dropped, greedy tokens
unchanged, no build after warmup); export and import of published prefix
pages (roundtrip, spilled pages, corrupt and unprovable bundles refused,
never by eviction)."""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import make_serving_engine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.observability import capture_count
from paddle_tpu_torch.serving import (PREFIX_BUNDLE_FORMAT, HostPagePool,
                                      SlotMigrationError, SpilledPage,
                                      payload_digest, prompt_prefix_digests)

torch.set_num_threads(2)

VOCAB = 64
DIMS = dict(vocab_size=VOCAB, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)
TIER_GEOM = dict(num_slots=4, page_size=4, max_tokens_per_slot=32,
                 prefill_chunk=4)
SPILL_GEOM = dict(num_slots=2, page_size=4, max_tokens_per_slot=44,
                  prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **DIMS))
    params = jmodel.init(jax.random.PRNGKey(0))
    port = GPT.from_jax(GPTConfig(**DIMS), jax.device_get(params),
                        device="cpu")
    return jmodel, params, port


def port_engine(models, geom=TIER_GEOM, **kw):
    return make_serving_engine(models[2], device="cpu",
                               registry=obs.MetricsRegistry(),
                               **{**geom, **kw})


def jax_engine(models, geom=TIER_GEOM, **kw):
    jmodel, params, _ = models
    return jax_serving.ServingEngine(jmodel, params, attn_impl="lax",
                                     registry=jax_obs.MetricsRegistry(),
                                     **{**geom, **kw})


def tier_prompts(n=6, seed=0, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def disagg_run(pre, dec, prompts, n):
    """The two-tier serving loop: step the prefill engine, restore each
    handoff on the decode engine (back on the prefill engine, decoding in
    place, when the decode tier is full), step the decode engine.
    Returns (tokens per prompt, decode rids, fallbacks)."""
    owner = {("p", pre.submit(p, n)): i for i, p in enumerate(prompts)}
    out, dec_rids, fallbacks = {}, [], 0
    while not (pre.scheduler.idle() and dec.scheduler.idle()):
        for rid, toks in pre.step().items():
            out[owner.pop(("p", rid))] = toks
        for rid, snap in pre.poll_handoffs():
            i = owner.pop(("p", rid))
            try:
                new = dec.restore_slot(snap)
                owner[("d", new)] = i
                dec_rids.append(new)
            except SlotMigrationError:
                snap["decode_in_place"] = True
                owner[("p", pre.restore_slot(snap))] = i
                fallbacks += 1
        for rid, toks in dec.step().items():
            out[owner.pop(("d", rid))] = toks
    assert not owner
    return [out[i] for i in range(len(prompts))], dec_rids, fallbacks


@pytest.fixture(scope="module")
def colocated(models):
    """Colocated greedy tokens: the JAX engine's, equal to the port's."""
    prompts = tier_prompts()
    want = jax_engine(models).generate_many(prompts, 8)
    got = port_engine(models).generate_many(prompts, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return prompts, want


def test_handoff_gives_the_colocated_tokens_with_no_build(models,
                                                          colocated):
    prompts, want = colocated
    pre = port_engine(models, tier="prefill", tracer=obs.Tracer())
    dec = port_engine(models, tier="decode")
    pre.warmup()
    dec.warmup()
    before = capture_count()
    got, dec_rids, fallbacks = disagg_run(pre, dec, prompts, 8)
    assert capture_count() == before
    assert pre.health()["recompiles"] == dec.health()["recompiles"] == 0
    assert fallbacks == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert pre.health()["tier"] == "prefill"
    assert dec.health()["tier"] == "decode"
    assert {s[0] for s in pre.graphs.calls} <= {"prefill", "page_read",
                                                "copy_page"}
    assert {s[0] for s in dec.graphs.calls} == {"decode", "page_write"}
    assert pre.migrated_out_total == dec.migrated_in_total == len(prompts)
    for rid in dec_rids:
        st = dec.request_stats(rid)
        assert 0 < st["prefill_done_s"] <= st["handoff_s"] \
            <= st["decode_start_s"]
    assert sorted(s.status for s in pre.tracer.spans("serving.request")) \
        == ["migrated"] * len(prompts)


def test_decode_tier_refuses_prompts_and_mid_prefill_slots(models):
    dec = port_engine(models, tier="decode")
    with pytest.raises(ValueError, match="restored slots"):
        dec.submit(np.arange(1, 5, dtype=np.int32), 4)
    src = port_engine(models, prefill_budget=4)
    src.submit(np.arange(1, 17, dtype=np.int32), 8)   # 16 tokens, chunk 4
    src.step()
    (slot,) = src.scheduler.active_slots()
    assert not src.scheduler.slots[slot].prefill_done
    with pytest.raises(SlotMigrationError, match="prefill-complete"):
        dec.restore_slot(src.snapshot_slot(slot))
    assert not dec.scheduler.active_slots()
    # a prefill-tier engine takes it, finishes the prefill and hands off
    pre = port_engine(models, tier="prefill")
    pre.restore_slot(src.snapshot_slot(slot))
    handoffs = []
    while not handoffs:
        pre.step()
        handoffs = pre.poll_handoffs()
    ((_rid, snap),) = handoffs
    assert snap["state"]["prefilled"] == 16
    new = dec.restore_slot(snap)
    got = {}
    while not dec.scheduler.idle():
        got.update(dec.step())
    want = port_engine(models).generate_many(
        [np.arange(1, 17, dtype=np.int32)], 8)[0]
    np.testing.assert_array_equal(got[new], want)


def test_tier_validation(models):
    with pytest.raises(ValueError, match="tier"):
        port_engine(models, tier="frontend")
    draft = GPT(GPTConfig(**dict(DIMS, hidden_size=8, num_layers=1,
                                 ffn_size=16)), device="cpu", seed=9)
    with pytest.raises(ValueError, match="disaggregated"):
        port_engine(models, tier="prefill", draft_model=draft)
    assert port_engine(models).health()["tier"] == "colocated"
    assert port_engine(models).poll_handoffs() == []


def test_full_decode_tier_falls_back_to_decoding_in_place(models,
                                                          colocated):
    prompts, want = colocated
    pre = port_engine(models, tier="prefill")
    dec = port_engine(models, tier="decode", num_slots=2, num_pages=17)
    got, _, fallbacks = disagg_run(pre, dec, prompts, 8)
    assert fallbacks > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert any(s[0] == "decode" for s in pre.graphs.calls)
    assert not pre._decode_in_place


@pytest.mark.parametrize("tier", ["prefill", "decode"])
@pytest.mark.parametrize("geom", [TIER_GEOM,
                                  dict(num_slots=3, page_size=4,
                                       max_tokens_per_slot=36,
                                       prefill_chunk=8)],
                         ids=["4x8", "3x9"])
def test_tier_plans_equal_the_reference(models, tier, geom):
    ref = jax_engine(models, geom, tier=tier)
    eng = port_engine(models, geom, tier=tier)
    assert eng.warmup_plan() == ref.warmup_plan()
    assert eng.reachable_signatures() == ref.reachable_signatures()
    assert set(eng.warmup_plan()) == eng.reachable_signatures()
    kinds = {s[0] for s in eng.warmup_plan()}
    assert {"page_read", "page_write", "copy_page"} <= kinds
    assert ("decode" in kinds) == (tier == "decode")
    assert ("prefill" in kinds) == (tier == "prefill")


# -- host spill tier -------------------------------------------------------

def _entry(key, fill):
    payload = (np.full((2, 1, 4, 2, 4), fill, np.int8),)
    return SpilledPage(key=key, tokens=np.arange(4, dtype=np.int32),
                       payload=payload, sha256=payload_digest(payload),
                       nbytes=payload[0].nbytes)


def test_host_page_pool_lru_and_generation():
    pool = HostPagePool(2)
    for k in (1, 2, 3):
        pool.put(_entry(k, k))
    assert pool.keys() == frozenset({2, 3})
    assert pool.dropped_total == 1 and pool.spilled_total == 3
    g = pool.gen
    assert pool.get(2) is not None            # 2 becomes hot
    pool.put(_entry(4, 4))                    # 3 is the LRU victim
    assert pool.keys() == frozenset({2, 4})
    assert pool.gen > g
    assert pool.spilled_bytes() == 2 * 64
    pool.discard(2)
    assert pool.keys() == frozenset({4}) and pool.pop(2) is None
    pool.note_restored(1, 64)
    assert (pool.restored_total, pool.restored_bytes_total) == (1, 64)
    with pytest.raises(ValueError):
        HostPagePool(0)
    assert payload_digest(_entry(1, 1).payload) == \
        jax_serving.paged_cache.payload_digest(_entry(1, 1).payload)


def _prefix(seed=1, n=16):
    return np.random.default_rng(seed).integers(1, VOCAB, n).astype(
        np.int32)


def spill_schedule(eng, prefix, seed=0):
    """Publish ``prefix``, push it out of the card with a 32-token filler,
    then hit it again. Returns the three outputs."""
    rng = np.random.default_rng(seed)
    p1 = np.concatenate([prefix, rng.integers(1, VOCAB, 3).astype(np.int32)])
    filler = np.arange(1, 33, dtype=np.int32) % (VOCAB - 1) + 1
    p2 = np.concatenate([prefix, rng.integers(1, VOCAB, 2).astype(np.int32)])
    return [eng.generate_many([p], 6, max_steps=10_000)[0]
            for p in (p1, filler, p2)]


@pytest.mark.parametrize("cache_dtype", [None, torch.int8],
                         ids=["fp32", "int8"])
def test_spill_keeps_greedy_tokens_and_builds_nothing(models, cache_dtype):
    jdt = None if cache_dtype is None else jax.numpy.int8
    want = spill_schedule(jax_engine(models, SPILL_GEOM, num_pages=12,
                                     host_spill_pages=8, cache_dtype=jdt),
                          _prefix())
    base = spill_schedule(port_engine(models, SPILL_GEOM, num_pages=12,
                                      cache_dtype=cache_dtype), _prefix())
    eng = port_engine(models, SPILL_GEOM, num_pages=12, host_spill_pages=8,
                      cache_dtype=cache_dtype)
    eng.warmup()
    before = capture_count()
    got = spill_schedule(eng, _prefix())
    assert capture_count() == before and eng.health()["recompiles"] == 0
    pool = eng.cache.spill_pool
    assert pool.spilled_total > 0 and pool.restored_total > 0
    for ent in pool.entries():
        assert len(ent.payload) == (2 if cache_dtype else 1)
    for a, b, c in zip(got, base, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    reg = eng._reg
    assert reg.counter("serving_spill_restored_pages_total").value() == \
        pool.restored_total
    head = eng.health()["headroom"]
    assert head["spill_pages"] == len(pool)
    assert head["spill_bytes"] == pool.spilled_bytes()
    assert head["spill"] == pytest.approx(1.0 - len(pool) / 8)
    eng.cache.check_invariants()


def test_spill_restore_is_byte_identical(models):
    eng = port_engine(models, SPILL_GEOM, num_pages=12, host_spill_pages=8)
    prefix = _prefix()
    rng = np.random.default_rng(0)
    p1 = np.concatenate([prefix, rng.integers(1, VOCAB, 3).astype(np.int32)])
    eng.generate_many([p1], 6)
    golden = {key: eng._spill_read(pid)
              for key, pid in eng.cache._full_index.items()}
    gen0 = eng.health()["prefix_gen"]
    eng.generate_many([np.arange(1, 33, dtype=np.int32) % (VOCAB - 1) + 1],
                      6)
    pool = eng.cache.spill_pool
    assert len(pool) > 0 and eng.health()["prefix_gen"] > gen0
    assert pool.keys() <= set(golden)
    assert pool.keys() <= eng.cache.advertised_digests()
    for ent in pool.entries():
        for a, b in zip(ent.payload, golden[ent.key]):
            np.testing.assert_array_equal(a, b)
    p2 = np.concatenate([prefix, rng.integers(1, VOCAB, 2).astype(np.int32)])
    eng.generate_many([p2], 6)
    assert pool.restored_total > 0
    checked = 0
    for key, want in golden.items():
        pid = eng.cache._full_index.get(key)
        if pid is not None:
            for a, b in zip(eng._spill_read(pid), want):
                np.testing.assert_array_equal(a, b)
            checked += 1
    assert checked >= pool.restored_total
    eng.cache.check_invariants()


def test_corrupt_spilled_page_is_dropped_and_reprefilled(models):
    base = spill_schedule(port_engine(models, SPILL_GEOM, num_pages=12),
                          _prefix())
    eng = port_engine(models, SPILL_GEOM, num_pages=12, host_spill_pages=8)
    rng = np.random.default_rng(0)
    prefix = _prefix()
    outs = [eng.generate_many([np.concatenate(
        [prefix, rng.integers(1, VOCAB, 3).astype(np.int32)])], 6)[0]]
    outs.append(eng.generate_many(
        [np.arange(1, 33, dtype=np.int32) % (VOCAB - 1) + 1], 6)[0])
    pool = eng.cache.spill_pool
    first = prompt_prefix_digests(prefix, 4)[0]
    assert first in pool.keys()
    pool.get(first).payload[0].reshape(-1)[0] += 1.0      # host rot
    with pytest.raises(AssertionError, match="corrupted"):
        eng.cache.check_invariants()
    outs.append(eng.generate_many([np.concatenate(
        [prefix, rng.integers(1, VOCAB, 2).astype(np.int32)])], 6)[0])
    assert eng._reg.counter("serving_spill_corrupt_total").value() == 1
    assert first not in pool.keys() and pool.restored_total == 0
    for a, b in zip(outs, base):
        np.testing.assert_array_equal(a, b)
    eng.cache.check_invariants()


# -- prefix-page exchange --------------------------------------------------

def _published(eng, prefix):
    """Serve ``prefix`` + 3 tokens; the digests of its 4 full pages."""
    prompt = np.concatenate([prefix, prefix[:3]])
    eng.generate_many([prompt], 6)
    return prompt_prefix_digests(prompt, 4)


def test_export_import_roundtrip(models):
    src = port_engine(models, SPILL_GEOM, num_pages=24, host_spill_pages=8)
    dst = port_engine(models, SPILL_GEOM, num_pages=24, host_spill_pages=8)
    src.warmup()
    dst.warmup()
    before = capture_count()
    prefix = _prefix()
    p1 = np.concatenate([prefix, prefix[:3]])
    digests = _published(src, prefix)
    bundle = src.export_prefix_pages(digests)
    assert bundle["format"] == PREFIX_BUNDLE_FORMAT
    assert bundle["geometry"]["dtype"] == "float32"
    assert len(bundle["pages"]) == len(digests) == 4
    assert dst.import_prefix_pages(bundle) == 4
    assert dst.import_prefix_pages(bundle) == 0          # all held
    assert set(digests) <= dst.cache.advertised_digests()
    dst.cache.check_invariants()
    np.testing.assert_array_equal(dst.generate_many([p1], 6)[0],
                                  src.generate_many([p1], 6)[0])
    assert dst._reg.counter(
        "serving_prefix_shared_tokens_total").value() >= 16
    assert capture_count() == before


def test_bundles_cross_between_the_packages(models):
    prefix = _prefix(seed=2)
    p1 = np.concatenate([prefix, prefix[:3]])
    jsrc = jax_engine(models, SPILL_GEOM, num_pages=24)
    jbundle = jsrc.export_prefix_pages(_published(jsrc, prefix))
    dst = port_engine(models, SPILL_GEOM, num_pages=24)
    assert dst.import_prefix_pages(jbundle) == 4
    psrc = port_engine(models, SPILL_GEOM, num_pages=24)
    pbundle = psrc.export_prefix_pages(_published(psrc, prefix))
    assert [p["key"] for p in pbundle["pages"]] == \
        [p["key"] for p in jbundle["pages"]]
    jdst = jax_engine(models, SPILL_GEOM, num_pages=24)
    assert jdst.import_prefix_pages(pbundle) == 4
    # installed pages hold the carried bytes: re-exported, same digests
    keys = [p["key"] for p in jbundle["pages"]]
    for bundle, again in ((jbundle, dst.export_prefix_pages(keys)),
                          (pbundle, jdst.export_prefix_pages(keys))):
        assert [p["manifest"][0]["sha256"] for p in again["pages"]] == \
            [p["manifest"][0]["sha256"] for p in bundle["pages"]]
    want = jsrc.generate_many([p1], 6)[0]
    np.testing.assert_array_equal(dst.generate_many([p1], 6)[0], want)
    np.testing.assert_array_equal(jdst.generate_many([p1], 6)[0], want)


def test_export_covers_spilled_pages(models):
    src = port_engine(models, SPILL_GEOM, num_pages=12, host_spill_pages=8)
    prefix = _prefix()
    spill_schedule(src, prefix)
    rng = np.random.default_rng(5)
    src.generate_many([rng.integers(1, VOCAB, 36).astype(np.int32)], 6)
    spilled = src.cache.spill_pool.keys()
    digests = prompt_prefix_digests(prefix, 4)
    assert spilled & set(digests)
    bundle = src.export_prefix_pages(digests)
    assert {int(p["key"]) for p in bundle["pages"]} >= spilled & set(digests)
    dst = port_engine(models, SPILL_GEOM, num_pages=24)
    assert dst.import_prefix_pages(bundle) == len(bundle["pages"])


def test_rotted_spilled_copy_never_leaves(models):
    src = port_engine(models, SPILL_GEOM, num_pages=12, host_spill_pages=8)
    prefix = _prefix()
    _published(src, prefix)
    src.generate_many([np.arange(1, 33, dtype=np.int32) % (VOCAB - 1) + 1],
                      6)
    digests = prompt_prefix_digests(prefix, 4)
    pool = src.cache.spill_pool
    assert digests[0] in pool.keys()
    pool.get(digests[0]).payload[0].reshape(-1)[0] += 1.0
    assert src.export_prefix_pages(digests) is None
    assert digests[0] not in pool.keys()
    assert src._reg.counter("serving_spill_corrupt_total").value() == 1


def _fresh_pair(models):
    src = port_engine(models, SPILL_GEOM, num_pages=24)
    dst = port_engine(models, SPILL_GEOM, num_pages=24)
    bundle = src.export_prefix_pages(_published(src, _prefix()))
    return dst, bundle


def test_corrupt_bundle_is_refused_and_installs_nothing(models):
    dst, bundle = _fresh_pair(models)
    shard = bundle["pages"][2]["shards"][0].copy()
    shard.view(np.uint8).flat[0] ^= 1
    bundle["pages"][2]["shards"][0] = shard
    with pytest.raises(SlotMigrationError, match="sha256"):
        dst.import_prefix_pages(bundle)
    assert not dst.cache.advertised_digests()
    assert dst.cache.idle_free_pages == 23
    dst.cache.check_invariants()


@pytest.mark.parametrize("breakage", ["key", "tokens", "order"])
def test_broken_chain_is_refused(models, breakage):
    dst, bundle = _fresh_pair(models)
    pages = bundle["pages"]
    if breakage == "key":
        pages[1]["key"] = int(pages[1]["key"]) ^ 1
    elif breakage == "tokens":
        pages[1]["tokens"] = pages[1]["tokens"][::-1].copy()
    else:
        pages[0], pages[1] = pages[1], pages[0]
    with pytest.raises(SlotMigrationError, match="chain"):
        dst.import_prefix_pages(bundle)
    assert not dst.cache.advertised_digests()
    dst.cache.check_invariants()


def test_import_never_evicts(models):
    src = port_engine(models, SPILL_GEOM, num_pages=24)
    bundle = src.export_prefix_pages(_published(src, _prefix()))
    dst = port_engine(models, SPILL_GEOM, num_pages=12)
    local = _prefix(seed=7)
    _published(dst, local)                 # 4 published pages, parked
    held = set(dst.cache.published_digests())
    # a live reservation leaves 3 idle free pages: the bundle's 4 would
    # need an eviction of the parked local pages
    dst.cache.reserve(0, 4 * (dst.cache.idle_free_pages - 3))
    assert dst.cache.idle_free_pages == 3
    with pytest.raises(SlotMigrationError, match="idle page capacity"):
        dst.import_prefix_pages(bundle)
    assert set(dst.cache.published_digests()) == held
    dst.cache.check_invariants()
    other = dict(bundle, geometry=dict(bundle["geometry"], page_size=8))
    with pytest.raises(SlotMigrationError, match="geometry"):
        port_engine(models, SPILL_GEOM, num_pages=24).import_prefix_pages(
            other)
