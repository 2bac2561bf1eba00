"""Slot migration of the port's serving engine, held against the JAX
engine on the same numpy weights: snapshot and restore mid-decode give the
unmigrated tokens; snapshots cross between the two packages in both
directions over fp32, int8 (scale rows in the shard) and bf16 pools (the
port carries bf16 pages as uint16 bits; the ml_dtypes view is taken here,
on the test side) with identical tokens and digests; corrupt, mismatched
and inconsistent snapshots are refused before any page lands; a pending
copy-on-write tail reads through to its source; ``cancel_queued``,
``release_slot`` and micro-snapshots."""

import jax
import ml_dtypes
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
from paddle_tpu_torch.serving import (MIGRATION_FORMAT, SlotMigrationError)

torch.set_num_threads(2)

DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)
GEOM = dict(num_slots=3, page_size=4, prefill_chunk=8, decode_block=2,
            max_tokens_per_slot=36)
NEW = 10
DTYPES = {"fp32": (None, None), "int8": (torch.int8, "int8"),
          "bf16": (torch.bfloat16, "bf16")}


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **DIMS))
    params = jmodel.init(jax.random.PRNGKey(0))
    port = GPT.from_jax(GPTConfig(**DIMS), jax.device_get(params),
                        device="cpu")
    return jmodel, params, port


_JAX_DTYPES = {None: None, "int8": jax.numpy.int8,
               "bf16": jax.numpy.bfloat16}


@pytest.fixture(scope="module")
def jax_engines(models):
    """One JAX engine per pool dtype (its compiled buckets reused)."""
    jmodel, params, _ = models
    return {name: jax_serving.ServingEngine(
        jmodel, params, attn_impl="lax", cache_dtype=_JAX_DTYPES[jd],
        registry=jax_obs.MetricsRegistry(), **GEOM)
        for name, (_, jd) in DTYPES.items()}


def port_engine(models, cache_dtype=None, **kw):
    kw = {**GEOM, **kw}
    return make_serving_engine(models[2], device="cpu",
                               cache_dtype=cache_dtype,
                               registry=obs.MetricsRegistry(), **kw)


def prompts(seed=0, lens=(9, 6, 13), prefix=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 64, prefix).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 64, n).astype(np.int32)])
            for n in lens]


def drain(eng, out=None):
    out = {} if out is None else out
    while not eng.scheduler.idle():
        out.update(eng.step())
    return out


def to_mid_decode(eng, ps):
    """Submit ``ps`` and step until every request has decoded a block
    (all prefilled, none finished). Returns the rids."""
    rids = [eng.submit(p, NEW) for p in ps]
    while True:
        eng.step()
        slots = [eng.scheduler.slots[i] for i in eng.scheduler.active_slots()]
        if len(slots) == len(ps) and all(
                s.prefill_done and len(s.generated) >= 3 for s in slots):
            break
    assert all(not s.finished() for s in slots)
    return rids


def slot_of(eng, rid):
    return next(i for i in eng.scheduler.active_slots()
                if eng.scheduler.slots[i].request.rid == rid)


def bf16_bits(snap, view):
    """The snapshot with each K/V shard viewed as ``view`` (uint16 for
    the port, ml_dtypes bfloat16 for the JAX engine): the same bytes."""
    return dict(snap, shards=[np.asarray(s).view(view)
                              for s in snap["shards"]])


def migrate(src, dst, rids, convert=lambda s: s, check=None):
    """Snapshot, release and restore every live slot of ``src`` on
    ``dst``; re-snapshot each restored slot at once, whose digests must
    equal the carried ones (``check`` converts that snapshot back).
    Returns {src rid: dst rid}."""
    moved = {}
    for rid in rids:
        slot = slot_of(src, rid)
        snap = src.snapshot_slot(slot)
        src.release_slot(slot)
        new = dst.restore_slot(convert(snap))
        again = dst.snapshot_slot(slot_of(dst, new))
        assert [r["sha256"] for r in again["manifest"]] == \
            [r["sha256"] for r in snap["manifest"]]
        if check is not None:
            check(snap, again)
        moved[rid] = new
    return moved


@pytest.fixture(scope="module")
def unmigrated(models, jax_engines):
    """Greedy tokens of the three prompts per pool dtype: the JAX engine's,
    which the port's unmigrated run must equal."""
    out = {}
    for name, (cd, _) in DTYPES.items():
        want = jax_engines[name].generate_many(prompts(), NEW)
        got = port_engine(models, cd).generate_many(prompts(), NEW)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        out[name] = want
    return out


def test_snapshot_restore_mid_decode_equals_unmigrated(models, unmigrated):
    a = port_engine(models, tracer=obs.Tracer())
    b = port_engine(models)                   # tracing off
    rids = to_mid_decode(a, prompts())
    traces = {rid: a._req_spans[rid].trace_id for rid in rids}
    moved = migrate(a, b, rids)
    assert not a.scheduler.active_slots()
    a.cache.check_invariants()
    got = drain(b)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(got[moved[rid]], unmigrated["fp32"][i])
        stats = b.request_stats(moved[rid])
        assert stats["trace_id"] == traces[rid]       # adopted, tracing off
    assert a.migrated_out_total == 3 and b.migrated_in_total == 3
    assert a._reg.counter("serving_migrated_out_total").value() == 3
    assert b._reg.counter("serving_migrated_in_total").value() == 3
    out_spans = a.tracer.spans("serving.request")
    assert sorted(s.status for s in out_spans) == ["migrated"] * 3
    assert all(any(e[1] == "migrated_out" for e in s.events)
               for s in out_spans)
    b.cache.check_invariants()


def test_restored_span_adopts_the_trace(models):
    a = port_engine(models, tracer=obs.Tracer())
    tr = obs.Tracer()
    b = port_engine(models, tracer=tr)
    rids = to_mid_decode(a, prompts()[:1])
    trace = a._req_spans[rids[0]].trace_id
    migrate(a, b, rids)
    drain(b)
    (span,) = tr.spans("serving.request")
    assert span.trace_id == trace and span.attrs["migrated"] is True
    assert any(e[1] == "migrated_in" for e in span.events)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_snapshot_restores_into_the_port(models, jax_engines,
                                             unmigrated, dtype):
    cd = DTYPES[dtype][0]
    src = jax_engines[dtype]
    dst = port_engine(models, cd)
    rids = to_mid_decode(src, prompts())
    to_port = ((lambda s: bf16_bits(s, np.uint16)) if dtype == "bf16"
               else (lambda s: s))
    moved = migrate(src, dst, rids, convert=to_port)
    got = drain(dst)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(got[moved[rid]], unmigrated[dtype][i])
    drain(src)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_snapshot_restores_into_the_jax_engine(models, jax_engines,
                                                    unmigrated, dtype):
    cd = DTYPES[dtype][0]
    src = port_engine(models, cd)
    dst = jax_engines[dtype]
    rids = to_mid_decode(src, prompts())
    snap = src.snapshot_slot(slot_of(src, rids[0]))
    geo = snap["geometry"]
    assert geo["dtype"] == {"fp32": "float32", "int8": "int8",
                            "bf16": "bfloat16"}[dtype]
    if dtype == "bf16":
        assert snap["shards"][0].dtype == np.uint16
    if dtype == "int8":
        kv, sc = snap["shards"][0]
        assert kv.dtype == np.int8 and sc.dtype == np.float32
        assert sc.shape == (2, DIMS["num_layers"], GEOM["page_size"])
    to_jax = ((lambda s: bf16_bits(s, ml_dtypes.bfloat16))
              if dtype == "bf16" else (lambda s: s))
    moved = migrate(src, dst, rids, convert=to_jax)
    got = drain(dst)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(got[moved[rid]], unmigrated[dtype][i])


def _pages_state(eng):
    return [t.clone() for layer in eng.cache.pages for t in layer]


def _assert_nothing_landed(eng, before):
    assert not eng.scheduler.active_slots()
    assert eng.cache.pages_in_use == 0
    for x, y in zip(_pages_state(eng), before):
        assert torch.equal(x, y)
    eng.cache.check_invariants()


@pytest.fixture
def live_snapshot(models):
    a = port_engine(models)
    rids = to_mid_decode(a, prompts()[:1])
    return a.snapshot_slot(slot_of(a, rids[0]))


def test_corrupt_shard_is_refused_and_nothing_lands(models, live_snapshot):
    b = port_engine(models)
    before = _pages_state(b)
    bad = dict(live_snapshot, shards=list(live_snapshot["shards"]))
    shard = bad["shards"][-1].copy()
    shard.reshape(-1)[5] += 1.0
    bad["shards"][-1] = shard
    with pytest.raises(SlotMigrationError, match="sha256"):
        b.restore_slot(bad)
    _assert_nothing_landed(b, before)


def test_corrupt_int8_scale_row_is_refused(models):
    a = port_engine(models, torch.int8)
    rids = to_mid_decode(a, prompts()[:1])
    snap = a.snapshot_slot(slot_of(a, rids[0]))
    kv, sc = snap["shards"][0]
    sc = sc.copy()
    sc[0, 0, 0] *= 2.0
    snap["shards"] = [(kv, sc)] + snap["shards"][1:]
    b = port_engine(models, torch.int8)
    before = _pages_state(b)
    with pytest.raises(SlotMigrationError, match="sha256"):
        b.restore_slot(snap)
    _assert_nothing_landed(b, before)


@pytest.mark.parametrize("other", [dict(page_size=8),
                                   dict(cache_dtype=torch.bfloat16)],
                         ids=["page_size", "dtype"])
def test_geometry_or_dtype_mismatch_is_refused(models, live_snapshot, other):
    b = port_engine(models, **other)
    before = _pages_state(b)
    with pytest.raises(SlotMigrationError, match="geometry"):
        b.restore_slot(live_snapshot)
    _assert_nothing_landed(b, before)


@pytest.mark.parametrize("change", ["drop", "extra"])
def test_shard_count_mismatch_is_refused(models, live_snapshot, change):
    snap = dict(live_snapshot)
    if change == "drop":
        snap["shards"] = snap["shards"][:-1]
        snap["manifest"] = snap["manifest"][:-1]
    else:
        snap["shards"] = snap["shards"] + snap["shards"][-1:]
        snap["manifest"] = snap["manifest"] + snap["manifest"][-1:]
    b = port_engine(models)
    before = _pages_state(b)
    with pytest.raises(SlotMigrationError, match="inconsistent"):
        b.restore_slot(snap)
    _assert_nothing_landed(b, before)


def test_unknown_format_and_bit_conversion_are_refused(models,
                                                       live_snapshot):
    b = port_engine(models)
    with pytest.raises(SlotMigrationError, match="format"):
        b.restore_slot(dict(live_snapshot, format="other"))
    # a shard of another dtype, even with a matching digest, never lands
    # by value conversion
    snap = dict(live_snapshot)
    snap["shards"] = [s.astype(np.float64) for s in snap["shards"]]
    snap["manifest"] = [dict(r, sha256=b._shard_digest(s))
                        for r, s in zip(snap["manifest"], snap["shards"])]
    before = _pages_state(b)
    with pytest.raises(SlotMigrationError, match="float64"):
        b.restore_slot(snap)
    _assert_nothing_landed(b, before)
    assert live_snapshot["format"] == MIGRATION_FORMAT


def test_speculative_engine_refuses_migration(models):
    draft = GPT(GPTConfig(**dict(DIMS, hidden_size=8, num_layers=1,
                                 ffn_size=16)), device="cpu", seed=9)
    eng = port_engine(models, draft_model=draft, spec_k=3)
    rids = [eng.submit(p, NEW) for p in prompts()[:1]]
    eng.step()
    with pytest.raises(SlotMigrationError, match="speculative"):
        eng.snapshot_slot(slot_of(eng, rids[0]))
    with pytest.raises(SlotMigrationError, match="speculative"):
        eng.restore_slot({"format": MIGRATION_FORMAT})
    with pytest.raises(ValueError, match="micro-snapshots"):
        port_engine(models, draft_model=draft, spec_k=3,
                    snapshot_every_blocks=1)


def test_pending_cow_tail_reads_through_to_its_source(models):
    # A publishes 2 full pages and a 2-token tail; B shares 9 tokens, the
    # 9th inside A's tail page: B's reservation owes a copy of that page
    base = prompts(seed=3, lens=(10,))[0]
    pb = np.concatenate([base[:9], np.asarray([7, 11, 13], np.int32)])
    eng = port_engine(models)
    want = port_engine(models, prefix_sharing=False).generate_many(
        [pb], NEW)[0]
    eng.generate_many([base], NEW)
    rid = eng.submit(pb, NEW)
    eng.scheduler.admit(on_admit=eng._on_admit)   # admitted, not prefilled
    slot = slot_of(eng, rid)
    src, dst = eng.cache.pending_copy(slot)
    assert eng.cache.lengths[slot] == 9
    snap = eng.snapshot_slot(slot)
    (src_page,) = eng._read_pages([src])
    assert len(snap["shards"]) == 3
    np.testing.assert_array_equal(snap["shards"][2], src_page[0])
    (dst_page,) = eng._read_pages([dst])
    assert not np.array_equal(dst_page[0], src_page[0])   # not copied yet
    eng.release_slot(slot)
    eng.cache.check_invariants()
    other = port_engine(models)
    new = other.restore_slot(snap)
    np.testing.assert_array_equal(drain(other)[new], want)


def test_cancel_queued_and_release_slot(models):
    tr = obs.Tracer()
    eng = port_engine(models, tracer=tr)
    ps = prompts(lens=(9, 6, 13, 5, 7))
    rids = [eng.submit(p, NEW) for p in ps]
    eng.step()                                   # 3 slots admitted
    popped = eng.cancel_queued()
    assert [r.rid for r in popped] == rids[3:]
    for r, p in zip(popped, ps[3:]):
        np.testing.assert_array_equal(r.prompt, p)
    assert eng.scheduler.queue_depth() == 0
    assert sorted(s.status for s in tr.spans("serving.request")) == \
        ["requeued", "requeued"]
    slot = slot_of(eng, rids[0])
    in_use = eng.cache.pages_in_use
    st = eng.release_slot(slot)
    assert st.request.rid == rids[0]
    assert eng.scheduler.slots[slot] is None
    assert eng.cache.pages_in_use < in_use
    eng.cache.check_invariants()
    assert eng._reg.counter("serving_migrated_out_total").value() == 1
    with pytest.raises(SlotMigrationError, match="empty"):
        eng.release_slot(slot)
    got = drain(eng)
    assert set(got) == set(rids[1:3])             # released: no result
    assert eng.result(rids[0]) is None


def test_micro_snapshots_restore_to_the_unmigrated_tokens(models,
                                                         unmigrated):
    eng = port_engine(models, snapshot_every_blocks=2)
    rids = [eng.submit(p, NEW) for p in prompts()]
    seen = {}
    while not eng.scheduler.idle():
        eng.step()
        for rid, snap in eng.poll_micro_snapshots().items():
            blocks = snap["state"]["phase_acc"]["decode_blocks"]
            assert blocks % 2 == 0 and blocks > 0
            seen.setdefault(rid, snap)            # the first of each
    assert set(seen) == set(rids)
    assert eng.poll_micro_snapshots() == {}
    for i, rid in enumerate(rids):
        other = port_engine(models)
        new = other.restore_slot(seen[rid])
        np.testing.assert_array_equal(drain(other)[new],
                                      unmigrated["fp32"][i])
    with pytest.raises(ValueError, match="snapshot_every_blocks"):
        port_engine(models, snapshot_every_blocks=0)
