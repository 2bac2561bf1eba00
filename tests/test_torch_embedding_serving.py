"""The port's embedding serving (``paddle_tpu_torch.embedding_serving``)
against the reference's on the CPU: the device cache's index, eviction
and warmup plan, the randomized id stream with streaming pushes (rows
equal to the store's and to the JAX engine's), the streaming channel, the
engine's load shed, capacity retry and self-heal, DeepFM probabilities
against the JAX engine on the same weights, span and metric names, and
KV snapshots across the packages."""

import os
import time

import jax
import numpy as np
import pytest

from paddle_tpu import embedding_serving as jes
from paddle_tpu import observability as jobs
from paddle_tpu.models.deepfm import DeepFMHostKV as JaxDeepFM
from paddle_tpu.parallel.host_kv import HostKVStore as JaxStore
from paddle_tpu.resilience import SnapshotCorruptionError as JaxCorrupt
from paddle_tpu_torch import embedding_serving as es
from paddle_tpu_torch import inference
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.models.deepfm import DeepFMHostKV
from paddle_tpu_torch.observability import recompile
from paddle_tpu_torch.parallel.host_kv import HostKVStore
from paddle_tpu_torch.resilience.snapshot import SnapshotCorruptionError

CPU = "cpu"


def _store(dim=4, cls=HostKVStore, **kw):
    kw.setdefault("optimizer", "sgd")
    kw.setdefault("init_scale", 0.1)
    kw.setdefault("seed", 0)
    return cls(dim, **kw)


def _cache(*args, **kw):
    kw.setdefault("registry", obs.MetricsRegistry())
    return es.DeviceEmbeddingCache(*args, device=CPU, **kw)


def _jcache(*args, **kw):
    kw.setdefault("registry", jobs.MetricsRegistry())
    return jes.DeviceEmbeddingCache(*args, **kw)


def _engine(store, model=None, **kw):
    kw.setdefault("registry", obs.MetricsRegistry())
    return es.EmbeddingServingEngine(store, model, device=CPU, **kw)


def _jengine(store, model=None, params=None, **kw):
    kw.setdefault("registry", jobs.MetricsRegistry())
    return jes.EmbeddingServingEngine(store, model, params, **kw)


# -- the device cache ----------------------------------------------------------

def test_install_gather_roundtrip():
    c = _cache(8, 3, min_gather_bucket=4, min_install_bucket=2)
    ids = np.array([10, 20, 30], np.int64)
    rows = np.arange(9, dtype=np.float32).reshape(3, 3)
    c.install(ids, rows)
    got = c.gather(ids).numpy()
    assert got.shape == (4, 3)          # pow2 bucket
    np.testing.assert_array_equal(got[:3], rows)
    c.check_invariants()


def test_refresh_reuses_the_slot_and_the_table_keeps_its_storage():
    c = _cache(4, 2, min_gather_bucket=2)
    ptr = c.table.data_ptr()
    c.install(np.array([7]), np.ones((1, 2), np.float32))
    slot = c._slot_of[7]
    c.install(np.array([7]), np.full((1, 2), 9.0, np.float32))
    assert c._slot_of[7] == slot
    np.testing.assert_array_equal(c.gather(np.array([7])).numpy()[0], 9.0)
    assert c.table.data_ptr() == ptr
    assert not c.table[0].any()          # padding lanes write zeros there
    c.check_invariants()


def _victims(policy, make):
    c = make(3, 2, policy=policy, min_gather_bucket=2)
    for i in (1, 2, 3):
        c.install(np.array([i]), np.full((1, 2), float(i), np.float32))
    if policy == "lru":
        c.gather(np.array([1]))             # 1 becomes MRU
    else:
        for _ in range(3):
            c.gather(np.array([1, 3]))      # 2 stays at freq 0
    c.install(np.array([4]), np.full((1, 2), 4.0, np.float32))
    return sorted(c._slot_of.items())


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_victims_equal_the_reference(policy):
    got = _victims(policy, _cache)
    assert got == _victims(policy, _jcache)
    assert 2 not in dict(got)


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_eviction_sequence_equals_the_reference(policy):
    rng = np.random.default_rng(5)
    c = _cache(16, 2, policy=policy, min_gather_bucket=4,
               min_install_bucket=2)
    j = _jcache(16, 2, policy=policy, min_gather_bucket=4,
                min_install_bucket=2)
    for _ in range(25):
        ids = np.unique(rng.integers(0, 40, size=(6,))).astype(np.int64)
        for cache in (c, j):
            hit, miss = cache.split(ids)
            cache.install(miss, np.zeros((miss.size, 2), np.float32),
                          protect=ids.tolist())
            cache.gather(ids)
        assert c._slot_of == j._slot_of
        np.testing.assert_array_equal(c._slot_last, j._slot_last)
        np.testing.assert_array_equal(c._slot_freq, j._slot_freq)
        c.check_invariants()


def test_protect_set_never_evicted_and_capacity_errors():
    c = _cache(2, 2, min_gather_bucket=2)
    c.install(np.array([1, 2]), np.zeros((2, 2), np.float32))
    with pytest.raises(es.CacheCapacityError):
        c.install(np.array([3]), np.zeros((1, 2), np.float32),
                  protect=[1, 2, 3])
    c.check_invariants()
    c2 = _cache(2, 2, min_gather_bucket=2)
    with pytest.raises(es.CacheCapacityError):
        c2.install(np.arange(3, dtype=np.int64), np.zeros((3, 2), np.float32))
    with pytest.raises(KeyError, match="not resident"):
        c.gather(np.array([99]))


def test_stale_version_counts_as_miss():
    c = _cache(4, 2, min_gather_bucket=2)
    c.install(np.array([5]), np.ones((1, 2), np.float32), versions={5: 1})
    hit, miss = c.split(np.array([5]), {5: 1})
    assert hit.all() and miss.size == 0
    hit, miss = c.split(np.array([5]), {5: 2})
    assert not hit.any() and list(miss) == [5]
    assert c.version_of(5) == 1 and c.invalidate(np.array([5, 6])) == 1
    assert c.version_of(5) is None
    c.check_invariants()


@pytest.mark.parametrize("capacity,dim,gmin,imin,max_uniq", [
    (64, 3, 4, 4, 32), (100, 3, 64, 64, 100), (1 << 16, 17, 8192, 8, 53248),
    (48, 2, 8, 8, 200), (1000, 4, 256, 8, 777)])
def test_warmup_plan_and_reachable_buckets_equal_the_reference(
        capacity, dim, gmin, imin, max_uniq):
    kw = dict(min_gather_bucket=gmin, min_install_bucket=imin)
    c, j = _cache(1, dim, **kw), _jcache(1, dim, **kw)
    c.capacity = j.capacity = capacity     # the plans read the capacity only
    assert c.warmup_plan(max_uniq) == j.warmup_plan(max_uniq)
    assert c.reachable_buckets(max_uniq) == j.reachable_buckets(max_uniq)
    assert c.reachable_buckets(max_uniq) <= set(c.warmup_plan(max_uniq))


@pytest.mark.parametrize("capacity,gmin,sizes", [
    (64, 4, (1, 3, 4, 7, 12, 29, 32)), (100, 64, (70, 100, 65, 96))])
def test_zero_captures_after_warmup(capacity, gmin, sizes):
    c = _cache(capacity, 3, min_gather_bucket=gmin, min_install_bucket=gmin)
    c.warmup(max(sizes))
    assert c.graphs.builds == len(c.warmup_plan(max(sizes)))
    assert c.graphs.signatures() == set(c.warmup_plan(max(sizes)))
    before = recompile.capture_count()
    rng = np.random.default_rng(0)
    for n in sizes:
        ids = rng.choice(10_000, size=n, replace=False).astype(np.int64)
        c.install(ids, rng.normal(size=(n, 3)).astype(np.float32))
        c.gather(ids)
    assert recompile.capture_count() == before
    c.check_invariants()


# -- the randomized id stream --------------------------------------------------

def _drive_stream(make_store, make_channel, make_engine, steps=24):
    store = make_store()
    ch = make_channel(store)
    eng = make_engine(store, ch)
    rng = np.random.default_rng(42)
    served = []
    for step in range(steps):
        if step % 3 == 1:       # trainer pushes fresh values
            ids = rng.choice(40, size=4, replace=False)
            ch.push_rows(ids.astype(np.int64),
                         rng.normal(size=(4, 3)).astype(np.float32))
        hot = rng.integers(0, 8, size=(3, 2))
        tail = rng.integers(8, 60, size=(3, 2))
        ids = np.where(rng.random((3, 2)) < 0.7, hot, tail).astype(np.int64)
        out = np.asarray(eng.serve(ids))
        uniq = np.unique(ids)
        # max_lag_updates=0 drains the channel at submit: the served rows
        # are the store's as of the submit
        np.testing.assert_array_equal(out[:uniq.size], store.pull(uniq),
                                      err_msg=f"step {step}")
        eng.cache.check_invariants()
        served.append(out[:uniq.size])
    ch.stop()
    return served, eng


def test_id_stream_serves_the_stores_rows_and_the_jax_engines():
    kw = dict(capacity=32, min_bucket=8, max_lag_updates=0)
    port, eng = _drive_stream(
        lambda: _store(3),
        lambda s: es.StreamingUpdateChannel(s, registry=obs.MetricsRegistry()),
        lambda s, ch: _engine(s, channel=ch, **kw))
    ref, jeng = _drive_stream(
        lambda: _store(3, cls=JaxStore),
        lambda s: jes.StreamingUpdateChannel(
            s, registry=jobs.MetricsRegistry()),
        lambda s, ch: _jengine(s, channel=ch, **kw))
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    assert eng.cache._slot_of == jeng.cache._slot_of
    assert eng._reg.counter("embedding_cache_evictions_total").value() > 0


def test_eviction_never_serves_garbage():
    store = _store(dim=2)
    eng = _engine(store, capacity=4, min_bucket=4)
    rng = np.random.default_rng(7)
    for _ in range(40):
        ids = np.sort(rng.choice(8, size=3, replace=False)).astype(np.int64)
        served = eng.serve(ids.reshape(1, 3))
        np.testing.assert_array_equal(served[:3], store.pull(ids))
        eng.cache.check_invariants()


# -- the streaming channel -----------------------------------------------------

def test_pushed_row_served_by_the_next_lookup():
    store = _store(dim=3)
    ch = es.StreamingUpdateChannel(store, registry=obs.MetricsRegistry())
    eng = _engine(store, capacity=16, min_bucket=4, channel=ch,
                  max_lag_updates=0)
    ids = np.array([[1, 2, 3]], np.int64)
    eng.serve(ids)
    fresh = np.full((1, 3), 5.0, np.float32)
    ch.push_rows(np.array([2]), fresh)
    out = eng.serve(ids)
    np.testing.assert_array_equal(out[1], fresh[0])
    assert ch.version_of(2) == 1
    ch.stop()


def test_merge_last_writer_wins_and_grad_pushes_apply_the_optimizer():
    store = _store(dim=2)
    ch = es.StreamingUpdateChannel(store, registry=obs.MetricsRegistry())
    ch.push_rows(np.array([1, 2]), np.ones((2, 2), np.float32))
    ch.push_rows(np.array([1]), np.full((1, 2), 3.0, np.float32))
    ch.flush()
    np.testing.assert_array_equal(store.pull(np.array([1, 2])),
                                  [[3, 3], [1, 1]])
    ch.push_grads(np.array([2]), np.ones((1, 2), np.float32), lr=0.5)
    ch.flush()
    np.testing.assert_array_equal(store.pull(np.array([2])), [[0.5, 0.5]])
    # id 1's two pushes bump its version once if they merged, else twice
    assert ch.versions([2, 3]) == {2: 2, 3: 0}
    assert ch.version_of(1) in (1, 2)
    assert ch.drain_dirty() == {1, 2} and ch.drain_dirty() == set()
    ch.stop()


def test_lag_observability_and_worker_errors():
    store = _store(dim=2)
    ch = es.StreamingUpdateChannel(store, registry=obs.MetricsRegistry())
    assert ch.lag_seconds() == 0.0 and ch.lag_updates() == 0
    ch.push_rows(np.array([1]), np.zeros((1, 2), np.float32))
    ch.flush()
    assert ch.lag_seconds() == 0.0 and ch.lag_updates() == 0
    with pytest.raises(ValueError, match="vals shape"):
        ch.push_rows(np.array([1]), np.zeros((1, 3), np.float32))
    store.close()                       # the next apply fails
    ch.push_rows(np.array([1]), np.zeros((1, 2), np.float32))
    with pytest.raises(RuntimeError, match="worker failed"):
        ch.flush()
    ch.flush()                          # reported once
    ch.stop()


def test_staleness_bound_forces_a_drain():
    store = _store(dim=2)
    tr = obs.tracing.Tracer()
    ch = es.StreamingUpdateChannel(store, registry=obs.MetricsRegistry())
    eng = _engine(store, capacity=8, min_bucket=2, channel=ch,
                  max_staleness_s=0.0, tracer=tr)
    ch.push_rows(np.array([4]), np.full((1, 2), 2.0, np.float32))
    out = eng.serve(np.array([[4]], np.int64))
    np.testing.assert_array_equal(out[0], [2.0, 2.0])
    assert ch.lag_updates() == 0
    ch.stop()


# -- the engine ----------------------------------------------------------------

def test_load_shed_is_structured():
    eng = _engine(_store(dim=2), capacity=16, min_bucket=2, max_pending=2)
    eng.submit(np.array([[1]], np.int64))
    eng.submit(np.array([[2]], np.int64))
    with pytest.raises(es.EmbeddingLoadShedError) as ei:
        eng.submit(np.array([[3]], np.int64))
    rej = ei.value.reject
    assert rej.reason == "miss_queue_full" and rej.queue_depth == 2
    assert rej.retry_after_s > 0
    while eng.pending():
        eng.step()
    assert eng.submit(np.array([[3]], np.int64)) > 0
    eng.step()
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(np.arange(17, dtype=np.int64).reshape(1, 17))


def _capacity_pressure(store, eng):
    eng.serve(np.arange(10, 18, dtype=np.int64).reshape(1, 8))
    assert len(eng.cache) == 8                  # table full
    r1 = eng.submit(np.arange(0, 7, dtype=np.int64).reshape(1, 7))
    r2 = eng.submit(np.arange(10, 17, dtype=np.int64).reshape(1, 7))
    out = {}
    while eng.pending():
        out.update(eng.step())
    for rid, ids in ((r1, np.arange(0, 7)), (r2, np.arange(10, 17))):
        np.testing.assert_array_equal(out[rid][:7],
                                      store.pull(ids.astype(np.int64)))
    eng.cache.check_invariants()
    return [out[r1], out[r2]]


def test_capacity_retry_and_self_heal_equal_the_reference():
    tr = obs.tracing.Tracer()
    store = _store(dim=2)
    got = _capacity_pressure(store, _engine(store, capacity=8, min_bucket=2,
                                            max_pending=2, tracer=tr))
    jstore = _store(dim=2, cls=JaxStore)
    want = _capacity_pressure(jstore, _jengine(jstore, capacity=8,
                                               min_bucket=2, max_pending=2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    events = {e[1] for s in tr.spans("embed.request") for e in s.events}
    assert {"capacity_retry", "self_heal_repull"} <= events


def test_pipeline_results_pop_on_read():
    eng = _engine(_store(dim=2), capacity=64, min_bucket=8, max_pending=3)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, 100, size=(2, 3))) for _ in range(3)]
    outs = {}
    while eng.pending():
        outs.update(eng.step())
    assert sorted(outs) == sorted(rids)
    for r in rids:
        assert eng.result(r) is not None and eng.result(r) is None


def _models(fields=4, dim=4, hidden=(8, 8)):
    jm = JaxDeepFM(num_fields=fields, embed_dim=dim, hidden=hidden)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, params, DeepFMHostKV.from_jax(params, fields, device=CPU)


def _traffic(n=10, b=4, f=4, vocab=200, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(b, f)).astype(np.int64)
            for _ in range(n)]


@pytest.mark.parametrize("with_vals", [False, True])
def test_deepfm_probabilities_equal_the_jax_engine(with_vals):
    jm, params, pm = _models()
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    store, jstore = _store(5), _store(5, cls=JaxStore)
    ch = es.StreamingUpdateChannel(store, registry=reg)
    jch = jes.StreamingUpdateChannel(jstore, registry=jreg)
    kw = dict(capacity=64, min_bucket=8, max_lag_updates=0)
    eng = _engine(store, pm, channel=ch, registry=reg, **kw)
    jeng = _jengine(jstore, jm, params, channel=jch, registry=jreg, **kw)
    eng.warmup((4, 4), with_feat_vals=with_vals)
    before = recompile.capture_count()
    rng = np.random.default_rng(9)
    for i, ids in enumerate(_traffic()):
        if i % 4 == 2:
            pids = rng.choice(200, 3, replace=False).astype(np.int64)
            vals = rng.normal(size=(3, 5)).astype(np.float32)
            ch.push_rows(pids, vals)
            jch.push_rows(pids, vals)
        fv = rng.random((4, 4)).astype(np.float32) if with_vals else None
        got, want = eng.serve(ids, fv), np.asarray(jeng.serve(ids, fv))
        assert got.shape == (4,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert recompile.capture_count() == before
    assert reg.gauge("embedding_serving_hit_rate").value() > 0
    assert reg.gauge("embedding_serving_hit_rate").value() == \
        jreg.gauge("embedding_serving_hit_rate").value()
    ch.stop()
    jch.stop()


def test_warmup_plan_counts_the_captures_and_an_unwarmed_shape_shows():
    _, _, pm = _models()
    eng = _engine(_store(5), pm, capacity=64, min_bucket=8)
    before = recompile.capture_count()
    eng.warmup((4, 4))
    plan = eng.warmup_plan((4, 4))
    assert recompile.capture_count() - before == len(plan)
    assert eng.cache.graphs.signatures() == set(plan)
    assert ("forward", 16, 4, 4, False) in plan
    eng.recompile_detector.check()
    eng.serve(_traffic(1)[0])
    assert eng.recompile_detector.check() == 0
    eng.serve(_traffic(1, b=3)[0])            # (3, 4) was not warmed
    assert eng.recompile_detector.check() == 1
    assert eng.recompile_detector.recompiles == 1


class _SlowApplies:
    """The store as the channel sees it, each value push slowed, so that
    the next submit finds it pending and the staleness gate flushes."""

    def __init__(self, store):
        self._store, self.dim = store, store.dim

    def set_rows(self, ids, vals):
        time.sleep(0.05)
        self._store.set_rows(ids, vals)


def test_spans_and_metrics_are_named_as_the_jax_engines():
    jm, params, pm = _models()
    tr, jtr = obs.tracing.Tracer(), jobs.tracing.Tracer()
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    store, jstore = _store(5), _store(5, cls=JaxStore)
    ch = es.StreamingUpdateChannel(_SlowApplies(store), registry=reg,
                                   tracer=tr)
    jch = jes.StreamingUpdateChannel(_SlowApplies(jstore), registry=jreg,
                                     tracer=jtr)
    kw = dict(capacity=64, min_bucket=8, max_staleness_s=0.0, max_pending=2)
    eng = _engine(store, pm, channel=ch, registry=reg, tracer=tr, **kw)
    jeng = _jengine(jstore, jm, params, channel=jch, registry=jreg,
                    tracer=jtr, **kw)
    for e, c in ((eng, ch), (jeng, jch)):
        for ids in _traffic(3):
            c.push_rows(ids[0], np.zeros((4, 5), np.float32))
            e.serve(ids)
        e.submit(_traffic(1)[0])
        e.submit(_traffic(1)[0])
        with pytest.raises(Exception, match="load shed"):
            e.submit(_traffic(1)[0])
        while e.pending():
            e.step()
        c.stop()

    def names(t):
        return sorted({s.name for s in t.spans()})

    def events(t):
        return sorted({ev[1] for s in t.spans() for ev in s.events})

    assert names(tr) == names(jtr)
    assert {"embed.request", "embed.pull_wait", "embed.install",
            "embed.gather_forward", "embed.staleness_flush",
            "embed.stream_apply"} <= set(names(tr))
    assert events(tr) == events(jtr)
    assert sorted(m.name for m in reg.metrics()) == \
        sorted(m.name for m in jreg.metrics())


def test_facade():
    _, _, pm = _models(fields=3)
    eng = inference.make_embedding_serving_engine(
        _store(dim=5), pm, capacity=16, min_bucket=4,
        registry=obs.MetricsRegistry(), device=CPU)
    assert isinstance(eng, es.EmbeddingServingEngine)
    assert eng.serve(np.array([[1, 2, 3]], np.int64)).shape == (1,)


def test_the_engine_defaults_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        es.EmbeddingServingEngine(_store(2))


# -- snapshots -----------------------------------------------------------------

def _snapshot(pkg, store_cls, reg_cls, d, step):
    store = _store(dim=3, cls=store_cls)
    ch = pkg.StreamingUpdateChannel(store, registry=reg_cls())
    kw = dict(capacity=8, min_bucket=2, channel=ch, registry=reg_cls())
    eng = (_engine(store, **kw) if pkg is es
           else jes.EmbeddingServingEngine(store, **kw))
    eng.serve(np.array([[1, 2]], np.int64))
    ch.push_rows(np.array([2]), np.full((1, 3), 7.0, np.float32))
    ch.push_grads(np.array([1]), np.ones((1, 3), np.float32), lr=0.5)
    ch.flush()
    eng.snapshot(d, step=step)
    ch.stop()
    return store


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshots_restore_in_the_other_package(tmp_path, writer):
    d = str(tmp_path / "snaps")
    if writer == "port":
        src = _snapshot(es, HostKVStore, obs.MetricsRegistry, d, 5)
        store2 = _store(dim=3, cls=JaxStore, seed=99)
        ch2 = jes.StreamingUpdateChannel(store2,
                                         registry=jobs.MetricsRegistry())
        eng2 = _jengine(store2, capacity=8, min_bucket=2, channel=ch2)
        assert jes.committed_steps(d) == [5]
    else:
        src = _snapshot(jes, JaxStore, jobs.MetricsRegistry, d, 5)
        store2 = _store(dim=3, seed=99)
        ch2 = es.StreamingUpdateChannel(store2,
                                        registry=obs.MetricsRegistry())
        eng2 = _engine(store2, capacity=8, min_bucket=2, channel=ch2)
        assert es.committed_steps(d) == [5]
    eng2.serve(np.array([[1, 9]], np.int64))      # a resident row to drop
    versions = eng2.restore(d)
    assert versions == {1: 1, 2: 1}
    assert len(eng2.cache) == 0
    ids = np.array([1, 2], np.int64)
    np.testing.assert_array_equal(store2.pull(ids), src.pull(ids))
    assert ch2.version_of(2) == 1 and ch2.version_of(1) == 1
    np.testing.assert_array_equal(
        np.asarray(eng2.serve(ids.reshape(1, 2)))[:2], src.pull(ids))
    ch2.stop()


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_torn_saves_are_invisible_and_corrupt_ones_refused(tmp_path, reader):
    pkg, cls, err = ((es, HostKVStore, SnapshotCorruptionError)
                     if reader == "port" else
                     (jes, JaxStore, JaxCorrupt))
    writer = jes if reader == "port" else es
    store = _store(dim=2, cls=JaxStore if reader == "port" else HostKVStore)
    store.pull(np.arange(4, dtype=np.int64))
    d = os.path.join(tmp_path, "s")
    writer.save_kv_snapshot(store, d, 1)
    torn = os.path.join(d, "step_00000002")
    os.makedirs(torn)
    with open(os.path.join(torn, "table.kv"), "wb") as f:
        f.write(b"half a save")
    assert pkg.latest_valid_step(d) == 1
    writer.save_kv_snapshot(store, d, 3)
    with open(os.path.join(d, "step_00000003", "table.kv"), "r+b") as f:
        f.seek(0)
        f.write(b"\xff\xff\xff\xff")
    assert pkg.latest_valid_step(d) == 1
    with pytest.raises(err):
        pkg.restore_kv_snapshot(_store(dim=2, cls=cls), d, step=3)
    with pytest.raises(err, match="dim"):
        pkg.restore_kv_snapshot(_store(dim=3, cls=cls), d)
    fresh = _store(dim=2, cls=cls, seed=5)
    assert pkg.restore_kv_snapshot(fresh, d) == {}
    np.testing.assert_array_equal(fresh.pull(np.arange(4)),
                                  store.pull(np.arange(4)))
