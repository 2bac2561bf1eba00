"""The port's host KV store (``paddle_tpu_torch.parallel.host_kv`` over its
own ``native/kv_store.cc``) against the reference's: the same rows from
the same seed, the same bits after sgd and adagrad pushes (sync and
async), each package's ``kv_save`` files loading in the other, the
batch orchestration's dedup, padding and buckets, and ``fits_hbm``."""

import numpy as np
import pytest
import torch

from paddle_tpu.parallel import host_kv as jax_kv
from paddle_tpu_torch import native
from paddle_tpu_torch.parallel import host_kv as kv

IDS = np.array([1, 7, 1 << 40, 3, 99, 12345678901], np.int64)


def _pair(dim=5, **kw):
    kw.setdefault("optimizer", "sgd")
    kw.setdefault("init_scale", 0.1)
    kw.setdefault("seed", 3)
    return kv.HostKVStore(dim, **kw), jax_kv.HostKVStore(dim, **kw)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("seed", [0, 3])
def test_lazy_rows_equal_the_reference_bit_for_bit(optimizer, seed):
    port, ref = _pair(optimizer=optimizer, seed=seed)
    np.testing.assert_array_equal(port.pull(IDS), ref.pull(IDS))
    assert len(port) == len(ref) == IDS.size
    other = kv.HostKVStore(5, optimizer=optimizer, init_scale=0.1,
                           seed=seed + 1)
    assert not np.array_equal(port.pull(IDS), other.pull(IDS))
    assert np.abs(port.pull(IDS)).max() <= 0.1


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("wait", [True, False])
def test_pushes_leave_the_reference_bits(optimizer, wait):
    port, ref = _pair(dim=4, optimizer=optimizer, init_scale=0.05)
    rng = np.random.default_rng(0)
    for _ in range(5):
        ids = np.unique(rng.integers(0, 40, size=(16,))).astype(np.int64)
        g = rng.normal(size=(ids.size, 4)).astype(np.float32)
        port.push(ids, g, lr=0.1, wait=wait)
        ref.push(ids, g, lr=0.1, wait=wait)
        if not wait:
            port.flush()
            ref.flush()
    every = np.arange(40, dtype=np.int64)
    np.testing.assert_array_equal(port.pull(every), ref.pull(every))


def test_adagrad_push_matches_numpy():
    s = kv.HostKVStore(3, optimizer="adagrad", init_scale=0.0)
    ids = np.array([42], np.int64)
    w = np.zeros((1, 3), np.float32)
    acc = np.zeros((1, 3), np.float32)
    rng = np.random.default_rng(0)
    for _ in range(4):
        g = rng.normal(size=(1, 3)).astype(np.float32)
        s.push(ids, g, lr=0.1)
        acc += g * g
        w -= 0.1 * g / (np.sqrt(acc) + 1e-8)
    np.testing.assert_allclose(s.pull(ids), w, rtol=1e-5, atol=1e-6)


def test_async_pull_into_a_padded_buffer_and_set_rows():
    port, ref = _pair(dim=3)
    out = np.zeros((8, 3), np.float32)
    h = port.pull_async(IDS, out=out)
    got = h.wait()
    assert got is out
    np.testing.assert_array_equal(out[:IDS.size], ref.pull(IDS))
    assert not out[IDS.size:].any()
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    port.set_rows(IDS[:2], vals)
    np.testing.assert_array_equal(port.pull(IDS[:2]), vals)
    with pytest.raises(ValueError, match="out buffer"):
        port.pull(IDS, out=np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="grads shape"):
        port.push(IDS, np.zeros((1, 3), np.float32), lr=0.1)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_kv_save_files_load_in_the_other_package(tmp_path, writer):
    port, ref = _pair(dim=4, optimizer="adagrad")
    src = port if writer == "port" else ref
    src.push(IDS, np.ones((IDS.size, 4), np.float32), lr=0.2)
    path = str(tmp_path / "table.kv")
    src.save(path)
    fresh = (jax_kv.HostKVStore if writer == "port" else kv.HostKVStore)(
        4, optimizer="adagrad", init_scale=0.1, seed=9)
    fresh.load(path)
    assert len(fresh) == IDS.size
    np.testing.assert_array_equal(fresh.pull(IDS), src.pull(IDS))
    # the optimizer slots came across too: one more push agrees
    g = np.full((IDS.size, 4), 0.5, np.float32)
    fresh.push(IDS, g, lr=0.2)
    src.push(IDS, g, lr=0.2)
    np.testing.assert_array_equal(fresh.pull(IDS), src.pull(IDS))


def test_load_refuses_a_dim_mismatch(tmp_path):
    port, _ = _pair(dim=4)
    port.pull(IDS)
    path = str(tmp_path / "t.kv")
    port.save(path)
    with pytest.raises(IOError, match="mismatch"):
        kv.HostKVStore(5, optimizer="sgd").load(path)


def test_close_is_idempotent_and_a_closed_store_raises():
    s = kv.HostKVStore(2)
    s.close()
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.pull(IDS)


def test_del_is_safe_when_the_library_fails_to_load(monkeypatch):
    def boom():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(kv, "_lib", boom)
    with pytest.raises(RuntimeError, match="no compiler"):
        kv.HostKVStore(3)
    s = kv.HostKVStore.__new__(kv.HostKVStore)
    s.close()          # nothing loaded: no AttributeError
    s.__del__()


@pytest.mark.parametrize("min_bucket", [4, 16])
def test_embedding_dedup_padding_and_buckets_equal_the_reference(min_bucket):
    port, ref = _pair(dim=3)
    pe = kv.HostKVEmbedding(port, lr=0.1, min_bucket=min_bucket)
    je = jax_kv.HostKVEmbedding(ref, lr=0.1, min_bucket=min_bucket)
    rng = np.random.default_rng(1)
    for n in (2, 5, 9, 30):
        ids = rng.integers(0, 50, size=(n, 3)).astype(np.int64)
        a, b = pe.lookup_batch(ids), je.lookup_batch(ids)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert a.uniq.size >= min_bucket
        assert (a.uniq.size & (a.uniq.size - 1)) == 0
        np.testing.assert_array_equal(a.rows[a.inv], port.pull(ids.ravel())
                                      .reshape(n, 3, 3))
        pf, jf = pe.prefetch_batch(ids).wait(), je.prefetch_batch(ids).wait()
        for x, y in zip(pf, jf):
            np.testing.assert_array_equal(x, y)
        g = rng.normal(size=a.rows.shape).astype(np.float32)
        pe.apply_grads(a, torch.from_numpy(g))
        je.apply_grads(b, g)
    every = np.arange(50, dtype=np.int64)
    np.testing.assert_array_equal(port.pull(every), ref.pull(every))


def test_apply_grads_skips_padding():
    s = kv.HostKVStore(2, optimizer="sgd", init_scale=0.0)
    e = kv.HostKVEmbedding(s, lr=1.0, min_bucket=8)
    sb = e.lookup_batch(np.array([[5, 6]], np.int64))
    e.apply_grads(sb, np.ones((8, 2), np.float32))
    assert len(s) == 2
    np.testing.assert_array_equal(s.pull(np.array([5, 6])), -1.0)


@pytest.mark.parametrize("vocab,dim,budget", [
    (1000, 16, 1 << 20), (10 ** 6, 64, 1 << 30), (10 ** 8, 64, 16 << 30),
    (2_000_000, 17, 1 << 20)])
def test_fits_hbm_equals_the_reference(vocab, dim, budget):
    assert kv.fits_hbm(vocab, dim, budget_bytes=budget) == \
        jax_kv.fits_hbm(vocab, dim, budget_bytes=budget)
    assert kv.fits_hbm(vocab, dim, budget_bytes=budget, optimizer_slots=0) \
        == jax_kv.fits_hbm(vocab, dim, budget_bytes=budget,
                           optimizer_slots=0)


def test_native_library_is_named_by_its_sources_and_flags():
    a = native.library_path("kvstore", ["kv_store.cc"])
    assert a == native.library_path("kvstore", ["kv_store.cc"])
    assert a != native.library_path("kvstore", ["kv_store.cc"], ["-g"])
    assert a.parent == native.BUILD_DIR
    kv.HostKVStore(2).close()
    assert a.exists()
