"""The port's paged KV cache: allocator, refcounted prefix sharing with
copy-on-write tails, and the prefix digests — the last held equal to the
JAX package's in the same process (python ``hash`` is salted per
interpreter, so digests only compare within one process)."""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import paged_cache as jax_cache
from paddle_tpu_torch.serving.paged_cache import (PagedCacheConfig,
                                                  PagedKVCache,
                                                  PageOverflowError,
                                                  prompt_prefix_digests)

torch.set_num_threads(2)


def _cache(**kw):
    kw.setdefault("num_layers", 1)
    kw.setdefault("num_heads", 2)
    kw.setdefault("head_dim", 4)
    kw.setdefault("num_slots", 3)
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 10)
    kw.setdefault("max_pages_per_slot", 4)
    return PagedKVCache(PagedCacheConfig(**kw), device="cpu")


def test_pages_are_torch_tensors_on_the_device():
    c = _cache(dtype=torch.bfloat16)
    assert len(c.pages) == 1
    kp, vp = c.pages[0]
    assert kp.shape == vp.shape == (10, 4, 2, 4)
    assert kp.dtype == torch.bfloat16 and kp.device.type == "cpu"


def test_reserve_free_roundtrip_and_reuse():
    c = _cache()
    c.reserve(0, 9)     # 3 pages
    c.reserve(1, 4)     # 1 page
    assert c.pages_in_use == 4
    assert 0 not in c.block_tables[0, :3]
    c.check_invariants()
    first = set(c.slot_pages(0))
    c.free_slot(0)
    assert c.pages_in_use == 1
    assert (c.block_tables[0] == 0).all()
    c.reserve(2, 9)
    assert set(c.slot_pages(2)) == first
    c.check_invariants()


def test_overflow_refused_all_or_nothing():
    c = _cache()
    c.reserve(0, 16)
    c.reserve(1, 16)
    free_before = c.free_pages
    assert not c.can_reserve(8)
    with pytest.raises(PageOverflowError):
        c.reserve(2, 8)
    assert c.free_pages == free_before  # nothing leaked
    with pytest.raises(PageOverflowError):
        c.reserve(2, 17)                # > max_pages_per_slot
    c.check_invariants()
    c.reserve(2, 4)
    assert 0 not in [p for s in range(3) for p in c.slot_pages(s)]
    c.lengths[2] = 4
    assert c.utilization() == pytest.approx(4 / (9 * 4))


def test_randomized_admit_publish_cow_free_invariants():
    """Randomized reserve / publish / CoW-resolve / free interleavings
    over a small pool of recurring prompts: pages never leak, never
    double-free, refcounts always equal the live mapping count."""
    rng = np.random.default_rng(22)
    c = _cache(num_slots=4, num_pages=14)
    pool = [rng.integers(1, 9, n).astype(np.int32)
            for n in (6, 9, 10, 13, 10)]
    pool.append(pool[2].copy())          # exact duplicate
    live, cows = {}, 0
    for _step in range(400):
        op = rng.random()
        free_slots = [s for s in range(4) if s not in live]
        if op < 0.5 and free_slots:
            slot = int(rng.choice(free_slots))
            prompt = pool[int(rng.integers(len(pool)))]
            total = len(prompt) + int(rng.integers(1, 4))
            try:
                shared = c.reserve(slot, total, prompt=prompt)
            except PageOverflowError:
                c.check_invariants()
                continue
            assert 0 <= shared < len(prompt)
            live[slot] = (prompt, shared)
        elif op < 0.7 and live:
            slot = int(rng.choice(list(live)))
            if c.pending_copy(slot) is not None:
                c.copy_done(slot)        # the engine would device-copy
                cows += 1
            prompt, shared = live[slot]
            upto = int(rng.integers(shared, len(prompt) + 1))
            c.publish_prefix(slot, prompt, upto)
        elif live:
            slot = int(rng.choice(list(live)))
            c.free_slot(slot)
            del live[slot]
        c.check_invariants()
    for slot in list(live):
        c.free_slot(slot)
    c.check_invariants()
    assert c.pages_in_use == 0, "pages leaked"
    assert cows > 0 and c.shared_tokens_total > 0


def test_cow_src_survives_fresh_allocation_under_pressure():
    def seeded(num_pages):
        c = _cache(num_slots=2, num_pages=num_pages, max_pages_per_slot=3)
        p = np.arange(1, 7, dtype=np.int32)   # 1 full page + 2 tail
        c.reserve(0, 6, prompt=p)
        c.publish_prefix(0, p, 6)
        c.free_slot(0)                        # both idle in the cached pool
        return c, p

    c, p = seeded(5)
    assert c.reserve(1, 10, prompt=p.copy()) == 5
    src, dst = c.pending_copy(1)
    assert src in c._page_pub and src not in c._owned[1] and src != dst
    c.copy_done(1)
    c.check_invariants()
    # tight pool: pinning the tail would starve the fresh pages, so the
    # share degrades to the full page only
    c, p = seeded(4)
    assert c.can_reserve(10, prompt=p)
    assert c.reserve(1, 10, prompt=p.copy()) == 4
    assert c.pending_copy(1) is None
    c.check_invariants()


def test_cached_pages_evicted_when_pool_runs_dry():
    c = _cache(num_slots=2, num_pages=5)
    prompt = np.arange(1, 9, dtype=np.int32)       # 2 full pages
    c.reserve(0, 10, prompt=prompt)                # 3 pages
    c.publish_prefix(0, prompt, 8)
    c.free_slot(0)
    assert c.pages_in_use == 0 and len(c._cached) == 2
    c.reserve(1, 16)                               # needs all 4 pages
    c.check_invariants()
    assert c.pages_in_use == 4
    assert not c._full_index, "evicted pages still published"


@pytest.mark.parametrize("n", [1, 4, 5, 9, 16, 17])
def test_prompt_prefix_digests_equal_the_reference(n):
    prompt = np.random.default_rng(n).integers(0, 100, n).astype(np.int32)
    for ps in (1, 4, 8):
        ours = prompt_prefix_digests(prompt, ps)
        assert ours == jax_cache.prompt_prefix_digests(prompt, ps)
        assert len(ours) == (n - 1) // ps


def test_published_digests_equal_the_reference_after_the_same_traffic():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 6, n).astype(np.int32) for n in (9, 13, 6)]
    cfg = dict(num_layers=1, num_heads=2, head_dim=4, num_slots=3,
               page_size=4, num_pages=16, max_pages_per_slot=5)
    ours = PagedKVCache(PagedCacheConfig(**cfg), device="cpu")
    ref = jax_cache.PagedKVCache(jax_cache.PagedCacheConfig(**cfg))
    for slot, p in enumerate(prompts):
        assert ours.reserve(slot, len(p) + 2, prompt=p) == \
            ref.reserve(slot, len(p) + 2, prompt=p)
        ours.publish_prefix(slot, p, len(p))
        ref.publish_prefix(slot, p, len(p))
    assert ours.published_digests() == ref.published_digests()
    assert (ours.block_tables == ref.block_tables).all()
    assert set(ours.published_digests()) >= set(
        prompt_prefix_digests(prompts[1], 4))
