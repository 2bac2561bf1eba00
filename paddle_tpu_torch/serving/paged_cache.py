"""Paged KV cache: fixed-size pages, block tables, and prefix sharing
(``paddle_tpu/serving/paged_cache.py``, fp page pools on one device).

K/V live in fixed-size *pages* shared by all slots; a host-side
allocator hands pages to slots as their sequences grow and reclaims them
the step a sequence finishes, so device memory scales with **live
tokens** (plus one page of rounding per slot).

Device state (torch tensors on ``device``, written in place):
  pages[layer] = (k_pages, v_pages), each (num_pages, page_size, H, Dh)
  int8 pools (``dtype=torch.int8``): pages[layer] = (k_pages, v_pages,
    k_scales, v_scales) — int8 pages plus fp32 per-token-row scales
    (num_pages, page_size) from :func:`quantize_kv`; a page's scale rows
    live under the same page id, so the allocator, prefix index, CoW and
    LRU need no change

Host state (plain numpy, mutated by the allocator):
  block_tables (num_slots, max_pages_per_slot) int32 — page ids, row-
    filled in sequence order; unused entries hold 0 (the null page)
  lengths      (num_slots,) int32 — live tokens per slot

Page 0 is the **null page**: never allocated, the write target for
masked/inactive lanes inside the fixed-shape steps, and the harmless
gather target for unused block-table entries.

Prefix sharing: pages are **refcounted**, and prompt prefixes are
published to a hash-chained index at *page* granularity once their
content has been prefilled. A new request whose prompt matches a
published chain maps those pages into its block table and skips
prefilling them. Rules that keep it exact:

- Only the *owner* (the slot that allocated a page) ever writes it; a
  borrowed page is read-only for the borrower.
- Matching is verified against the **stored tokens**, never the hash
  alone — a hash collision can cost a copy, never correctness.
- A borrowed *tail* page (partially filled) is replaced by a fresh
  **copy-on-write** page at reservation time, with a pending device
  copy (src -> dst) the engine performs before the slot's first write.
- At most ``len(prompt) - 1`` tokens are ever shared, so every request
  prefills at least one token — the one that produces its first output.
- A page whose refcount drops to zero while still published parks in an
  LRU **cached** pool: reusable by future matches, evicted (and
  unpublished) only when the allocator runs dry.

Host spill tier (``host_spill_pages > 0``): an evicted published full
page is first read to host memory through the engine's page reader
(:meth:`PagedKVCache.attach_spill_io`) and parked, sha256-stamped, in a
:class:`HostPagePool` keyed by its chain key; the engine restores it on
the next prefix hit and a peer can import it
(:meth:`PagedKVCache.lookup_prefix_page`).

The tensor-parallel page placement (and ``quantize_kv``'s
``psum_axis``) are later slices of the port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class PagedCacheConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    num_slots: int
    page_size: int = 16
    num_pages: int = 256
    max_pages_per_slot: int = 16
    dtype: torch.dtype = torch.float32
    share_prefix: bool = True

    def __post_init__(self):
        if self.page_size < 1 or self.num_pages < 2:
            raise ValueError("need page_size >= 1 and num_pages >= 2 "
                             "(page 0 is the reserved null page)")
        if self.max_pages_per_slot < 1:
            raise ValueError("max_pages_per_slot must be >= 1")

    @property
    def max_tokens_per_slot(self) -> int:
        return self.max_pages_per_slot * self.page_size

    @property
    def quantized(self) -> bool:
        """Int8 page storage with per-token-row fp32 scales."""
        return self.dtype == torch.int8

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


class PageOverflowError(RuntimeError):
    """No free pages (or slot capacity exceeded) for a reservation."""


#: abs-max floor so an all-zero token row gets a harmless tiny scale
#: instead of a division by zero (dequant of its zero int8 row is 0)
KV_SCALE_FLOOR = 1e-8


def quantize_kv(x: torch.Tensor, reduce_axes: Tuple[int, ...]):
    """Symmetric per-token int8 quantization of a K/V slab.

    ``x`` carries one K (or V) vector per token over its TRAILING
    ``reduce_axes`` (decode writes ``(S, H, Dh)`` with axes ``(1, 2)``;
    prefill writes ``(S, C, H, Dh)`` with axes ``(2, 3)``). Returns
    ``(q int8, scale f32)`` with ``scale = max(|x|, floor) / 127`` per
    token; dequantization is ``q * scale`` inside the attend kernels.
    Per-token scales keep page writes append-stable: a new token never
    requantizes rows already stored, so shared int8 pages stay
    bit-stable under prefix sharing and CoW. ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=reduce_axes)
    scale = amax.clamp(min=KV_SCALE_FLOOR) / 127.0
    exp = scale.reshape(scale.shape + (1,) * len(reduce_axes))
    q = torch.round(xf / exp).clamp(-127, 127).to(torch.int8)
    return q, scale


# The same root string as the reference, so that within one process the
# port's prefix digests equal the reference's (python ``hash`` is salted
# per interpreter: digests are in-process values only).
_ROOT_KEY = hash("paddle_tpu.serving.prefix_root")


def _chain(parent_key: int, chunk: np.ndarray) -> int:
    return hash((parent_key, chunk.tobytes()))


def _chain_walk(prompt, page_size: int, upto: int,
                key: int = _ROOT_KEY, start_page: int = 0):
    """Yield ``(page_index, chain_key, chunk)`` for each FULL page of
    ``prompt[:upto]`` starting at ``start_page``, chaining from ``key``.
    The one page-chain loop behind prefix matching, publication and
    :func:`prompt_prefix_digests`."""
    k = key
    p = start_page
    while (p + 1) * page_size <= upto:
        chunk = np.asarray(prompt[p * page_size:(p + 1) * page_size],
                           np.int32)
        k = _chain(k, chunk)
        yield p, k, chunk
        p += 1


def prompt_prefix_digests(prompt, page_size: int) -> List[int]:
    """Hash-chain keys of ``prompt``'s page-aligned full prefix pages —
    digest ``k`` covers tokens ``[0, (k+1)*page_size)``, capped at
    ``len(prompt) - 1`` tokens. Exactly the keys
    :meth:`PagedKVCache.publish_prefix` commits. In-process only."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    limit = int(prompt.shape[0]) - 1
    return [key for _p, key, _c in _chain_walk(prompt, page_size, limit)]


def payload_digest(payload: Tuple[np.ndarray, ...]) -> str:
    """sha256 over a spilled page's host arrays: the int8 KV and its fp32
    scale rows hash as one digest (a scale-only corruption is refused
    exactly like a KV corruption)."""
    h = hashlib.sha256()
    for a in payload:
        h.update(np.ascontiguousarray(a))        # the raw bytes, no copy
    return h.hexdigest()


@dataclasses.dataclass
class SpilledPage:
    """One published full page parked in host memory: its chain key, the
    stored token content (matches stay content-checked), the host copies
    of the page's device arrays (``(kv,)`` fp, ``(kv, scales)`` int8; a
    bf16 page's K/V as the uint16 view of its bits), and the sha256
    stamped at spill time that restore and export re-verify."""

    key: int
    tokens: np.ndarray
    payload: Tuple[np.ndarray, ...]
    sha256: str
    nbytes: int


class HostPagePool:
    """Host-memory LRU tier for spilled KV pages.

    When the device cached pool would evict (and destroy) a published
    page, its bytes land here instead, keyed by its prefix-chain digest;
    the next prefix hit restores it, and a peer's import can take it from
    here without touching the card. Bounded in pages: past ``capacity``
    the LRU entry is dropped. ``gen`` bumps on every mutation, so
    :attr:`PagedKVCache.prefix_gen` changes whenever the advertised set
    can. One lock guards the entries: a monitor thread may read
    ``keys()``/``len()`` while the step thread mutates them."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("HostPagePool needs capacity >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, SpilledPage]" = OrderedDict()
        self.gen = 0
        self.spilled_total = 0
        self.restored_total = 0
        self.dropped_total = 0
        self.spilled_bytes_total = 0
        self.restored_bytes_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> frozenset:
        with self._lock:
            return frozenset(self._entries)

    def entries(self) -> List[SpilledPage]:
        with self._lock:
            return list(self._entries.values())

    def spilled_bytes(self) -> int:
        """Host bytes resident right now."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def put(self, entry: SpilledPage):
        """Admit one spilled page as the most recently used; entries past
        capacity are dropped from the LRU end and counted."""
        with self._lock:
            self._entries[entry.key] = entry
            self._entries.move_to_end(entry.key)
            self.gen += 1
            self.spilled_total += 1
            self.spilled_bytes_total += entry.nbytes
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.dropped_total += 1
                self.gen += 1

    def get(self, key: int) -> Optional[SpilledPage]:
        """Peek (and LRU-touch) without removing."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
            return ent

    def pop(self, key: int) -> Optional[SpilledPage]:
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self.gen += 1
            return ent

    def discard(self, key: int):
        """Drop an entry that became device-resident again (restore, an
        import, or a fresh local publication of the same chain): the pool
        holds cold pages only, never a device duplicate."""
        self.pop(key)

    def note_restored(self, pages: int, nbytes: int):
        with self._lock:
            self.restored_total += pages
            self.restored_bytes_total += nbytes


class PagedKVCache:
    """Device pages + host-side page allocator, block tables, and the
    refcounted prefix-sharing index; ``host_spill_pages > 0`` adds the
    host spill tier (:class:`HostPagePool`)."""

    def __init__(self, config: PagedCacheConfig, device="cuda",
                 host_spill_pages: int = 0):
        self.config = c = config
        self.device = resolve_device(device)
        shape = (c.num_pages, c.page_size, c.num_heads, c.head_dim)
        sshape = (c.num_pages, c.page_size)

        def zeros(shp, dtype):
            return torch.zeros(shp, dtype=dtype, device=self.device)

        # one tuple per layer: (k, v) for fp pools, (k, v, k_scales,
        # v_scales) for int8 pools, so every page write, copy and read
        # walks one structure
        self.pages: List[Tuple[torch.Tensor, ...]] = [
            (zeros(shape, c.dtype), zeros(shape, c.dtype))
            + ((zeros(sshape, torch.float32), zeros(sshape, torch.float32))
               if c.quantized else ())
            for _ in range(c.num_layers)]
        self.block_tables = np.zeros((c.num_slots, c.max_pages_per_slot),
                                     np.int32)
        self.lengths = np.zeros((c.num_slots,), np.int32)
        # page 0 reserved: null page
        self._free = list(range(c.num_pages - 1, 0, -1))
        self._slot_pages: List[List[int]] = [[] for _ in range(c.num_slots)]
        # -- sharing state --
        self._ref = np.zeros((c.num_pages,), np.int32)   # mappers per page
        self._owned: List[set] = [set() for _ in range(c.num_slots)]
        self._cached: "OrderedDict[int, bool]" = OrderedDict()  # LRU, ref 0
        self._full_index: Dict[int, int] = {}    # chain key -> page id
        self._tail_index: Dict[int, int] = {}    # chain key -> tail page id
        self._page_pub: Dict[int, Tuple[str, int]] = {}  # pid -> (kind, key)
        self._page_tokens: Dict[int, np.ndarray] = {}    # published content
        self._published_upto: List[int] = [0] * c.num_slots
        # per-slot publish cursor: chain key covering the first
        # _published_upto // page_size pages, so each publish_prefix call
        # hashes only NEW pages
        self._pub_chain: List[int] = [_ROOT_KEY] * c.num_slots
        # slot -> (src, dst): device copy the engine owes before writing
        self._pending_copy: Dict[int, Tuple[int, int]] = {}
        # match memo keyed on (prompt identity, index generation): each
        # queued prompt is matched once per index change, not once per
        # admission pass; entries pin the array so its id stays unique
        self._index_gen = 0
        self._match_cache: "OrderedDict[Tuple[int, int], tuple]" = \
            OrderedDict()
        self._digests = frozenset()
        self._digests_gen = -1
        self.shared_tokens_total = 0     # prefill tokens skipped via sharing
        self.cow_copies_total = 0
        # host spill tier, off at 0 pages: _alloc_page parks an evicted
        # published page in the pool instead of destroying it, through the
        # engine's page reader (attach_spill_io)
        self.spill_pool: Optional[HostPagePool] = (
            HostPagePool(host_spill_pages) if host_spill_pages > 0
            else None)
        self._spill_reader: Optional[Callable] = None
        self._adv_digests = frozenset()
        self._adv_gen = -1

    # -- allocator --------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Pages immediately allocatable (free + evictable cached)."""
        return len(self._free) + len(self._cached)

    @property
    def pages_in_use(self) -> int:
        return int((self._ref[1:] > 0).sum())

    def utilization(self) -> float:
        """Live-token fraction of the allocatable page pool."""
        cap = (self.config.num_pages - 1) * self.config.page_size
        return float(self.lengths.sum()) / cap if cap else 0.0

    def bytes_per_page(self) -> int:
        """Device bytes one page id commits across every layer's K and V
        pools (plus the scale rows of an int8 pool)."""
        total = sum(t.numel() * t.element_size()
                    for layer in self.pages for t in layer)
        return total // self.config.num_pages

    def capacity_bytes(self) -> int:
        """Device bytes of the allocatable pool (null page excluded)."""
        return self.bytes_per_page() * (self.config.num_pages - 1)

    def live_bytes(self) -> int:
        """Device bytes committed to allocated pages right now (page
        granularity: a reservation counts the moment it is made)."""
        return self.bytes_per_page() * self.pages_in_use

    def _alloc_page(self) -> int:
        if self._free:
            return self._free.pop()
        if self._cached:     # evict the LRU published-but-idle page
            pid, _ = self._cached.popitem(last=False)
            self._spill_page(pid)
            self._unpublish(pid)
            return pid
        raise PageOverflowError("page pool exhausted")

    def attach_spill_io(self, reader: Callable):
        """Install the engine's page reader (``pid -> tuple of host
        arrays``). Spilling stays off until both a pool and a reader
        exist, so a bare cache (unit tests, draft caches) does no IO."""
        self._spill_reader = reader

    def _spill_page(self, pid: int):
        """Park an evicted published full page in the host pool (K/V and
        scale rows together, sha256-stamped) before ``_unpublish`` drops
        it. Tail pages are not spilled: at most ``page_size - 1`` tokens
        of recompute, and no prefix digest names them."""
        if self.spill_pool is None or self._spill_reader is None:
            return
        pub = self._page_pub.get(pid)
        if pub is None or pub[0] != "full":
            return
        payload = tuple(np.asarray(a) for a in self._spill_reader(pid))
        self.spill_pool.put(SpilledPage(
            key=pub[1], tokens=self._page_tokens[pid].copy(),
            payload=payload, sha256=payload_digest(payload),
            nbytes=sum(int(a.nbytes) for a in payload)))

    def _acquire(self, pid: int):
        """Take a reference on a published page (reviving it from the
        cached pool if idle)."""
        if pid in self._cached:
            del self._cached[pid]
        self._ref[pid] += 1

    def _release(self, pid: int):
        self._ref[pid] -= 1
        if self._ref[pid] < 0:
            raise AssertionError(f"page {pid} over-released")
        if self._ref[pid] == 0:
            if pid in self._page_pub:
                self._cached[pid] = True     # reusable via the index
            else:
                self._free.append(pid)

    def _unpublish(self, pid: int):
        kind, key = self._page_pub.pop(pid)
        index = self._full_index if kind == "full" else self._tail_index
        if index.get(key) == pid:
            del index[key]
        self._page_tokens.pop(pid, None)
        self._index_gen += 1

    # -- prefix matching --------------------------------------------------

    def _match_prefix(self, prompt: Optional[np.ndarray]):
        """Longest published, content-verified prefix of ``prompt``:
        ``(full_page_ids, (tail_src, n) or None, shared_tokens,
        key_after_full)``; sharing is capped at ``len(prompt) - 1``."""
        if prompt is None or not self.config.share_prefix:
            return [], None, 0, _ROOT_KEY
        mkey = (id(prompt), self._index_gen)
        hit = self._match_cache.get(mkey)
        if hit is not None and hit[0] is prompt:
            return hit[1]
        res = self._match_prefix_uncached(prompt)
        self._match_cache[mkey] = (prompt, res)
        while len(self._match_cache) > 512:
            self._match_cache.popitem(last=False)
        return res

    def _match_prefix_uncached(self, prompt: np.ndarray):
        ps = self.config.page_size
        limit = int(prompt.shape[0]) - 1
        key, k, full = _ROOT_KEY, 0, []
        for p, key2, chunk in _chain_walk(prompt, ps, limit):
            pid = self._full_index.get(key2)
            if pid is None or not np.array_equal(
                    self._page_tokens[pid], chunk):
                break
            full.append(pid)
            key, k = key2, p + 1
        shared = k * ps
        tail_pid = self._tail_index.get(key)
        if tail_pid is not None:
            stored = self._page_tokens[tail_pid]
            rem = np.asarray(prompt[shared:limit], np.int32)
            n = 0
            m = min(len(stored), len(rem))
            while n < m and stored[n] == rem[n]:
                n += 1
            if n > 0:
                return full, (tail_pid, n), shared + n, key
        return full, None, shared, key

    def can_reserve(self, n_tokens: int,
                    prompt: Optional[np.ndarray] = None) -> bool:
        need = self.config.pages_for(n_tokens)
        if need > self.config.max_pages_per_slot:
            return False
        full, _tail, _shared, _key = self._match_prefix(prompt)
        borrowed_cached = sum(1 for p in full if p in self._cached)
        fresh = need - len(full)
        # tail sharing is dropped by reserve() when pinning the CoW src
        # would not fit, so feasibility only needs the full-page math
        return fresh <= len(self._free) + len(self._cached) - borrowed_cached

    def reserve(self, slot: int, n_tokens: int,
                prompt: Optional[np.ndarray] = None) -> int:
        """Pre-allocate every page ``slot`` will need for ``n_tokens``
        total tokens (prompt + generation horizon). All-or-nothing, so
        an admitted request can never run out of pages mid-decode. With
        ``prompt`` given and sharing on, published prefix pages are
        mapped instead of allocated; returns the number of prompt tokens
        already covered (``lengths[slot]`` is set to it here)."""
        if self._slot_pages[slot]:
            raise PageOverflowError(f"slot {slot} already holds pages")
        need = self.config.pages_for(n_tokens)
        if need > self.config.max_pages_per_slot:
            raise PageOverflowError(
                f"{n_tokens} tokens needs {need} pages > max_pages_per_slot"
                f"={self.config.max_pages_per_slot}")
        full, tail, shared, chain_key = self._match_prefix(prompt)
        borrowed_cached = sum(1 for p in full if p in self._cached)
        fresh = need - len(full)
        if (tail is not None
                and fresh > len(self._free) + len(self._cached)
                - borrowed_cached
                - (1 if tail[0] in self._cached else 0)):
            # pinning the CoW src would leave too few evictable pages:
            # share the full pages only (the tail tokens get recomputed)
            tail, shared = None, len(full) * self.config.page_size
        if fresh > len(self._free) + len(self._cached) - borrowed_cached:
            raise PageOverflowError(
                f"{fresh} pages needed, {len(self._free)} free "
                f"+ {len(self._cached)} cached")
        mapped: List[int] = []
        owned = set()
        for pid in full:
            self._acquire(pid)
            mapped.append(pid)
        if tail is not None:
            # pin the CoW src BEFORE allocating fresh pages: _alloc_page
            # evicts from the cached pool when free runs dry, and the idle
            # published tail is exactly the kind of page it would recycle
            self._acquire(tail[0])
        for _ in range(fresh):
            pid = self._alloc_page()
            self._ref[pid] = 1
            owned.add(pid)
            mapped.append(pid)
        if tail is not None:
            src, _n = tail
            # the borrower appends into this page: a fresh CoW page takes
            # its place (already counted in ``fresh``) and a copy is owed
            self._pending_copy[slot] = (src, mapped[len(full)])
            self.cow_copies_total += 1
        self._slot_pages[slot] = mapped
        self._owned[slot] = owned
        self._published_upto[slot] = shared
        self._pub_chain[slot] = chain_key
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :need] = mapped
        self.lengths[slot] = shared
        self.shared_tokens_total += shared
        return shared

    def pending_copy(self, slot: int) -> Optional[Tuple[int, int]]:
        """(src, dst) device page copy the engine must perform before
        the slot's first write (CoW of a borrowed tail page)."""
        return self._pending_copy.get(slot)

    def copy_done(self, slot: int):
        src, _dst = self._pending_copy.pop(slot)
        self._release(src)

    def publish_prefix(self, slot: int, prompt: np.ndarray, upto: int):
        """Publish the slot's OWN prompt pages whose content has been
        prefilled through token ``upto``: full pages always; the partial
        tail page once the whole prompt is in. First publisher wins."""
        if not self.config.share_prefix:
            return
        ps = self.config.page_size
        upto = min(int(upto), int(prompt.shape[0]))
        if upto <= self._published_upto[slot]:
            return
        key = self._pub_chain[slot]
        k = self._published_upto[slot] // ps
        for p, key2, chunk in _chain_walk(prompt, ps, upto,
                                          key=key, start_page=k):
            pid = self._slot_pages[slot][p]
            if (key2 not in self._full_index and pid in self._owned[slot]
                    and pid not in self._page_pub):
                self._full_index[key2] = pid
                self._page_pub[pid] = ("full", key2)
                self._page_tokens[pid] = chunk.copy()
                self._index_gen += 1
                if self.spill_pool is not None:
                    # a fresh local prefill re-committed this chain key:
                    # the cold host copy is redundant
                    self.spill_pool.discard(key2)
            key, k = key2, p + 1
        self._pub_chain[slot] = key
        if upto >= int(prompt.shape[0]) and upto % ps:
            tail = np.asarray(prompt[k * ps:upto], np.int32)
            pid = self._slot_pages[slot][k]
            if (key not in self._tail_index and pid in self._owned[slot]
                    and pid not in self._page_pub):
                self._tail_index[key] = pid
                self._page_pub[pid] = ("tail", key)
                self._page_tokens[pid] = tail.copy()
                self._index_gen += 1
        self._published_upto[slot] = upto

    def writable(self, slot: int, page_index: int) -> bool:
        """True when the slot may write the page at this block-table
        position (it allocated it — borrowed pages are read-only)."""
        return self._slot_pages[slot][page_index] in self._owned[slot]

    def free_slot(self, slot: int):
        """Drop the slot's references; pages reach the free pool (or the
        cached pool, when published) only at refcount zero."""
        if slot in self._pending_copy:
            self.copy_done(slot)     # never materialized; release the src
        for pid in self._slot_pages[slot]:
            self._release(pid)
        self._slot_pages[slot] = []
        self._owned[slot] = set()
        self._published_upto[slot] = 0
        self._pub_chain[slot] = _ROOT_KEY
        self.block_tables[slot, :] = 0
        self.lengths[slot] = 0

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages[slot])

    @property
    def prefix_gen(self) -> int:
        """Monotonic generation over both publication tiers: bumps when
        the device index changes (publish, unpublish, adopt) and when the
        host spill pool changes (spill, restore, drop), so a reader of
        ``health()`` can tell that a prefix it saw advertised may be
        gone."""
        return self._index_gen + (self.spill_pool.gen
                                  if self.spill_pool is not None else 0)

    def published_digests(self) -> frozenset:
        """Full-page prefix digests resolvable through the index (live or
        parked in the cached pool); memoized on the index generation."""
        if self._digests_gen != self._index_gen:
            self._digests = frozenset(self._full_index)
            self._digests_gen = self._index_gen
        return self._digests

    # -- host spill tier --------------------------------------------------

    @property
    def idle_free_pages(self) -> int:
        """Pages allocatable without evicting a published cached page:
        the budget spill restores and imports spend."""
        return len(self._free)

    def advertised_digests(self) -> frozenset:
        """Device-published digests plus host-spilled ones (a spilled
        page is still servable: restored on a local hit, exported to a
        peer); memoized on :attr:`prefix_gen`."""
        if self.spill_pool is None:
            return self.published_digests()
        g = self.prefix_gen
        if self._adv_gen != g:
            self._adv_digests = (self.published_digests()
                                 | self.spill_pool.keys())
            self._adv_gen = g
        return self._adv_digests

    def spill_restore_plan(self, prompt) -> List[SpilledPage]:
        """The spilled full pages that would extend ``prompt``'s
        device-resident published chain, in chain order and
        content-verified like every match; stops at the first page held
        by neither tier, and at :attr:`idle_free_pages` (a restore never
        evicts)."""
        if (self.spill_pool is None or len(self.spill_pool) == 0
                or prompt is None or not self.config.share_prefix):
            return []
        ps = self.config.page_size
        limit = int(np.asarray(prompt).reshape(-1).shape[0]) - 1
        plan: List[SpilledPage] = []
        for _p, key, chunk in _chain_walk(prompt, ps, limit):
            pid = self._full_index.get(key)
            if pid is not None:
                if np.array_equal(self._page_tokens[pid], chunk):
                    continue
                break
            ent = self.spill_pool.get(key)
            if ent is None or not np.array_equal(ent.tokens, chunk):
                break
            plan.append(ent)
            if len(plan) >= len(self._free):
                break
        return plan

    def adopt_published_page(self, key: int, tokens) -> int:
        """Publish a page written from outside (a spill restore or an
        import): allocate it, commit it to the full-page index parked in
        the cached pool (refcount 0, so the next match borrows it like a
        local page), and drop any host copy of the key. Returns the page
        id; the caller owes the device write before its next cache
        operation."""
        pid = self._alloc_page()
        self._full_index[key] = pid
        self._page_pub[pid] = ("full", key)
        self._page_tokens[pid] = np.asarray(tokens, np.int32).copy()
        self._cached[pid] = True
        self._index_gen += 1
        if self.spill_pool is not None:
            self.spill_pool.discard(key)
        return pid

    def lookup_prefix_page(self, key: int):
        """Resolve one advertised digest for export: ``("device", pid,
        tokens)`` when resident, ``("host", SpilledPage)`` when spilled,
        None when this cache no longer holds it."""
        pid = self._full_index.get(key)
        if pid is not None:
            return ("device", pid, self._page_tokens[pid])
        if self.spill_pool is not None:
            ent = self.spill_pool.get(key)
            if ent is not None:
                return ("host", ent)
        return None

    def check_invariants(self):
        """Allocator self-check (tests): per-page refcount equals the
        number of mappings holding it, free/cached/live partition the
        pool, the null page is never owned, published entries resolve."""
        c = self.config
        expect = np.zeros((c.num_pages,), np.int32)
        for sp in self._slot_pages:
            for p in sp:
                expect[p] += 1
        for (src, _dst) in self._pending_copy.values():
            expect[src] += 1
        assert expect[0] == 0, "null page mapped"
        assert (expect == self._ref).all(), (
            f"refcount drift: {np.nonzero(expect != self._ref)[0]}")
        free_s, cached_s = set(self._free), set(self._cached)
        assert len(free_s) == len(self._free), "page double-freed"
        assert not (free_s & cached_s), "page both free and cached"
        assert 0 not in free_s and 0 not in cached_s, "null page pooled"
        live = {int(p) for p in np.nonzero(self._ref)[0]}
        assert not (live & (free_s | cached_s)), "live page in a pool"
        assert free_s | cached_s | live == set(range(1, c.num_pages)), \
            "page leaked"
        for pid, (kind, key) in self._page_pub.items():
            index = self._full_index if kind == "full" else self._tail_index
            assert index.get(key) == pid, "publication index drift"
            assert pid in self._page_tokens, "published page lost tokens"
        for owned, sp in zip(self._owned, self._slot_pages):
            assert owned <= set(sp), "owned page not mapped"
        if self.spill_pool is not None:
            spilled = self.spill_pool.keys()
            assert len(self.spill_pool) <= self.spill_pool.capacity, \
                "host spill pool over capacity"
            assert not (spilled & set(self._full_index)), \
                "page both device-published and host-spilled"
            for ent in self.spill_pool.entries():
                assert payload_digest(ent.payload) == ent.sha256, \
                    "spilled page payload corrupted in host pool"
