"""Device-resident hot-row cache over a beyond-HBM embedding table
(``paddle_tpu/embedding_serving/device_cache.py``).

The full sparse table (millions of ids) lives in a host or remote KV
store; the card holds a fixed-shape table of ``capacity`` hot rows plus a
host-side id -> slot index. A batch lookup becomes

  uniq ids  ->  split into resident hits / misses (host dict probes)
  misses    ->  pulled from the backing store, installed by ONE bucketed
                ``table.index_copy_(0, slots, rows)``, in place
  all uniq  ->  ONE bucketed fixed-width ``table.index_select(0, slots)``
                giving the padded (U_pad, dim) rows the model consumes

**On the card.** The table is one ``(capacity + 1, dim)`` tensor,
allocated once: its storage never changes, every install writes into it.
Each install width and each gather width is one captured CUDA graph
(:mod:`~paddle_tpu_torch.embedding_serving.graphs`) over static slot and
row tensors that the host fills before a replay, so the number of graphs
is O(log max_batch_uniq) and :meth:`warmup` captures them all: steady
state captures nothing (RecompileDetector-checked, as the reference
checks its compiles). On the CPU the same calls run eagerly.

Slot 0 is the null slot: gather padding lanes read it and install
padding lanes write zero rows to it (duplicate writes of one value, so
their order is moot; real slots are distinct), so a ragged count never
changes a shape. No real id maps to it.

The host index costs per id, not per Python statement: the id -> slot map
is one dict kept with C-level ``update(zip(...))`` bulk operations, and
the eviction policy (``lru``, least recently served, or ``lfu``, least
frequently served with an LRU tiebreak) lives in slot-indexed numpy
arrays: touching a 10k-id batch is two vectorized writes, and choosing
victims one partition over the used slots.

No store dependency: the :class:`~paddle_tpu_torch.embedding_serving.
engine.EmbeddingServingEngine` mediates pulls and pushes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.embedding_serving.graphs import CallGraphs


def _pow2_bucket(n: int, minimum: int, cap: int) -> int:
    b = max(int(minimum), 1)
    while b < n:
        b *= 2
    # the cap itself rounds up to a power of two: a raw (possibly
    # non-pow2) capacity would mint a serve-time width that warmup()'s
    # doubling never built
    c = 1
    while c < cap:
        c *= 2
    return min(b, c)


class CacheCapacityError(RuntimeError):
    """A batch references more unique ids than the device table holds:
    the fixed-width gather cannot serve it. Size ``capacity`` to at least
    the per-batch unique-id high-water mark."""


class DeviceEmbeddingCache:
    """Fixed-shape device table of hot rows plus a host id -> slot index.

    ``capacity`` device rows (plus the null slot), ``dim`` values each, of
    ``dtype`` (float32 by default; bf16 allowed). ``device`` defaults to
    CUDA and raises without a card unless ``device="cpu"`` is given."""

    def __init__(self, capacity: int, dim: int, *, dtype=None,
                 policy: str = "lru", min_gather_bucket: int = 256,
                 min_install_bucket: int = 8, registry=None,
                 device="cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if policy not in ("lru", "lfu"):
            raise ValueError(f"policy must be 'lru' or 'lfu', "
                             f"got {policy!r}")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.policy = policy
        self.min_gather_bucket = int(min_gather_bucket)
        self.min_install_bucket = int(min_install_bucket)
        self.dtype = dtype or torch.float32
        self.device = resolve_device(device)
        # slot 0 = null; real slots 1..capacity
        self.table = torch.zeros((self.capacity + 1, self.dim),
                                 dtype=self.dtype, device=self.device)
        self.graphs = CallGraphs(self.device)
        self._slot_of: Dict[int, int] = {}
        self._id_of = np.full((self.capacity + 1,), -1, np.int64)
        self._free = list(range(self.capacity, 0, -1))  # pop() -> slot 1 last
        # slot-indexed policy books (vectorized touch/evict)
        self._slot_last = np.full((self.capacity + 1,), -1, np.int64)
        self._slot_freq = np.zeros((self.capacity + 1,), np.int64)
        self._tick = 0
        self._version: Dict[int, int] = {}
        self.warmed_buckets: set = set()      # filled by warmup()

        from paddle_tpu_torch import observability as obs
        self._reg = registry or obs.default()
        self._hits = self._reg.counter(
            "embedding_cache_hits_total", "id lookups served from HBM")
        self._misses = self._reg.counter(
            "embedding_cache_misses_total",
            "id lookups that pulled from the store")
        self._evictions = self._reg.counter(
            "embedding_cache_evictions_total", "rows evicted from HBM")

    # -- device calls -----------------------------------------------------

    def _install_call(self, b: int, slots: np.ndarray, rows: np.ndarray):
        table = self.table

        def fn(slots, rows):
            table.index_copy_(0, slots, rows)

        self.graphs.run(("install", b), {"slots": slots, "rows": rows},
                        {"slots": ((b,), torch.int64),
                         "rows": ((b, self.dim), self.dtype)}, fn)

    def _gather_call(self, b: int, slots: np.ndarray) -> torch.Tensor:
        table = self.table

        def fn(slots):
            return table.index_select(0, slots)

        return self.graphs.run(("gather", b), {"slots": slots},
                               {"slots": ((b,), torch.int64)}, fn)

    # -- index ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._slot_of)

    def resident(self, id_: int) -> bool:
        return int(id_) in self._slot_of

    def version_of(self, id_: int) -> Optional[int]:
        """Version recorded when ``id_``'s row was installed (None when
        not resident)."""
        return self._version.get(int(id_))

    def split(self, uniq_ids: np.ndarray,
              current_versions: Optional[Dict[int, int]] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Partition ``uniq_ids`` into (hit_mask, miss_ids). A resident
        row whose installed version is behind ``current_versions[id]``
        counts as a MISS (stale: the streaming refresh path): the caller
        re-pulls it and ``install`` overwrites the same slot."""
        ids = uniq_ids.tolist()
        probe = self._slot_of
        if current_versions is None:
            hit = np.fromiter((i in probe for i in ids), bool,
                              uniq_ids.size)
        else:
            ver = self._version
            hit = np.fromiter(
                ((i in probe
                  and ver.get(i, 0) >= current_versions.get(i, 0))
                 for i in ids), bool, uniq_ids.size)
        return hit, uniq_ids[~hit]

    # -- eviction ---------------------------------------------------------

    def _victim_slots(self, n: int, protect: set) -> np.ndarray:
        """Slots of the ``n`` policy-best victims, never a ``protect``-ed
        id. LRU partitions the slot-tick array (protected ids were served
        recently, so the first window of the oldest almost always
        suffices); LFU pays one lexsort."""
        cand = np.flatnonzero(self._id_of >= 0)
        if self.policy == "lfu":
            order = cand[np.lexsort((self._slot_last[cand],
                                     self._slot_freq[cand]))]
            ids = self._id_of[order]
            keep = np.fromiter((int(i) not in protect
                                for i in ids.tolist()), bool, ids.size)
            sel = order[keep][:n]
            if sel.size < n:
                raise CacheCapacityError(
                    f"need {n} free slots but only {sel.size} evictable "
                    f"(capacity {self.capacity}, protected "
                    f"{len(protect)}) — batch uniq ids exceed capacity")
            return sel
        k = min(n + 256, cand.size)
        while True:
            part = cand[np.argpartition(self._slot_last[cand],
                                        k - 1)[:k]] \
                if k < cand.size else cand
            part = part[np.argsort(self._slot_last[part],
                                   kind="stable")]   # oldest first
            ids = self._id_of[part]
            keep = np.fromiter((int(i) not in protect
                                for i in ids.tolist()), bool, ids.size)
            sel = part[keep][:n]
            if sel.size >= n:
                return sel
            if k >= cand.size:
                raise CacheCapacityError(
                    f"need {n} free slots but only {sel.size} evictable "
                    f"(capacity {self.capacity}, protected "
                    f"{len(protect)}) — batch uniq ids exceed capacity")
            k = min(k * 2, cand.size)

    def invalidate(self, ids: np.ndarray) -> int:
        """Drop ids from the index (their next lookup is a miss). Their
        device rows stay as garbage in now-free slots, unreachable through
        the index. Returns the rows dropped."""
        dropped = []
        for id_ in np.asarray(ids, np.int64).ravel().tolist():
            slot = self._slot_of.pop(id_, None)
            if slot is None:
                continue
            dropped.append(slot)
            self._version.pop(id_, None)
        if dropped:
            s = np.asarray(dropped, np.int64)
            self._id_of[s] = -1
            self._slot_last[s] = -1
            self._slot_freq[s] = 0
            self._free.extend(s.tolist())
        return len(dropped)

    # -- update / serve ---------------------------------------------------

    def install(self, miss_ids: np.ndarray, rows: np.ndarray,
                versions: Optional[Dict[int, int]] = None,
                protect: Optional[Iterable[int]] = None):
        """Write pulled rows into the device table with one bucketed
        ``index_copy_``. Resident ids are refreshed in their slot; new ids
        take free slots, evicting policy victims (never ``protect``, which
        defaults to the install set itself) when none are free."""
        miss_ids = np.asarray(miss_ids, np.int64).ravel()
        if miss_ids.size == 0:
            return
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.shape[0] < miss_ids.size or rows.shape[1] != self.dim:
            raise ValueError(f"rows {rows.shape} cannot cover "
                             f"({miss_ids.size}, {self.dim})")
        ids = miss_ids.tolist()
        slots = np.fromiter((self._slot_of.get(i, 0) for i in ids),
                            np.int64, miss_ids.size)
        fresh = slots == 0              # not resident yet
        need = int(fresh.sum())
        short = need - len(self._free)
        if short > 0:
            # evict by reassignment: drop the victims' index entries and
            # hand their slots straight to the new ids
            vslots = self._victim_slots(
                short, set(ids) | set(int(p) for p in (protect or ())))
            spop, vpop = self._slot_of.pop, self._version.pop
            for old in self._id_of[vslots].tolist():
                spop(old)
                vpop(old, None)
            self._free.extend(vslots.tolist())
            self._id_of[vslots] = -1
            self._slot_last[vslots] = -1
            self._slot_freq[vslots] = 0
            self._evictions.inc(int(vslots.size))
        if need:
            new_slots = np.asarray(self._free[-need:], np.int64)
            del self._free[-need:]
            new_ids = miss_ids[fresh]
            slots[fresh] = new_slots
            self._slot_of.update(
                zip(new_ids.tolist(), new_slots.tolist()))
            self._id_of[new_slots] = new_ids
            self._slot_freq[new_slots] = 0
        self._tick += 1
        self._slot_last[slots] = self._tick
        if versions is not None:
            self._version.update(
                (i, versions.get(i, 0)) for i in ids)
        else:
            ver = self._version
            self._version.update((i, ver.get(i, 0)) for i in ids)
        b = _pow2_bucket(miss_ids.size, self.min_install_bucket,
                         max(self.capacity, miss_ids.size))
        slots_p = np.zeros((b,), np.int64)            # pad -> null slot
        rows_p = np.zeros((b, self.dim), np.float32)
        slots_p[:miss_ids.size] = slots
        rows_p[:miss_ids.size] = rows[:miss_ids.size]
        self._install_call(b, slots_p, rows_p)

    def lookup_slots(self, uniq_ids: np.ndarray, *,
                     pad_to: Optional[int] = None) -> np.ndarray:
        """The padded ``(U_pad,)`` int64 slots of ``uniq_ids`` (padding
        lanes: the null slot), every id resident (``install`` misses
        first). Advances the eviction policy (serve == touch)."""
        uniq_ids = np.asarray(uniq_ids, np.int64).ravel()
        b = pad_to or _pow2_bucket(uniq_ids.size, self.min_gather_bucket,
                                   max(self.capacity, uniq_ids.size))
        if uniq_ids.size > b:
            raise CacheCapacityError(
                f"{uniq_ids.size} uniq ids > gather width {b}")
        try:
            used = np.fromiter(
                (self._slot_of[i] for i in uniq_ids.tolist()),
                np.int64, uniq_ids.size)
        except KeyError as e:
            raise KeyError(
                f"id {e.args[0]} not resident (install first)") from None
        self._tick += 1
        self._slot_last[used] = self._tick
        self._slot_freq[used] += 1      # uniq ids: no duplicate slots
        slots = np.zeros((b,), np.int64)
        slots[:used.size] = used
        return slots

    def gather(self, uniq_ids: np.ndarray, *,
               pad_to: Optional[int] = None) -> torch.Tensor:
        """One fixed-width gather of every id's row: a ``(U_pad, dim)``
        device tensor of the cache's dtype (on the card, the gather
        graph's static output, overwritten by the next gather of that
        width). Padding lanes read the null slot (scratch: the model's
        ``inv`` never points at them)."""
        slots = self.lookup_slots(uniq_ids, pad_to=pad_to)
        return self._gather_call(slots.size, slots)

    def note_traffic(self, hits: int, misses: int):
        self._hits.inc(hits)
        self._misses.inc(misses)

    # -- lifecycle --------------------------------------------------------

    def warmup_plan(self, max_uniq: int):
        """The ``("gather", width)`` / ``("install", width)`` signatures
        :meth:`warmup` captures for batches of up to ``max_uniq`` unique
        ids, in capture order."""
        cap = max(self.capacity, int(max_uniq))
        plan = []
        for kind, minimum in (("gather", self.min_gather_bucket),
                              ("install", self.min_install_bucket)):
            b = max(minimum, 1)
            top = _pow2_bucket(int(max_uniq), minimum, cap)
            while True:
                plan.append((kind, b))
                if b >= top:
                    break
                b *= 2
        return plan

    def reachable_buckets(self, max_uniq: int):
        """Every gather/install width the serve path can request for
        batches of up to ``max_uniq`` unique ids, found by probing the
        serve-side ``_pow2_bucket`` calls at every power-of-two boundary:
        the serve-side half of the coverage proof."""
        max_uniq = int(max_uniq)
        pts = {1, max(max_uniq, 1)}
        p = 1
        while p < max_uniq:           # where the bucket step can move
            pts.add(p)
            if p + 1 <= max_uniq:
                pts.add(p + 1)
            p *= 2
        sigs = set()
        for n in pts:
            # serve-time calls size their cap as max(capacity, n)
            sigs.add(("gather", _pow2_bucket(
                n, self.min_gather_bucket, max(self.capacity, n))))
            sigs.add(("install", _pow2_bucket(
                n, self.min_install_bucket, max(self.capacity, n))))
        return sigs

    def warmup(self, max_uniq: int):
        """Build every gather and install width a batch of up to
        ``max_uniq`` unique ids can hit (on zero slots: the null row, no
        live row is touched), so steady-state lookups capture nothing.
        Records the set in :attr:`warmed_buckets`."""
        self.warmed_buckets = set()
        for sig in self.warmup_plan(max_uniq):
            kind, b = sig
            slots = np.zeros((b,), np.int64)
            if kind == "gather":
                self._gather_call(b, slots)
            else:
                self._install_call(b, slots,
                                   np.zeros((b, self.dim), np.float32))
            self.warmed_buckets.add(sig)

    def check_invariants(self):
        """Index consistency: id -> slot and slot -> id are inverse
        bijections, free and used partition the slots, the null slot is
        never mapped, and the policy and version books cover exactly the
        resident set. Raises AssertionError. Vectorized (the reference
        walks the index in Python), so it can run after every step of a
        full-size cache."""
        n = len(self._slot_of)
        ids = np.fromiter(self._slot_of.keys(), np.int64, n)
        used = np.fromiter(self._slot_of.values(), np.int64, n)
        free = np.asarray(self._free, np.int64)
        _check(not (used == 0).any(), "null slot mapped to a real id")
        _check(np.unique(used).size == n, "two ids share a slot")
        _check(np.intersect1d(used, free).size == 0,
               "slot both free and used")
        _check(np.array_equal(np.union1d(used, free),
                              np.arange(1, self.capacity + 1)),
               "slots leaked")
        _check((self._id_of[used] == ids).all(), "reverse index mismatch")
        _check(np.array_equal(np.flatnonzero(self._id_of >= 0),
                              np.sort(used)), "slot->id book out of sync")
        _check((self._slot_last[used] >= 0).all(),
               "used slot without a policy tick")
        _check((self._slot_last[np.unique(free)] == -1).all(),
               "free slot with a live policy tick")
        _check(self._version.keys() == self._slot_of.keys(),
               "version book out of sync")

    def hit_ratio_window(self) -> float:
        h = self._hits.value()
        m = self._misses.value()
        return h / max(h + m, 1.0)


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)
