"""EmbeddingServingEngine: online embedding lookups with a device cache
(``paddle_tpu/embedding_serving/engine.py``).

The recommender serving loop: inference traffic arrives as batches of
sparse feature ids; the full table lives in a
:class:`~paddle_tpu_torch.parallel.host_kv.HostKVStore` (or a
:class:`~paddle_tpu_torch.parallel.kv_server.RemoteKVStore` pserver); hot
rows are served from the fixed-shape device cache and misses are pulled
(deduped, ``pull_async``-overlapped) and installed with an eviction
policy. Per batch:

  submit(feat_ids):
    uniq/inv dedup (host)            — HostKVEmbedding's contract
    staleness gate                   — flush the streaming channel when
                                       its lag exceeds the bound, then
                                       drain its applied-update dirty
                                       set: unreferenced ids are
                                       invalidated outright, ids pinned
                                       by in-flight batches get a
                                       version requirement that makes
                                       split() reclassify them as
                                       misses until refreshed
                                       (O(pushed rows), not O(batch))
    pull_async(missing uniq ids)     — overlaps earlier batches' device
                                       work; buffers held by the handle
  step():
    wait oldest pull → install       — ONE bucketed index_copy_ graph
    gather + DeepFM forward          — ONE graph per (gather width, batch
                                       shape, with or without feat_vals)
                                       → (B,) probabilities

**The forward on the card.** The reference jits ``predict_proba``; the
port captures, per gather width and warmed batch shape ``(B, F)``, one
CUDA graph of the gather from the cache's table followed by DeepFM's
``predict_proba``, over static ``slots``, ``inv`` (and ``feat_vals``)
tensors into a static ``(B,)`` output (:mod:`~paddle_tpu_torch.
embedding_serving.graphs`). :meth:`warmup` captures them all; a batch
shape that was not warmed is captured at its first use and counts as a
capture after warmup, as a retrace does in the reference. The host feeds
the static inputs by plain copies from pageable numpy: the service makes
no pinned buffer. Without a model the engine serves the padded rows of
the cache's gather graph. On the CPU every call runs eagerly.

``submit`` load-sheds with a structured :class:`EmbedReject` when the
miss pipeline is ``max_pending`` batches deep: bounded memory and a
bounded staleness window, since a served batch's rows are never older
than its own submit-time store state.

Metrics (observability registry): hit-rate and staleness gauges,
``embedding_serving_requests_total``, miss-latency and lookup-latency
histograms, eviction and reject counters; spans ``embed.request``,
``embed.pull_wait``, ``embed.install``, ``embed.gather_forward`` and
``embed.staleness_flush``.

Persistence: :meth:`snapshot` / :meth:`restore` wrap
``persistence.save_kv_snapshot``: manifest-committed, hash-verified
KV-table saves with the streaming version counters.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Sequence

import numpy as np

import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.embedding_serving import persistence as _persist
from paddle_tpu_torch.embedding_serving.device_cache import (
    CacheCapacityError, DeviceEmbeddingCache, _pow2_bucket)

_LOOKUP_BUCKETS = (1e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0)


@dataclasses.dataclass
class EmbedReject:
    """Structured load-shed verdict (mirrors ``serving.Reject``): why
    the engine refused to queue a lookup batch, and what a client
    should do about it."""
    reason: str              # "miss_queue_full"
    queue_depth: int         # pending lookup batches
    pending_miss_rows: int   # rows still in flight from the store
    retry_after_s: float


class EmbeddingLoadShedError(RuntimeError):
    """Raised by ``submit`` instead of queueing past ``max_pending``;
    carries an :class:`EmbedReject`."""

    def __init__(self, reject: EmbedReject):
        super().__init__(
            f"embedding load shed ({reject.reason}): "
            f"queue_depth={reject.queue_depth} "
            f"pending_miss_rows={reject.pending_miss_rows} "
            f"retry_after={reject.retry_after_s:.4f}s")
        self.reject = reject


@dataclasses.dataclass
class _Pending:
    rid: int
    uniq: np.ndarray                 # (U,) real uniq ids
    uniq_set: set                    # same ids, for eviction protection
    inv: np.ndarray                  # (B, F) indices into uniq
    feat_vals: Optional[np.ndarray]
    handle: object                   # PullHandle | None (no misses)
    miss_ids: np.ndarray
    req: Dict[int, int]              # miss id -> version the refresh
    #                                  must install (staleness bookkeeping)
    hits: int
    submitted_at: float
    pull_issued_at: float
    span: object = None              # trace root (None = tracing off)


class EmbeddingServingEngine:
    """Submit batches of sparse ids → dense embedding rows → (optional)
    DeepFM forward.

    ``model``: a :class:`~paddle_tpu_torch.models.deepfm.DeepFMHostKV`
    on ``device`` (or any module exposing ``predict_proba(rows, inv,
    feat_vals)`` whose forward can be captured); without one the engine
    serves the padded rows (float32 numpy). ``capacity`` is the device
    hot-row count: it must cover at least one batch's unique ids (the
    fixed-width gather's hard floor). ``device`` defaults to CUDA and
    raises without a card unless ``device="cpu"`` is given.
    """

    def __init__(self, store, model=None, *,
                 capacity: int = 1 << 16, policy: str = "lru",
                 min_bucket: int = 256, max_pending: int = 4,
                 channel=None, max_staleness_s: Optional[float] = None,
                 max_lag_updates: Optional[int] = None,
                 cache_dtype=None, registry=None, tracer=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if model is not None and next(model.parameters()).device \
                != self.device:
            raise ValueError(f"model lives on "
                             f"{next(model.parameters()).device}, the "
                             f"engine on {self.device}")
        self.store = store
        self.model = model
        self.max_pending = int(max_pending)
        self.channel = channel
        self.max_staleness_s = max_staleness_s
        self.max_lag_updates = max_lag_updates
        from paddle_tpu_torch import observability as obs
        self._reg = registry or obs.default()
        # per-batch lifecycle tracing (host-side only, outside every
        # graph): dedup → miss pull → install → gather → predict
        self.tracer = tracer or obs.tracing.default()
        self.cache = DeviceEmbeddingCache(
            capacity, store.dim, policy=policy, dtype=cache_dtype,
            min_gather_bucket=min_bucket, registry=self._reg,
            device=self.device)
        self._pending: "deque[_Pending]" = deque()
        # ids whose cached row must reach version v before serving as a
        # hit: pushed rows still referenced by in-flight batches cannot
        # be invalidated (their slots are about to be gathered), so the
        # staleness gate records the required version here and submit's
        # split() reclassifies them as misses until a refresh installs
        self._stale_req: Dict[int, int] = {}
        self._results: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._results_cap = max(64, 8 * self.max_pending)
        self._rid = 0
        self._served_rows = 0
        self._served_hits = 0

        self.recompile_detector = obs.RecompileDetector(
            "embedding_serving", warmup=1, registry=self._reg)

        self._req_c = self._reg.counter(
            "embedding_serving_requests_total", "lookup batches submitted")
        self._reject_c = self._reg.counter(
            "embedding_serving_rejected_total",
            "lookup batches load-shed instead of queued")
        self._hit_g = self._reg.gauge(
            "embedding_serving_hit_rate",
            "device-cache hit fraction of id lookups (cumulative, "
            "occurrence-weighted)")
        self._stale_g = self._reg.gauge(
            "embedding_serving_staleness_seconds",
            "streaming-channel lag at the last staleness gate")
        self._lag_g = self._reg.gauge(
            "embedding_serving_lag_updates",
            "streaming pushes accepted but not yet applied")

    # histograms are fetched from the registry at observe time (the
    # ServingEngine idiom), so a bench can unregister() between passes
    # and still see fresh per-pass samples
    def _miss_h(self):
        return self._reg.histogram(
            "embedding_serving_miss_latency_seconds",
            "store pull wall time per batch (issue -> rows ready)",
            buckets=_LOOKUP_BUCKETS)

    def _lookup_h(self):
        return self._reg.histogram(
            "embedding_serving_lookup_seconds",
            "submit -> rows served end to end", buckets=_LOOKUP_BUCKETS)

    # -- request surface --------------------------------------------------

    def submit(self, feat_ids: np.ndarray,
               feat_vals: Optional[np.ndarray] = None) -> int:
        """Enqueue one lookup batch; returns its rid. Dedup + the
        staleness gate + version probe + the async miss pull all happen
        here, so the pull overlaps earlier batches' device work.
        Raises :class:`EmbeddingLoadShedError` when ``max_pending``
        batches are already in flight."""
        now = time.monotonic()
        if len(self._pending) >= self.max_pending:
            rej = EmbedReject(
                "miss_queue_full", len(self._pending),
                int(sum(p.miss_ids.size for p in self._pending)),
                retry_after_s=max(
                    self._miss_h().summary()["mean"], 1e-4))
            self._reject_c.inc(reason=rej.reason)
            if self.tracer.enabled:
                self.tracer.record_span(
                    "embed.request", duration_s=0.0, status="shed",
                    shed_reason=rej.reason,
                    queue_depth=rej.queue_depth)
            raise EmbeddingLoadShedError(rej)
        self._req_c.inc()
        feat_ids = np.asarray(feat_ids, np.int64)
        uniq, inv = np.unique(feat_ids, return_inverse=True)
        inv = inv.reshape(feat_ids.shape).astype(np.int32)
        if uniq.size > self.cache.capacity:
            raise ValueError(
                f"batch has {uniq.size} unique ids > cache capacity "
                f"{self.cache.capacity}")

        self._staleness_gate()
        hit_mask, miss_ids = self.cache.split(
            uniq, self._stale_req if self._stale_req else None)
        # occurrence-weighted traffic: a hot id looked up 100 times in
        # the batch counts 100 hits — the number ads-serving dashboards
        # mean by "hit rate" (uniq-weighted would understate hot-head
        # caching exactly where it matters)
        occ = np.bincount(inv.ravel(), minlength=uniq.size)
        hits = int(occ[hit_mask].sum())
        miss_occ = int(occ[~hit_mask].sum())
        self.cache.note_traffic(hits, miss_occ)
        handle = None
        if miss_ids.size:
            b = _pow2_bucket(miss_ids.size, self.cache.min_install_bucket,
                             max(self.cache.capacity, miss_ids.size))
            out = np.zeros((b, self.store.dim), np.float32)
            handle = self.store.pull_async(miss_ids, out=out)
        req = {}
        if self._stale_req and miss_ids.size:
            sr = self._stale_req
            req = {i: sr[i] for i in miss_ids.tolist() if i in sr}
        self._rid += 1
        span = None
        if self.tracer.enabled:
            span = self.tracer.start_span(
                "embed.request", rid=self._rid, batch=int(inv.size),
                uniq=int(uniq.size), misses=int(miss_ids.size),
                hit_occurrences=hits)
            span.add_event("dedup", uniq=int(uniq.size),
                           misses=int(miss_ids.size))
            if handle is not None:
                span.add_event("pull_issued", rows=int(miss_ids.size))
        self._pending.append(_Pending(
            self._rid, uniq, set(uniq.tolist()), inv, feat_vals, handle,
            miss_ids, req, hits, now, time.monotonic(), span))
        return self._rid

    def step(self) -> Dict[int, np.ndarray]:
        """Complete the OLDEST pending batch: wait its miss pull,
        install the rows (one bucketed index_copy_ graph, evicting by
        policy), run the fixed-shape gather (+ model forward), and
        return ``{rid: probs}`` (or ``{rid: padded rows}`` without a
        model)."""
        if not self._pending:
            return {}
        p = self._pending.popleft()
        try:
            return self._step_popped(p)
        except BaseException:
            # the batch is already popped: its root span would otherwise
            # never reach the ring — and the FAILING request's trace is
            # the one an operator needs most
            if p.span is not None:
                p.span.add_event("error")
                p.span.finish(status="error")
            raise

    def _forward(self, slots: np.ndarray, inv: np.ndarray,
                 feat_vals: Optional[np.ndarray]) -> torch.Tensor:
        """One replay of the forward graph of (gather width, batch shape,
        with or without ``feat_vals``), built at first use: the gather of
        ``slots`` from the cache's table and the model's
        ``predict_proba`` over it, (B,) probabilities."""
        w, (b, f) = slots.size, inv.shape
        sig = ("forward", w, b, f, feat_vals is not None)
        table, model = self.cache.table, self.model
        inputs = {"slots": ((w,), torch.int64),
                  "inv": ((b, f), torch.int64)}
        feeds = {"slots": slots, "inv": inv}
        if feat_vals is not None:
            inputs["feat_vals"] = ((b, f), torch.float32)
            feeds["feat_vals"] = feat_vals

        def fn(slots, inv, feat_vals=None):
            rows = table.index_select(0, slots).float()
            return model.predict_proba(rows, inv, feat_vals)

        with torch.no_grad():
            return self.cache.graphs.run(sig, feeds, inputs, fn)

    def _step_popped(self, p: _Pending) -> Dict[int, np.ndarray]:
        if p.handle is not None:
            t0 = time.monotonic()
            rows = p.handle.wait()
            t1 = time.monotonic()
            self._miss_h().observe(t1 - p.pull_issued_at)
            if p.span is not None:
                self.tracer.record_span(
                    "embed.pull_wait", start=t0, end=t1, parent=p.span,
                    rows=int(p.miss_ids.size),
                    pull_age_s=round(t1 - p.pull_issued_at, 6))
            protect = p.uniq_set.union(
                *(q.uniq_set for q in self._pending))
            t0 = time.monotonic()
            try:
                self.cache.install(p.miss_ids, np.asarray(rows),
                                   versions=p.req or None,
                                   protect=protect)
            except CacheCapacityError:
                # the aggregate in-flight working set outgrew the
                # table: protect only THIS batch (capacity must hold
                # one batch — submit's hard check). Later batches whose
                # hit-classified rows get evicted here self-heal below.
                if p.span is not None:
                    p.span.add_event("capacity_retry",
                                     protected=len(p.uniq_set))
                self.cache.install(p.miss_ids, np.asarray(rows),
                                   versions=p.req or None,
                                   protect=p.uniq_set)
            if p.span is not None:
                self.tracer.record_span(
                    "embed.install", start=t0, parent=p.span,
                    rows=int(p.miss_ids.size))
            self._settle_stale(p.req)
        # self-heal: a row classified as a hit at submit may have been
        # evicted since (a later batch's install under capacity
        # pressure). Re-pull the residue synchronously — slow path, but
        # it keeps step() total instead of crashing the popped batch.
        _, gone = self.cache.split(p.uniq)
        if gone.size:
            sr = self._stale_req
            req2 = {i: sr[i] for i in gone.tolist() if i in sr} \
                if sr else {}
            if p.span is not None:
                p.span.add_event("self_heal_repull",
                                 rows=int(gone.size))
            self.cache.install(gone, self.store.pull(gone),
                               versions=req2 or None,
                               protect=p.uniq_set)
            self._settle_stale(req2)
        u_pad = _pow2_bucket(p.uniq.size, self.cache.min_gather_bucket,
                             max(self.cache.capacity, p.uniq.size))
        t0 = time.monotonic()
        if self.model is not None:
            slots = self.cache.lookup_slots(p.uniq, pad_to=u_pad)
            fv = None if p.feat_vals is None else \
                np.asarray(p.feat_vals, np.float32)
            out = self._forward(slots, p.inv, fv).cpu().numpy()
        else:
            out = self.cache.gather(p.uniq, pad_to=u_pad).float()
            out = out.cpu().numpy()
        now = time.monotonic()
        if p.span is not None:
            self.tracer.record_span(
                "embed.gather_forward", start=t0, end=now, parent=p.span,
                uniq=int(p.uniq.size), pad_to=int(u_pad),
                model=self.model is not None)
            p.span.add_event("finished")
            p.span.finish()
        self._served_rows += int(p.inv.size)
        self._served_hits += p.hits
        self._hit_g.set(self._served_hits / max(self._served_rows, 1))
        self._lookup_h().observe(now - p.submitted_at)
        self._results[p.rid] = out
        while len(self._results) > self._results_cap:
            self._results.popitem(last=False)
        return {p.rid: out}

    def result(self, rid: int) -> Optional[np.ndarray]:
        """Pop a finished batch's output (None while pending/consumed;
        the store is bounded — consume promptly)."""
        return self._results.pop(rid, None)

    def serve(self, feat_ids: np.ndarray,
              feat_vals: Optional[np.ndarray] = None) -> np.ndarray:
        """Synchronous convenience: submit one batch and drain the
        pipeline until it completes."""
        rid = self.submit(feat_ids, feat_vals)
        while True:
            done = self.step()
            if rid in done:
                # earlier batches' results stay poppable via result()
                self._results.pop(rid, None)
                return done[rid]

    def pending(self) -> int:
        return len(self._pending)

    # -- freshness --------------------------------------------------------

    def _staleness_gate(self):
        """Enforce + observe the staleness bound, then refresh the
        cache: drain the channel's applied-update dirty set; pushed ids
        nobody is waiting on are invalidated (their next lookup is a
        miss — re-pulled fresh), while ids still referenced by
        in-flight batches cannot have their slots freed (those batches
        are about to gather them), so their required store version is
        recorded in ``_stale_req`` instead — submit's version-aware
        split reclassifies them as misses until a refresh installs at
        that version. O(pushed rows) per serve, not O(batch ids); with
        nothing dirty and nothing outstanding this is two lag reads."""
        ch = self.channel
        if ch is None:
            return
        lag_s = ch.lag_seconds()
        lag_n = ch.lag_updates()
        if (self.max_staleness_s is not None
                and lag_s > self.max_staleness_s) or \
                (self.max_lag_updates is not None
                 and lag_n > self.max_lag_updates):
            t0 = time.monotonic()
            ch.flush()          # hard bound: apply the backlog first
            if self.tracer.enabled:
                self.tracer.record_span(
                    "embed.staleness_flush", start=t0,
                    lag_seconds=round(lag_s, 6), lag_updates=lag_n)
            lag_s, lag_n = 0.0, 0
        self._stale_g.set(lag_s)
        self._lag_g.set(lag_n)
        dirty = ch.drain_dirty()
        if not dirty and not self._stale_req:
            return
        pinned = set().union(*(q.uniq_set for q in self._pending)) \
            if self._pending else set()
        if dirty:
            free = dirty - pinned
            if free:
                self.cache.invalidate(np.fromiter(free, np.int64,
                                                  len(free)))
            held = dirty & pinned
            if held:
                self._stale_req.update(ch.versions(held))
        if self._stale_req:
            # requirements whose ids are no longer pinned downgrade to
            # plain invalidation — keeps _stale_req from accumulating
            unpinned = [i for i in self._stale_req if i not in pinned]
            if unpinned:
                self.cache.invalidate(np.asarray(unpinned, np.int64))
                for i in unpinned:
                    del self._stale_req[i]

    def _settle_stale(self, installed: Dict[int, int]):
        """Clear satisfied refresh requirements (unless a newer push
        raised the bar while the pull was in flight)."""
        if not installed or not self._stale_req:
            return
        sr = self._stale_req
        for i, v in installed.items():
            if sr.get(i) == v:
                del sr[i]

    # -- lifecycle --------------------------------------------------------

    def _forward_widths(self, max_uniq: int):
        w = max(self.cache.min_gather_bucket, 1)
        top = _pow2_bucket(max_uniq, self.cache.min_gather_bucket,
                           max(self.cache.capacity, max_uniq))
        while True:
            yield w
            if w >= top:
                return
            w *= 2

    def warmup_plan(self, batch_shape: Sequence[int],
                    with_feat_vals: bool = False):
        """The signatures :meth:`warmup` builds for ``batch_shape``
        (B, F), in capture order: the cache's gather and install widths
        (:meth:`DeviceEmbeddingCache.warmup_plan`), then, with a model,
        ``("forward", width, B, F, with_feat_vals)`` per gather width."""
        b, f = int(batch_shape[0]), int(batch_shape[1])
        max_uniq = min(b * f, self.cache.capacity)
        plan = list(self.cache.warmup_plan(max_uniq))
        if self.model is not None:
            plan += [("forward", w, b, f, bool(with_feat_vals))
                     for w in self._forward_widths(max_uniq)]
        return plan

    def warmup(self, batch_shape: Sequence[int],
               with_feat_vals: bool = False):
        """Build every signature a ``batch_shape`` (B, F) lookup can
        touch (:meth:`warmup_plan`): the cache's gather and install
        widths and the model's forward per gather width, all on zero
        inputs, so steady-state serving captures nothing."""
        b, f = int(batch_shape[0]), int(batch_shape[1])
        max_uniq = min(b * f, self.cache.capacity)
        self.cache.warmup(max_uniq)
        if self.model is None:
            return
        inv = np.zeros((b, f), np.int32)
        fv = np.ones((b, f), np.float32) if with_feat_vals else None
        for w in self._forward_widths(max_uniq):
            self._forward(np.zeros((w,), np.int64), inv, fv)

    def snapshot(self, directory: str, step: int) -> str:
        """Manifest-committed KV-table snapshot (incl. streaming
        version counters); torn saves are invisible, corrupt payloads
        refused at restore — the resilience discipline."""
        versions = None
        if self.channel is not None:
            self.channel.flush()
            with self.channel._vlock:
                versions = dict(self.channel._versions)
        return _persist.save_kv_snapshot(self.store, directory, step,
                                         versions=versions)

    def restore(self, directory: str, step: Optional[int] = None):
        """Load the newest valid snapshot into the backing store and
        reset the device cache (resident rows may predate the loaded
        table). Restores version counters into the channel."""
        versions = _persist.restore_kv_snapshot(self.store, directory,
                                                step)
        ids = list(self.cache._slot_of)
        if ids:
            self.cache.invalidate(np.asarray(ids, np.int64))
        if self.channel is not None:
            with self.channel._vlock:
                self.channel._versions = dict(versions)
        return versions
