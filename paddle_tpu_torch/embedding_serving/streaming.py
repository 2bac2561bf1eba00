"""Trainer→server streaming updates for the online embedding service
(``paddle_tpu/embedding_serving/streaming.py``).

The online-learning half of the ads/recsys loop: a trainer keeps
pushing sparse-row updates (fresh row VALUES from its optimizer, or raw
gradients for the store's host-side optimizer) and the serving side
must pick them up within seconds. Reference semantics are
``parallel/communicator.py``'s AsyncCommunicator: pushes enqueue and
return immediately; ONE background worker drains the queue, merges up
to ``max_merge`` pending pushes (last-writer-wins per id for values,
sum for gradients — the send-queue merge of communicator.h:166), and
applies them to the backing KV store.

Freshness bookkeeping, the part serving needs:

- **per-row version counters**: every id touched by an applied push
  bumps its version; the device cache records the version it installed,
  so :meth:`EmbeddingServingEngine.submit`'s version probe reclassifies
  a stale cached row as a miss (refresh) — a pushed row is re-served
  from the store on the very next lookup after its update applies.
- **staleness bound**: :meth:`lag_seconds` (age of the oldest
  unapplied push) and :meth:`lag_updates` (pushes still queued) are the
  observable lag; the engine enforces its configured bound by draining
  the channel (``flush``) before serving whenever the bound is
  exceeded, and exports both as gauges.

Thread contract: one internal worker thread, which touches no CUDA
state (it only calls the store); ``push_rows``/``push_grads`` are safe
from any thread (the trainer's); ``versions`` snapshots are
lock-guarded. Worker failures surface at the next
``push``/``flush`` (never silently dropped), like AsyncCommunicator.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from paddle_tpu_torch.analysis.concurrency import guarded_by


@guarded_by("_cv", "_pending", "_oldest_pending_ts", "_error")
@guarded_by("_vlock", "_versions", "_dirty")
class StreamingUpdateChannel:
    """Bounded async push channel between a trainer and a serving
    engine's backing store."""

    def __init__(self, store, *, max_merge: int = 32,
                 queue_size: int = 256, registry=None, tracer=None):
        self.store = store
        self.max_merge = int(max_merge)
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._pending = 0
        self._oldest_pending_ts: Optional[float] = None
        self._vlock = threading.Lock()
        self._versions: Dict[int, int] = {}
        self._dirty: set = set()      # ids applied since the last drain
        self._error: Optional[Exception] = None
        self.pushed_rows = 0          # rows received
        self.applied_batches = 0      # store applications (post-merge)

        from paddle_tpu_torch import observability as obs
        self._reg = registry or obs.default()
        # applier-thread spans live on the worker's OWN thread-local
        # stack (a fresh trace per apply) — the thread-correct
        # attribution the tracing module's design notes call out
        self.tracer = tracer or obs.tracing.default()
        self._apply_h = self._reg.histogram(
            "embedding_stream_apply_seconds",
            "store-apply wall time per merged push batch")
        self._applied_c = self._reg.counter(
            "embedding_stream_rows_applied_total",
            "sparse rows applied to the backing store")
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- trainer side -----------------------------------------------------

    def push_rows(self, ids: np.ndarray, rows: np.ndarray):
        """Enqueue fresh row VALUES (trainer-side optimizer already
        applied — the GeoSGD/set_rows shape). Copies its inputs;
        blocks only when the queue is full (backpressure)."""
        self._push(("rows", *self._copy(ids, rows), None))

    def push_grads(self, ids: np.ndarray, grads: np.ndarray, lr: float):
        """Enqueue a sparse GRADIENT push (the store's host optimizer
        applies it — the Async hogwild shape)."""
        self._push(("grads", *self._copy(ids, grads), float(lr)))

    def _copy(self, ids, vals):
        ids = np.array(ids, np.int64, copy=True).ravel()
        vals = np.array(vals, np.float32, copy=True)
        if vals.shape != (ids.size, self.store.dim):
            raise ValueError(f"vals shape {vals.shape} != "
                             f"({ids.size}, {self.store.dim})")
        return ids, vals

    def _push(self, item):
        self._raise_if_failed()
        now = time.monotonic()
        with self._cv:
            self._pending += 1
            if self._oldest_pending_ts is None:
                self._oldest_pending_ts = now
        self.pushed_rows += item[1].size
        self._q.put(item + (now,))

    # -- freshness surface ------------------------------------------------

    def version_of(self, id_: int) -> int:
        with self._vlock:
            return self._versions.get(int(id_), 0)

    def versions(self, ids: Sequence[int]) -> Dict[int, int]:
        """Snapshot of current per-row versions for ``ids`` (0 = never
        pushed). The engine compares these against install versions."""
        with self._vlock:
            return {int(i): self._versions.get(int(i), 0) for i in ids}

    def drain_dirty(self, keep=None) -> set:
        """Pop the ids whose updates have APPLIED since the last drain
        — the serving engine invalidates exactly these device slots
        (O(pushed rows) per serve, not O(batch ids)). Ids in ``keep``
        stay queued for a later drain (in-flight batches may still
        gather their current slots)."""
        with self._vlock:
            if not self._dirty:
                return set()
            if keep:
                out = {i for i in self._dirty if i not in keep}
                self._dirty -= out
            else:
                out, self._dirty = self._dirty, set()
            return out

    def lag_updates(self) -> int:
        """Pushes accepted but not yet applied to the store."""
        with self._cv:
            return self._pending

    def lag_seconds(self) -> float:
        """Age of the oldest unapplied push (0.0 when drained) — the
        observable staleness the engine bounds."""
        with self._cv:
            if self._oldest_pending_ts is None:
                return 0.0
            return max(time.monotonic() - self._oldest_pending_ts, 0.0)

    # -- worker -----------------------------------------------------------

    def _worker(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                items = [self._q.get(timeout=0.05)]
            except queue.Empty:
                continue
            while len(items) < self.max_merge:
                try:
                    items.append(self._q.get_nowait())
                except queue.Empty:
                    break
            count = len(items)
            err = None
            try:
                self._apply(items)
            except Exception as e:
                err = e
            with self._cv:
                if err is not None:
                    self._error = err
                self._pending -= count
                if self._pending == 0:
                    self._oldest_pending_ts = None
                self._cv.notify_all()

    def _apply(self, items):
        t0 = time.monotonic()
        # merge: consecutive same-kind pushes collapse into one store
        # call (values last-writer-wins per id, grads concatenated —
        # the store's sharded optimizer accumulates them)
        i = 0
        applied = 0
        while i < len(items):
            kind = items[i][0]
            j = i
            while j < len(items) and items[j][0] == kind and \
                    (kind == "rows" or items[j][3] == items[i][3]):
                j += 1
            group = items[i:j]
            if kind == "rows":
                merged: Dict[int, np.ndarray] = {}
                for _, ids, vals, _, _ in group:
                    for k, id_ in enumerate(ids.tolist()):
                        merged[id_] = vals[k]
                ids = np.fromiter(merged, np.int64, len(merged))
                vals = np.stack([merged[x] for x in ids.tolist()]) \
                    if len(merged) else \
                    np.zeros((0, self.store.dim), np.float32)
                if ids.size:
                    self.store.set_rows(ids, vals)
            else:
                ids = np.concatenate([g[1] for g in group])
                vals = np.concatenate([g[2] for g in group])
                if ids.size:
                    self.store.push(ids, vals, group[0][3], wait=True)
            applied_ids = ids.tolist()
            with self._vlock:
                for id_ in applied_ids:
                    self._versions[id_] = self._versions.get(id_, 0) + 1
                self._dirty.update(applied_ids)
            applied += int(ids.size)
            i = j
        self.applied_batches += 1
        self._applied_c.inc(applied)
        now = time.monotonic()
        self._apply_h.observe(now - t0)
        if self.tracer.enabled:
            self.tracer.record_span("embed.stream_apply", start=t0,
                                    end=now, rows=applied,
                                    merged_pushes=len(items))

    # -- lifecycle --------------------------------------------------------

    def _raise_if_failed(self):
        # read-and-clear is a two-step mutation: without the lock a
        # worker error landing between the read and the clear is lost
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("streaming update worker failed") from err

    def flush(self):
        """Block until every accepted push is applied to the store —
        the engine's hard staleness-bound enforcement point."""
        with self._cv:
            self._cv.wait_for(lambda: self._pending == 0)
        self._raise_if_failed()

    def stop(self):
        self.flush()
        self._stop.set()
        self._thread.join(timeout=10)

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass
