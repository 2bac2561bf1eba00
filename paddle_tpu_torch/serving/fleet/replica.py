"""Replica handles: the engine-as-cattle interface the fleet fronts.

The router never touches a :class:`~paddle_tpu_torch.serving.ServingEngine`
directly — it speaks :class:`ReplicaHandle`, a small surface (submit /
step / health / prefix digests / snapshot / restore) that an
in-process threaded replica implements today and a process- or
HTTP-backed transport can implement later without the router changing.

:class:`LocalReplica` is the CI transport: it owns one engine, steps it
either synchronously (the router's deterministic drive mode — the
migration byte-parity tests need reproducible interleavings) or on its
own background thread (``start()``/``stop()``), and tracks per-replica
busy time so the bench can compute the fleet's critical path as if
every replica had its own accelerator.

Draining a replica is **migration, not kill**: ``drain_queue()`` hands
back the not-yet-admitted requests for resubmission elsewhere, and
``snapshot_inflight()`` walks the active slots through
``engine.snapshot_slot`` (sha256-per-page shard manifests — the
resilience transfer discipline) so peers can
``restore()`` them and resume decode byte-identically.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.analysis.concurrency import guarded_by

if TYPE_CHECKING:       # annotation only — no runtime import cycle
    from paddle_tpu_torch.serving.engine import ServingEngine


class FullReplay(list):
    """A progress stream re-sent from offset 0.

    ``progress(since=)`` normally returns only the tokens past the
    caller's cursor. When the cursor is stale — negative, or past the
    end of what the replica actually holds (a restore rewound the
    stream, or the caller's bookkeeping desynced) — raising would turn
    one confused poll into a dead replica, and silently returning an
    empty (or negative-index!) slice would corrupt the router's replay
    record. Instead the replica answers with the FULL stream wrapped in
    this marker; a consumer REPLACES its record rather than extending
    it. The marker survives the wire protocol (``net.wire`` encodes it
    explicitly) so the semantics hold across a socket."""

    full_replay = True


class ReplicaHandle:
    """Transport interface between router and replica. Every method is
    host-side and cheap except ``step()`` (one engine iteration).
    Implementations must make ``health()`` safe to call from the
    router's thread while ``step()`` runs."""

    name: str = "replica"
    draining: bool = False

    def page_size(self) -> int:
        """KV page size — the router needs it to compute page-aligned
        prefix digests with the replicas' own alignment."""
        raise NotImplementedError

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, *, lane: str = "default",
               ttft_deadline_s: Optional[float] = None,
               trace_id: Optional[int] = None) -> int:
        raise NotImplementedError

    def step(self) -> Dict[int, np.ndarray]:
        raise NotImplementedError

    def health(self) -> Dict[str, object]:
        raise NotImplementedError

    def prefix_digests(self) -> frozenset:
        """Published full-page prefix digests this replica can map
        copy-free (the router's cache-locality signal)."""
        raise NotImplementedError

    def can_accept(self, total_tokens: int) -> bool:
        raise NotImplementedError

    def idle(self) -> bool:
        raise NotImplementedError

    def result(self, rid: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def request_stats(self, rid: int) -> Optional[Dict[str, float]]:
        raise NotImplementedError

    def progress(self, since: Optional[Dict[int, int]] = None
                 ) -> Dict[int, List[int]]:
        """Tokens emitted so far per in-flight request (``{rid:
        [tokens]}``). The router polls this every step so a crash
        never takes the emitted prefix with it — the cold-redrive path
        resubmits ``prompt + observed`` to a peer. ``since`` maps rid →
        token count the caller already holds; only the tokens past
        that index come back (the poll then costs O(new tokens) per
        step instead of re-copying whole streams). A stale or
        out-of-range ``since`` cursor gets the full stream back as a
        :class:`FullReplay` (replace, don't extend) instead of an
        exception or a bogus slice. Transports without progress export
        return ``{}`` (redrive then re-decodes from the prompt; greedy
        determinism keeps outputs identical)."""
        return {}

    def poll_checkpoints(self) -> List[Tuple[int, Dict]]:
        """Drain the replica's micro-checkpoint outbox (``(rid,
        snapshot)`` pairs — see ``ServingEngine.poll_micro_snapshots``).
        The router keeps the newest per request as the warm-restore
        seed that bounds re-decode work after a crash."""
        return []

    def poll_handoffs(self) -> List[Tuple[int, Dict]]:
        """Drain a prefill-tier replica's handoff outbox (``(rid,
        snapshot)`` pairs — see ``ServingEngine.poll_handoffs``): every
        parked prefill-done slot, snapshotted in the migration transfer
        format and already released. The two-tier router streams each
        snapshot to a decode-tier peer's ``restore``. Empty on
        non-prefill replicas."""
        return []

    def reject_reason(self, rid: int):
        """Structured reject for a request the replica's own engine
        shed after queueing (TTFT deadline expired before admission);
        None otherwise. The router polls this so an engine-side shed
        surfaces as a fleet-level structured reject instead of a
        silently-lost request."""
        return None

    def drain_queue(self) -> List[Tuple]:
        """Pop every queued (not yet admitted) request; returns
        ``(rid, prompt, max_new_tokens, eos_id, lane, ttft_deadline_s)``
        tuples for the router to resubmit on peers."""
        raise NotImplementedError

    def snapshot_inflight(self) -> List[Tuple[int, Dict]]:
        """Snapshot-and-release every active slot; returns
        ``(old_rid, snapshot)`` pairs ready for a peer's ``restore``."""
        raise NotImplementedError

    def restore(self, snap: Dict, *, parent_span=None) -> int:
        raise NotImplementedError

    def export_prefix_pages(self, digests) -> Optional[Dict]:
        """Package the leading run of ``digests`` this replica holds as
        a prefix-page bundle (hash-chained, per-(page, tp-shard) sha256
        shards) for a peer's :meth:`import_prefix_pages`. Transports
        without page export return None — the router degrades to local
        re-prefill, never an error."""
        return None

    def import_prefix_pages(self, bundle) -> int:
        """Install a peer's exported prefix pages into this replica's
        published index (verified all-or-nothing). Returns pages
        installed; transports without page import install nothing."""
        return 0

    def warmup(self):
        raise NotImplementedError

    def postmortem(self, reason: str, trace_ids=()) -> Optional[Dict]:
        """Dump the replica's flight-recorder black box as a postmortem
        bundle (``observability.flight``). Called by the router on
        eject / breaker-open / shed spikes — AFTER the failure, so
        implementations must not require a live engine loop. Transports
        without a flight recorder return None."""
        return None

    def close(self):
        pass


@guarded_by("_lock", "engine")
class LocalReplica(ReplicaHandle):
    """In-process replica over one :class:`ServingEngine`.

    Synchronous mode (default): the router calls :meth:`step` — fully
    deterministic, the mode every parity test runs. Threaded mode:
    :meth:`start` spawns a loop calling ``step()`` whenever work is
    pending (idle-backoff otherwise); finished results accumulate in a
    bounded engine-side store exactly as in synchronous mode, and
    ``health()`` stays safe because the engine publishes snapshots.

    ``engine`` is ``@guarded_by("_lock")``: in threaded mode the router
    submits/polls from its thread while the loop steps, so every engine
    access that can mutate or observe mutable engine state goes through
    ``self._lock``. The deliberate lock-free exceptions — ``health()``
    (engine-published snapshots), ``page_size()``/``can_accept()``
    (immutable config), ``postmortem()`` (must testify after the loop
    died) — read only what the engine publishes for other threads.
    """

    def __init__(self, engine: "ServingEngine", name: str = "replica0",
                 clock=time.monotonic):
        self.engine = engine
        self.name = name
        # the black box carries the replica's fleet name so a fleet-wide
        # /debug/postmortem endpoint can attribute bundles
        flight = getattr(engine, "flight", None)
        if flight is not None:
            flight.name = name
        self.busy_s = 0.0           # wall time inside step() — the
        self.steps = 0              # bench's per-accelerator cost model
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.draining = False
        # involuntary-failure surface: the background loop records its
        # own death here (health()/running() expose it, the router's
        # detector acts on it), and every step beats the heartbeat the
        # hang detector ages. The clock MUST be monotonic-shaped: the
        # age is a delta, and a wall clock here would let an NTP step
        # fabricate (or hide) a hang — load-bearing once the age
        # crosses a socket, where the remote host's wall clock is not
        # even the same clock.
        self.failed = False
        self.last_error: Optional[str] = None
        self._clock = clock
        self._last_beat = clock()
        # serializes engine MUTATIONS (submit vs step vs migration)
        # for threaded mode — a router-thread submit must not mutate
        # the scheduler queue mid-iteration. health() stays lock-free:
        # the engine publishes snapshots for exactly that reason.
        self._lock = threading.RLock()

    # -- request surface ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, *, lane: str = "default",
               ttft_deadline_s: Optional[float] = None,
               trace_id: Optional[int] = None) -> int:
        with self._lock:
            # answering a submit IS a heartbeat: a sync-mode replica
            # only beats when stepped, and the first probe after a
            # long warmup must not read the gap as a hang
            self._last_beat = self._clock()
            return self.engine.submit(prompt, max_new_tokens, eos_id,
                                      lane=lane,
                                      ttft_deadline_s=ttft_deadline_s,
                                      trace_id=trace_id)

    def step(self) -> Dict[int, np.ndarray]:
        t0 = self._clock()
        with self._lock:
            out = self.engine.step()
        now = self._clock()
        self.busy_s += now - t0
        self.steps += 1
        self._last_beat = now
        return out

    def health(self) -> Dict[str, object]:
        h = dict(self.engine.health())
        h["heartbeat_age_s"] = self._clock() - self._last_beat
        h["failed"] = self.failed
        if self.last_error is not None:
            h["last_error"] = self.last_error
        return h

    def page_size(self) -> int:
        return self.engine.cache.config.page_size

    def prefix_digests(self) -> frozenset:
        with self._lock:
            # advertised_digests walks the cache's digest map AND the
            # host spill pool, which step()'s page commits mutate —
            # same race as result(). Spilled pages count: they restore
            # on the next local hit and export to fetching peers
            return self.engine.cache.advertised_digests()

    def can_accept(self, total_tokens: int) -> bool:
        return (not self.draining
                and self.engine.cache.config.pages_for(total_tokens)
                <= self.engine.cache.config.max_pages_per_slot)

    def idle(self) -> bool:
        # reads the scheduler's queue/slot state, which a concurrent
        # step() mutates — cheap enough to take the lock every poll
        with self._lock:
            return self.engine.scheduler.idle()

    def result(self, rid: int) -> Optional[np.ndarray]:
        with self._lock:
            # pop-on-read from the engine's bounded result store — a
            # mutation, not a snapshot read, so it needs the lock
            return self.engine.result(rid)

    def request_stats(self, rid: int) -> Optional[Dict[str, float]]:
        with self._lock:
            return self.engine.request_stats(rid)

    def warmup(self):
        with self._lock:
            self.engine.warmup()
        self._last_beat = self._clock()
        return self

    def postmortem(self, reason: str, trace_ids=()) -> Optional[Dict]:
        # deliberately lock-free AND loop-free: the flight recorder's
        # ring is host-side state, so a replica whose step loop already
        # died can still testify
        flight = getattr(self.engine, "flight", None)
        if flight is None:
            return None
        return flight.dump(reason, trace_ids=trace_ids)

    def progress(self, since: Optional[Dict[int, int]] = None
                 ) -> Dict[int, List[int]]:
        with self._lock:
            eng = self.engine
            out = {}
            for i in eng.scheduler.active_slots():
                st = eng.scheduler.slots[i]
                rid = st.request.rid
                lo = since.get(rid, 0) if since else 0
                if lo < 0 or lo > len(st.generated):
                    # stale cursor (restore rewound the stream, or the
                    # caller desynced): a raw slice would be empty or
                    # negative-indexed garbage — answer with the full
                    # stream, marked so the caller REPLACES its record
                    out[rid] = FullReplay(st.generated)
                else:
                    # tail-only slice: O(new tokens) per poll, not O(all)
                    out[rid] = list(st.generated[lo:]) if lo \
                        else list(st.generated)
            return out

    def poll_checkpoints(self) -> List[Tuple[int, Dict]]:
        with self._lock:
            return list(self.engine.poll_micro_snapshots().items())

    def poll_handoffs(self) -> List[Tuple[int, Dict]]:
        with self._lock:
            return list(self.engine.poll_handoffs())

    def reject_reason(self, rid: int):
        with self._lock:
            return self.engine.reject_reason(rid)

    # -- drain / migration -------------------------------------------------
    def drain_queue(self) -> List[Tuple]:
        with self._lock:
            # engine-owned cancellation: spans finish as "requeued" and
            # the per-request maps are cleaned — popping the scheduler
            # queue raw would leak them for the life of the process
            return [(r.rid, r.prompt, r.max_new_tokens, r.eos_id,
                     r.lane, r.ttft_deadline_s)
                    for r in self.engine.cancel_queued()]

    def snapshot_inflight(self) -> List[Tuple[int, Dict]]:
        with self._lock:
            eng = self.engine
            out = []
            for slot in list(eng.scheduler.active_slots()):
                rid = eng.scheduler.slots[slot].request.rid
                out.append((rid, eng.snapshot_slot(slot)))
                eng.release_slot(slot)
            return out

    def restore(self, snap: Dict, *, parent_span=None) -> int:
        with self._lock:
            return self.engine.restore_slot(snap, parent_span=parent_span)

    def export_prefix_pages(self, digests) -> Optional[Dict]:
        with self._lock:
            return self.engine.export_prefix_pages(digests)

    def import_prefix_pages(self, bundle) -> int:
        with self._lock:
            return self.engine.import_prefix_pages(bundle)

    # -- threaded mode -----------------------------------------------------
    def start(self, idle_sleep_s: float = 0.001) -> "LocalReplica":
        """Background step loop: steps whenever the engine has queued
        or in-flight work, sleeps briefly otherwise. The router keeps
        submitting from its own thread; ``health()`` polls stay safe
        (engine-published snapshots). A raising ``step()`` must NOT
        die silently (the replica would stay routable while its queue
        rots forever): the loop records ``last_error``, marks the
        replica ``failed`` — visible through ``health()`` and
        ``running()`` — and exits, so the router's failure detector
        ejects and redrives."""
        if self._thread is not None:
            raise RuntimeError(f"{self.name} already started")
        if self.failed:
            raise RuntimeError(
                f"{self.name} failed earlier ({self.last_error}); "
                "build a fresh replica instead of restarting this one")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    # locked idle() — the peek races a router-thread
                    # submit otherwise (mid-mutation queue iteration)
                    if self.idle():
                        self._last_beat = self._clock()
                        time.sleep(idle_sleep_s)
                        continue
                    self.step()
                except Exception as e:     # surface, never rot silently
                    self.last_error = f"{type(e).__name__}: {e}"
                    self.failed = True
                    return

        self._thread = threading.Thread(
            target=loop, name=f"fleet-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def running(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self.failed)

    def close(self):
        self.stop()
