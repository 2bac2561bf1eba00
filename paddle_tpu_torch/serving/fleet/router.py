"""Fleet router: prefix-affinity placement over N serving replicas.

One ServingEngine is a hard ceiling; the fleet fronts N of them behind
a single ``submit``/``step`` surface. Placement is two-tier:

1. **Prefix affinity.** The router hashes the prompt's page-aligned
   prefix digests (:func:`~paddle_tpu_torch.serving.paged_cache.
   prompt_prefix_digests` — the SAME content-hash chain
   ``publish_prefix`` commits to each replica's prefix index) and
   counts how many leading pages each replica's advertised digest set
   already holds. The best match wins: shared-system-prompt traffic
   lands where its pages are hot and prefill is skipped, a locality
   signal no generic load balancer has.
2. **Power-of-two-choices.** No replica holds any prefix page (or
   several tie): sample two replicas and take the less loaded by live
   ``health()`` (queue depth + in-flight slots) — the classic
   O(log log n)-imbalance balancer, fed by the snapshot-published
   health the engines expose for exactly this cross-thread poll.

Every request gets a router-minted ``trace_id`` that propagates into
the replica's ``serving.request`` span (``router.route`` /
``router.migrate`` spans carry the same id), so one Perfetto timeline
shows the request crossing the fleet.

Scale-in drains **migrate** instead of killing: queued requests are
re-routed to peers; in-flight slots are snapshotted (sha256-verified
per-page shards), restored into peers' free slots, and resume decode
byte-identically — see :meth:`FleetRouter.drain_replica`.

**Involuntary failure** is the hard counterpart: a replica
that crashes, hangs, or starts throwing is *ejected* — its KV is gone,
so queued requests re-route and in-flight requests are **redriven**:
the router records every request's prompt/budget and polls emitted
tokens each step, so after a crash it resubmits ``prompt +
tokens-observed-so-far`` as the new prompt with the remaining
``max_new_tokens`` budget to a peer (or warm-restores the newest
micro-checkpoint when the engine runs ``snapshot_every_blocks``), then
concatenates the observed prefix onto the peer's output exactly once —
greedy decode is deterministic, so the final token sequence is
bit-identical to a failure-free run. A per-request redrive budget and
deadline awareness turn hopeless requests into structured
:class:`~paddle_tpu_torch.serving.Reject`\\ s (``redrive_budget`` /
``deadline_expired`` / ``no_replica``) — never silent loss. Transient
sickness short of death trips a per-replica
:class:`~paddle_tpu_torch.serving.fleet.CircuitBreaker` (closed → open →
half-open probe → closed) that pauses routing without ejecting; all of
it is driven by the :class:`~paddle_tpu_torch.serving.fleet.FailureDetector`
under one :class:`~paddle_tpu_torch.serving.fleet.FaultPolicy`.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.analysis.concurrency import guarded_by
from paddle_tpu_torch.serving.engine import SlotMigrationError
from paddle_tpu_torch.serving.fleet.faults import (BREAKER_GAUGE,
                                                   CircuitBreaker,
                                                   FailureDetector,
                                                   FaultPolicy,
                                                   ReplicaCrashed,
                                                   ReplicaUnavailable)
from paddle_tpu_torch.serving.paged_cache import prompt_prefix_digests
from paddle_tpu_torch.serving.scheduler import LoadShedError, Reject

# exceptions a peer retry can absorb: transport-shaped failures. A
# ValueError (malformed request) would fail identically everywhere and
# must propagate to the caller instead.
TRANSPORT_ERRORS = (ReplicaCrashed, ReplicaUnavailable, OSError,
                    TimeoutError)


@dataclasses.dataclass
class _FleetRequest:
    """Router-side replay record: everything needed to redrive a
    request after its replica dies. ``observed`` is the token stream
    seen so far (``committed`` — tokens already folded into the current
    submission's prompt by an earlier cold redrive — plus the live
    replica's progress poll)."""

    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    lane: str
    ttft_deadline_s: Optional[float]
    submitted_at: float
    trace_id: int = 0
    redrives: int = 0
    committed: List[int] = dataclasses.field(default_factory=list)
    observed: List[int] = dataclasses.field(default_factory=list)
    checkpoint: Optional[Dict] = None
    # leading prefix pages the routed replica advertised at submit time
    # — compared against the replica's actual shared_tokens at finish to
    # catch stale affinity views (fleet_affinity_miss_total)
    affinity_pages: int = 0


@guarded_by("_view_lock", "_postmortems", "_tiers")
class FleetRouter:
    """Single front door over N :class:`ReplicaHandle` replicas.

    ``submit()`` routes and returns a fleet-level rid; ``step()``
    advances every replica one engine iteration (the synchronous CI
    drive — threaded replicas instead run their own loops) and returns
    ``{fleet_rid: generated tokens}`` for requests that finished.
    ``policy``: ``"affinity"`` (prefix-affinity, power-of-two-choices
    fallback — the default), ``"p2c"`` (balance only), or
    ``"round_robin"`` (the baseline the routing tests beat).
    """

    def __init__(self, replicas: Sequence, *, policy: str = "affinity",
                 registry=None, tracer=None, seed: int = 0,
                 autoscaler=None, faults: Optional[FaultPolicy] = None,
                 clock=time.monotonic,
                 postmortem_dir: Optional[str] = None,
                 shed_spike_threshold: int = 4,
                 prefix_fetch: bool = True):
        if not replicas:
            raise ValueError("need at least one replica")
        if policy not in ("affinity", "p2c", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        self.replicas: List = list(replicas)
        self.policy = policy
        # fleet-global prefix reuse: when the routed replica
        # misses prefix pages a peer advertises, pull the committed
        # pages from the holder instead of re-prefilling
        self.prefix_fetch = bool(prefix_fetch)
        from paddle_tpu_torch import observability as obs
        self._reg = registry or obs.default()
        self.tracer = tracer or obs.tracing.default()
        self._rng = random.Random(seed)
        self.autoscaler = autoscaler
        if autoscaler is not None:
            autoscaler.bind(self)
        self._frids = iter(range(1, 1 << 62))
        self._where: Dict[int, tuple] = {}     # frid -> (replica, lrid)
        self._trace: Dict[int, int] = {}       # frid -> trace_id
        self._rev: Dict[tuple, int] = {}       # (id(rep), lrid) -> frid
        self._results: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._stats: "OrderedDict[int, Dict]" = OrderedDict()
        self._rejects: "OrderedDict[int, Reject]" = OrderedDict()
        self._results_cap = 1024
        self._rr = 0                           # round-robin cursor
        self.migrations_total = 0
        self.handoffs_total = 0
        self.routed_affinity_total = 0
        self.routed_balance_total = 0
        # involuntary-failure machinery: replay records for
        # redrive, a failure detector, and per-replica circuit breakers
        self.faults = FaultPolicy() if faults is None else faults
        self._clock = clock
        self._reqs: Dict[int, _FleetRequest] = {}
        self._detector = FailureDetector(
            max_consecutive_failures=self.faults.max_consecutive_failures,
            probe_timeout_s=self.faults.probe_timeout_s)
        self._breakers: Dict[int, CircuitBreaker] = {}
        self.breaker_transitions: List[tuple] = []  # (replica, old, new)
        self.ejected_total = 0
        self.redrives_total = 0
        # crash flight recorder: every eject / breaker-open /
        # shed spike pulls the victim replica's black box into a bounded
        # bundle ring (served at /debug/postmortem) and, when a dump dir
        # is configured, onto disk for the offline renderer
        self.postmortem_dir = postmortem_dir
        self.shed_spike_threshold = int(shed_spike_threshold)
        # the bundle ring crosses threads: the pump appends in
        # _dump_postmortem while the exposition HTTP thread reads it
        # through postmortems()/health()
        self._view_lock = threading.Lock()
        self._postmortems: "deque" = deque(maxlen=16)
        # serving tier per replica ("prefill"/"decode"/"colocated") —
        # immutable per engine, cached on first successful health().
        # Crosses threads: the pump caches during step()/submit() while
        # the exposition HTTP thread may trigger a lookup via health()
        self._tiers: Dict[int, str] = {}
        self._sheds_since_dump = 0
        self._postmortem_seq = 0

    # -- placement ---------------------------------------------------------

    def _load(self, rep) -> float:
        try:
            h = rep.health()
        except NotImplementedError:
            raise
        except Exception:
            if not self.faults.enabled:
                raise               # fault-free: health errors surface
            return float("inf")     # unreachable: worst possible load
        return (float(h.get("queue_depth", 0))
                + float(h.get("requests_in_flight", 0)))

    def _load_or_zero(self, rep) -> float:
        """Load for witness selection: an unreachable replica must not
        win the max() (it gets its own eject-time postmortem)."""
        load = self._load(rep)
        return 0.0 if load == float("inf") else load

    def _breaker(self, rep) -> CircuitBreaker:
        b = self._breakers.get(id(rep))
        if b is None:
            name = rep.name

            def on_transition(old, new, trace_id, _name=name, _rep=rep):
                self.breaker_transitions.append((_name, old, new))
                self._reg.gauge(
                    "fleet_breaker_state",
                    "per-replica circuit breaker "
                    "(0 closed / 1 half-open / 2 open)").set(
                        BREAKER_GAUGE[new], replica=_name)
                self._reg.counter(
                    "fleet_breaker_transitions_total",
                    "circuit-breaker state transitions").inc(
                        replica=_name, to=new)
                if self.tracer.enabled:
                    # on the triggering request's original trace id, so
                    # the breaker flip lands on that request's timeline
                    self.tracer.record_span(
                        "fleet.breaker", duration_s=0.0,
                        trace_id=trace_id or None, replica=_name,
                        **{"from": old, "to": new})
                if new == CircuitBreaker.OPEN:
                    # a sick-but-alive replica testifies at the moment
                    # the fleet stops trusting it
                    self._dump_postmortem(
                        _rep, "breaker_open",
                        trace_ids=(int(trace_id),) if trace_id else ())

            b = CircuitBreaker(threshold=self.faults.breaker_threshold,
                               cooldown_s=self.faults.breaker_cooldown_s,
                               clock=self._clock,
                               on_transition=on_transition)
            self._breakers[id(rep)] = b
        return b

    def is_routable(self, rep) -> bool:
        """Can new work land here? Draining and breaker-open replicas
        are not routable (an open breaker past its cooldown half-opens
        here, becoming probe-routable)."""
        if getattr(rep, "draining", False):
            return False
        if not self.faults.enabled:
            return True
        b = self._breakers.get(id(rep))
        if b is None:
            return True
        b.poll()
        return b.state != CircuitBreaker.OPEN

    def routable_count(self) -> int:
        """Effective capacity: replicas new work can land on. The
        autoscaler reads this — an open breaker or an ejection is lost
        capacity a replacement spawn restores."""
        return sum(1 for r in self.replicas if self.is_routable(r))

    def _candidates(self, exclude=None):
        cands = [r for r in self.replicas
                 if not getattr(r, "draining", False) and r is not exclude]
        if not self.faults.enabled:
            return cands
        return [r for r in cands if self._breaker(r).allow()]

    # -- disaggregation -----------------------------------------

    def replica_tier(self, rep) -> str:
        """Serving tier of one replica: ``"prefill"``, ``"decode"``, or
        ``"colocated"``. The tier is fixed at engine construction, so
        the first successful ``health()`` read is cached; an
        unreachable replica reads as ``"colocated"`` WITHOUT caching
        (the next call re-asks). A failed read here is a transport
        failure like any other: it feeds the breaker and the
        consecutive-failure count exactly as a probe failure would —
        swallowing it would let the tier lookup silently absorb health
        flakes the detection loop needs to see. A breaker-open replica
        is already quarantined and is not asked at all."""
        with self._view_lock:
            tier = self._tiers.get(id(rep))
        if tier is not None:
            return tier
        if self.faults.enabled:
            b = self._breakers.get(id(rep))
            if b is not None and b.state == CircuitBreaker.OPEN:
                return "colocated"
        try:
            h = rep.health()
        except NotImplementedError:
            raise
        except Exception as e:
            if not self.faults.enabled:
                raise
            if not isinstance(e, ReplicaCrashed):
                self._breaker(rep).record_failure()
            reason = self._detector.observe_failure(rep.name, e)
            if reason is not None and rep in self.replicas:
                self.eject_replica(rep, reason=reason)
            return "colocated"
        tier = str(h.get("tier") or "colocated")
        with self._view_lock:
            self._tiers[id(rep)] = tier
        return tier

    def _prompt_candidates(self, exclude=None):
        """Candidates for a FRESH prompt. Decode-tier replicas only
        take restored prefill-complete slots — routing them a prompt
        would be refused by the engine anyway (``ValueError``), so they
        are filtered here and the router never even tries."""
        return [r for r in self._candidates(exclude)
                if self.replica_tier(r) != "decode"]

    def _flops_headroom(self, rep) -> float:
        """Prefill placement signal: the flops headroom the engine's
        resource plane publishes (1 = idle compute, 0 = saturated)."""
        try:
            h = rep.health()
        except NotImplementedError:
            raise
        except Exception:
            if not self.faults.enabled:
                raise
            return -1.0
        return float((h.get("headroom") or {}).get("flops", 0.0))

    def _decode_headroom(self, rep) -> float:
        """Decode placement signal: a restored slot needs pages AND a
        free slot, so the binding resource is the min of the two
        headrooms."""
        try:
            h = rep.health()
        except NotImplementedError:
            raise
        except Exception:
            if not self.faults.enabled:
                raise
            return -1.0
        hd = h.get("headroom") or {}
        return min(float(hd.get("pages", 0.0)),
                   float(hd.get("slots", 0.0)))

    def _pick_p2c(self, cands):
        if len(cands) == 1:
            return cands[0]
        a, b = self._rng.sample(cands, 2)
        return a if self._load(a) <= self._load(b) else b

    def _route(self, prompt, exclude=None):
        """(replica, affinity_pages) for this prompt. Routes PROMPTS,
        so decode-tier replicas are never candidates; in a
        disaggregated fleet the prefill tier is preferred and the
        balance pick is by flops headroom (prefill is flops-bound —
        queue depth alone misreads a replica mid-chunked-prefill)."""
        cands = self._prompt_candidates(exclude)
        if not cands:
            raise SlotMigrationError("no routable replica")
        pre = [r for r in cands
               if self.replica_tier(r) == "prefill"]
        tiered = bool(pre)
        if tiered:
            cands = pre
        if self.faults.enabled:
            # a half-open breaker needs its probe request SENT, not
            # left to sampling chance: route the next request there
            # deliberately (allow() bounds it to one probe in flight)
            for r in cands:
                b = self._breakers.get(id(r))
                if b is not None and b.state == CircuitBreaker.HALF_OPEN:
                    b.note_probe()
                    return r, 0
        if self.policy == "round_robin":
            rep = cands[self._rr % len(cands)]
            self._rr += 1
            return rep, 0
        if self.policy == "affinity":
            digests = prompt_prefix_digests(
                prompt, cands[0].page_size())
            if digests:
                best, best_hits = None, 0
                for r in cands:
                    held = r.prefix_digests()
                    hits = 0
                    for d in digests:       # leading run only: pages
                        if d not in held:   # map in order or not at all
                            break
                        hits += 1
                    if hits > best_hits or (hits == best_hits and hits
                                            and best is not None
                                            and self._load(r)
                                            < self._load(best)):
                        best, best_hits = r, hits
                if best is not None and best_hits > 0:
                    self.routed_affinity_total += 1
                    return best, best_hits
        rep = (max(cands, key=self._flops_headroom) if tiered
               else self._pick_p2c(cands))
        self.routed_balance_total += 1
        return rep, 0

    # -- request surface ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, *, lane: str = "default",
               ttft_deadline_s: Optional[float] = None) -> int:
        """Route and enqueue; returns the fleet rid. A replica that
        load-sheds is retried on the remaining replicas in load order
        before the shed propagates — one hot replica must not turn
        away traffic the rest of the fleet could serve."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rep, hits = self._route(prompt)
        span = None
        if self.tracer.enabled:
            span = self.tracer.start_span(
                "router.route", lane=lane,
                prompt_tokens=int(prompt.shape[0]))
        trace_id = span.trace_id if span is not None else 0
        enabled = self.faults.enabled
        tried = []
        try:
            while True:
                try:
                    lrid = rep.submit(
                        prompt, max_new_tokens, eos_id, lane=lane,
                        ttft_deadline_s=ttft_deadline_s,
                        trace_id=trace_id or None)
                    self._note_transport_success(rep, trace_id)
                    break
                except LoadShedError:
                    # a shed proves the replica is ALIVE: the breaker
                    # tracks transport health, not load
                    if enabled:
                        self._breaker(rep).record_success(trace_id)
                    tried.append(rep)
                    rest = [r for r in self._prompt_candidates()
                            if r not in tried]
                    if not rest:
                        if span is not None:
                            span.finish(status="shed")
                        raise
                    rest.sort(key=self._load)
                    rep, hits = rest[0], 0
                except TRANSPORT_ERRORS as e:
                    if not enabled:
                        raise
                    self._note_transport_failure(rep, e, trace_id)
                    tried.append(rep)
                    rest = [r for r in self._prompt_candidates()
                            if r not in tried]
                    if not rest:
                        if span is not None:
                            span.finish(status="error")
                        raise
                    rest.sort(key=self._load)
                    rep, hits = rest[0], 0
        except Exception:
            if span is not None and span.end is None:
                span.finish(status="error")
            raise
        fetched = self._prefix_fetch(rep, hits, prompt, trace_id)
        frid = next(self._frids)
        self._where[frid] = (rep, lrid)
        self._rev[(id(rep), lrid)] = frid
        self._reqs[frid] = _FleetRequest(
            prompt=prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            lane=lane, ttft_deadline_s=ttft_deadline_s,
            submitted_at=self._clock(), trace_id=trace_id,
            affinity_pages=hits + fetched)
        if trace_id:
            self._trace[frid] = trace_id
        if span is not None:
            span.set_attrs(replica=rep.name, fleet_rid=frid,
                           affinity_pages=hits,
                           policy=("affinity" if hits
                                   else ("round_robin"
                                         if self.policy == "round_robin"
                                         else "p2c")))
            span.finish()
        self._reg.counter("fleet_requests_total",
                          "requests routed by the fleet router").inc(
                              replica=rep.name)
        if hits:
            self._reg.counter(
                "fleet_affinity_routed_total",
                "requests placed by prefix affinity").inc()
        return frid

    def _prefix_fetch(self, target, hits: int, prompt,
                      trace_id: int = 0) -> int:
        """Fleet-global prefix reuse: when the routed
        replica misses leading prefix pages a peer advertises, pull the
        committed pages from the holder as hash-chained migration
        shards and install them on the target BEFORE its next admission
        — re-use instead of re-prefill. Strictly best-effort: a holder
        that drained, crashed, or got autoscaled away mid-fetch, and a
        bundle the importer refuses, all degrade to local re-prefill
        with a structured marker. The request itself is never touched.
        Returns pages installed on the target."""
        if not self.prefix_fetch:
            return 0
        try:
            digests = prompt_prefix_digests(prompt, target.page_size())
        except TRANSPORT_ERRORS:
            return 0
        if not digests:
            return 0
        holders = []
        for r in self.replicas:
            if r is target:
                continue
            # draining replicas stay candidates: a drain refuses NEW
            # work, but exporting committed pages is a read — exactly
            # the window where a drained replica's prefixes must
            # survive by copying out
            try:
                held = r.prefix_digests()
            except NotImplementedError:
                raise
            except Exception:
                continue        # unreachable holder: not a candidate
            run = 0
            for d in digests:   # leading run only, like _route
                if d not in held:
                    break
                run += 1
            if run > hits:
                holders.append((run, r))
        if not holders:
            return 0
        holders.sort(key=lambda t: -t[0])
        t0 = self._clock()
        for run, holder in holders:
            try:
                bundle = holder.export_prefix_pages(digests[:run])
            except TRANSPORT_ERRORS as e:
                # the holder died/drained mid-fetch: breaker + detector
                # see it like any transport failure, next holder serves
                if self.faults.enabled:
                    self._note_transport_failure(holder, e, trace_id)
                self._reg.counter(
                    "fleet_prefix_fetch_failed_total",
                    "prefix-page fetches failed before install").inc(
                        reason="transport")
                continue
            if bundle is None:
                # stale advertisement: the pages left the holder
                # between the scan and the export
                self._reg.counter(
                    "fleet_prefix_fetch_failed_total",
                    "prefix-page fetches failed before install").inc(
                        reason="gone")
                continue
            self._note_transport_success(holder, trace_id)
            try:
                installed = target.import_prefix_pages(bundle)
            except SlotMigrationError as e:
                # corrupt or unprovable bundle REFUSED by the importer
                # — never installed, never decoded from
                self._reg.counter(
                    "fleet_prefix_fetch_refused_total",
                    "prefix bundles refused by the importer "
                    "(corrupt or incompatible)").inc()
                self._degrade_prefix_fetch(target, holder, trace_id,
                                           str(e))
                return 0
            except TRANSPORT_ERRORS as e:
                # the TARGET failed mid-install: the request's own
                # redrive machinery owns that failure, not the fetch
                if self.faults.enabled:
                    self._note_transport_failure(target, e, trace_id)
                self._degrade_prefix_fetch(target, holder, trace_id,
                                           type(e).__name__)
                return 0
            if installed:
                self._reg.counter(
                    "fleet_prefix_fetch_total",
                    "prefix-page fetch transfers completed").inc(
                        src=holder.name, dst=target.name)
                self._reg.counter(
                    "fleet_prefix_fetch_pages_total",
                    "prefix pages installed from fleet peers").inc(
                        installed)
                self._reg.counter(
                    "fleet_prefix_fetch_bytes_total",
                    "prefix-page bytes shipped between replicas").inc(
                        int(bundle.get("bytes") or 0))
                if self.tracer.enabled:
                    self.tracer.record_span(
                        "router.prefix_fetch",
                        duration_s=self._clock() - t0,
                        trace_id=trace_id or None, src=holder.name,
                        dst=target.name, pages=installed,
                        status="fetched")
            return installed
        self._degrade_prefix_fetch(target, None, trace_id,
                                   "no holder reachable")
        return 0

    def _degrade_prefix_fetch(self, target, holder, trace_id: int,
                              reason: str):
        """Structured degrade marker: the fetch failed, the request
        re-prefills locally — visible as a counter and a span, never an
        error on the request."""
        self._reg.counter(
            "fleet_prefix_fetch_degraded_total",
            "prefix fetches degraded to local re-prefill").inc()
        if self.tracer.enabled:
            self.tracer.record_span(
                "router.prefix_fetch", duration_s=0.0,
                trace_id=trace_id or None, dst=target.name,
                src=holder.name if holder is not None else "",
                status="degraded_local_prefill", reason=reason)

    def _note_transport_failure(self, rep, exc, trace_id: int = 0):
        """Breaker + detector accounting for a transport-shaped
        failure; ejects the replica when the detector declares death."""
        self._breaker(rep).record_failure(trace_id)
        reason = self._detector.observe_failure(rep.name, exc)
        if reason is not None and rep in self.replicas:
            self.eject_replica(rep, reason=reason)

    def _note_transport_success(self, rep, trace_id: int = 0):
        """EVERY successful transport interaction must feed the
        breaker — a half-open probe can be delivered by any submit /
        restore path (redrive included), and a success that goes
        unrecorded leaves the breaker stuck half-open with its one
        probe permanently in flight."""
        if self.faults.enabled:
            self._detector.observe_success(rep.name)
            self._breaker(rep).record_success(trace_id)

    def _probe(self, rep) -> Optional[str]:
        """Health-probe one replica; returns a death reason or None.
        Probe exceptions feed the circuit breaker AND count toward the
        consecutive-failure threshold (with breaker_threshold below
        max_consecutive_failures, a transiently flaky health endpoint
        quarantines behind the breaker before the death verdict fires);
        a successful probe can still carry a terminal verdict
        (replica-surfaced loop crash, stale heartbeat with work
        pending)."""
        try:
            h = rep.health()
        except NotImplementedError:
            raise
        except Exception as e:
            if not isinstance(e, ReplicaCrashed):
                self._breaker(rep).record_failure()
            return self._detector.observe_failure(rep.name, e)
        return self._detector.check_health(rep.name, h)

    def _poll_progress(self, rep):
        """Record each in-flight request's emitted tokens (and newest
        micro-checkpoint) into its replay record, so a later crash of
        this replica cannot take the progress with it. The poll is
        incremental — ``progress(since=...)`` returns only tokens past
        what the record already holds, so tracking costs O(new tokens)
        per step, not O(stream length)."""
        rid_key = id(rep)
        since: Dict[int, int] = {}
        recs: Dict[int, _FleetRequest] = {}
        for (okey, lrid), frid in self._rev.items():
            if okey != rid_key:
                continue
            rec = self._reqs.get(frid)
            if rec is not None:
                recs[lrid] = rec
                since[lrid] = len(rec.observed) - len(rec.committed)
        try:
            prog = rep.progress(since)
            cps = rep.poll_checkpoints()
        except NotImplementedError:
            raise
        except Exception:
            return                  # dying replica: keep last knowns
        for lrid, tail in prog.items():
            rec = recs.get(lrid)
            if rec is None:
                continue
            if getattr(tail, "full_replay", False):
                # the replica answered a stale cursor with the whole
                # stream (progress contract hardening): REPLACE the
                # live portion of the record — extending would
                # double-count every token already held
                rec.observed = list(rec.committed) + [int(t)
                                                      for t in tail]
            else:
                rec.observed.extend(int(t) for t in tail)
        for lrid, snap in cps:
            rec = recs.get(lrid)
            if rec is not None:
                rec.checkpoint = snap

    def _reconcile_rejects(self, rep):
        """A replica's engine can shed a queued request on its own
        (TTFT deadline expired before admission). Its step() never
        returns that rid, so without this poll the request would be
        silently lost at the fleet level — here the engine's structured
        verdict is lifted into ``router.reject_reason`` and the replay
        record is cleaned."""
        rid_key = id(rep)
        mine = [(frid, lrid) for (okey, lrid), frid
                in list(self._rev.items()) if okey == rid_key]
        for frid, lrid in mine:
            try:
                rej = rep.reject_reason(lrid)
            except NotImplementedError:
                raise
            except Exception:
                return              # dying replica: eject path handles it
            if rej is None:
                continue
            self._rev.pop((rid_key, lrid), None)
            self._where.pop(frid, None)
            rec = self._reqs.pop(frid, None)
            self._rejects[frid] = rej
            while len(self._rejects) > self._results_cap:
                self._rejects.popitem(last=False)
            tid = (rec.trace_id if rec is not None
                   else self._trace.get(frid, 0))
            self._trace.pop(frid, None)
            self._reg.counter(
                "fleet_replica_shed_total",
                "requests shed by a replica's own engine after "
                "queueing, surfaced as fleet rejects").inc(
                    reason=rej.reason)
            if self.tracer.enabled:
                self.tracer.record_span(
                    "router.replica_shed", duration_s=0.0,
                    status="shed", trace_id=tid or None,
                    replica=rep.name, reason=rej.reason)

    def step(self) -> Dict[int, np.ndarray]:
        """One synchronous fleet iteration: every replica steps once;
        finished requests come back under their fleet rids. Runs the
        autoscaler's ``tick()`` when one is attached.

        With ``faults.enabled`` this is also the detection loop: each
        replica is health-probed (probe exception / replica-surfaced
        loop crash / stale heartbeat with work pending), step
        exceptions count toward the consecutive-failure threshold
        (:class:`ReplicaCrashed` is immediately terminal), and a death
        verdict triggers :meth:`eject_replica` — queued requests
        re-route, in-flight requests redrive exactly-once."""
        finished: Dict[int, np.ndarray] = {}
        enabled = self.faults.enabled
        for rep in list(self.replicas):
            if rep not in self.replicas:
                continue            # ejected by an earlier iteration
            if enabled:
                # a breaker-open replica is already quarantined: keep
                # stepping its in-flight work but stop health-probing
                # it, so a transient flake cannot walk the consecutive
                # count to the death verdict while the breaker holds
                b = self._breakers.get(id(rep))
                if b is None or b.state != CircuitBreaker.OPEN:
                    reason = self._probe(rep)
                    if reason is not None:
                        self.eject_replica(rep, reason=reason)
                        continue
            try:
                if rep.idle():
                    continue
                out = rep.step()
            except NotImplementedError:
                raise
            except Exception as e:
                if not enabled:
                    raise
                self._reg.counter(
                    "fleet_step_failures_total",
                    "replica step()/idle() exceptions seen by the "
                    "router").inc(replica=rep.name)
                reason = self._detector.observe_failure(rep.name, e)
                if reason is not None:
                    self.eject_replica(rep, reason=reason)
                continue
            if enabled:
                self._detector.observe_success(rep.name)
            for lrid, toks in out.items():
                finished.update(self._finish(rep, lrid, toks))
            if enabled:
                self._poll_progress(rep)
                self._reconcile_rejects(rep)
        self._pump_handoffs()
        if self.autoscaler is not None:
            self.autoscaler.tick()
        return finished

    # -- prefill -> decode streaming ----------------------------

    def _pump_handoffs(self):
        """Drain every prefill-tier replica's handoff outbox and place
        each prefill-complete slot onto the decode tier. Runs every
        fleet step regardless of ``faults.enabled`` — disaggregation is
        a serving mode, not a fault feature."""
        for rep in list(self.replicas):
            if rep not in self.replicas:
                continue            # ejected mid-sweep
            if self.replica_tier(rep) != "prefill":
                continue
            try:
                handoffs = rep.poll_handoffs()
            except NotImplementedError:
                raise
            except Exception as e:
                if not self.faults.enabled:
                    raise
                # the slots were snapshotted-or-kept atomically by the
                # engine, so a crash here loses no request: the eject
                # path redrives from the replay records
                reason = self._detector.observe_failure(rep.name, e)
                if reason is not None and rep in self.replicas:
                    self.eject_replica(rep, reason=reason)
                continue
            for lrid, snap in handoffs:
                self._place_handoff(rep, lrid, snap)

    def _place_handoff(self, src, lrid, snap):
        """Place one prefill-complete snapshot onto the decode replica
        with the most page/slot headroom (decode is bandwidth-bound —
        the binding resource is KV capacity, not compute). Placement
        failure falls back to restoring the snapshot into the SOURCE
        with the ``decode_in_place`` marker — the prefill engine
        finishes the decode itself rather than losing the request; if
        even the source cannot take it back, the request redrives from
        its replay record. A handoff NEVER loses a request."""
        frid = self._rev.pop((id(src), lrid), None)
        if frid is not None:
            self._where.pop(frid, None)
        tid = int(snap.get("trace_id") or 0)
        span = None
        if self.tracer.enabled:
            span = self.tracer.start_span(
                "router.handoff", trace_id=tid or None, src=src.name)
        nbytes = sum(int(m.get("bytes", 0))
                     for m in snap.get("manifest", ()))
        decoders = sorted(
            (r for r in self._candidates(exclude=src)
             if self.replica_tier(r) == "decode"),
            key=self._decode_headroom, reverse=True)
        for peer in decoders:
            try:
                nrid = peer.restore(snap, parent_span=span)
            except NotImplementedError:
                raise
            except SlotMigrationError:
                continue            # no capacity there: next decoder
            except TRANSPORT_ERRORS as e:
                if not self.faults.enabled:
                    raise
                self._note_transport_failure(peer, e, tid)
                continue
            self._note_transport_success(peer, tid)
            if frid is not None:
                self._where[frid] = (peer, nrid)
                self._rev[(id(peer), nrid)] = frid
                rec = self._reqs.get(frid)
                if rec is not None:
                    rec.observed = list(rec.committed) + [
                        int(t) for t in snap["state"]["generated"]]
            self.handoffs_total += 1
            self._reg.counter(
                "fleet_handoff_total",
                "prefill-complete slots streamed to the decode "
                "tier").inc(src=src.name, dst=peer.name)
            self._reg.counter(
                "fleet_handoff_bytes_total",
                "sha256-verified page bytes shipped prefill -> "
                "decode").inc(nbytes, src=src.name, dst=peer.name)
            if span is not None:
                span.set_attrs(dst=peer.name, bytes=nbytes,
                               kv_tokens=int(snap["state"]["length"]))
                span.finish()
            return
        back = dict(snap)
        back["decode_in_place"] = True
        try:
            nrid = src.restore(back, parent_span=span)
        except NotImplementedError:
            raise
        except Exception:
            # source slot already freed and unplaceable anywhere: the
            # replay record (prompt + observed tokens) redrives it —
            # structured Reject at worst, never silent loss
            if span is not None:
                span.finish(status="redrive")
            if frid is not None:
                rec = self._reqs.get(frid)
                if rec is not None:
                    rec.observed = list(rec.committed) + [
                        int(t) for t in snap["state"]["generated"]]
                self._redrive(frid, src=src.name)
            return
        if frid is not None:
            self._where[frid] = (src, nrid)
            self._rev[(id(src), nrid)] = frid
        self._reg.counter(
            "fleet_handoff_fallback_total",
            "handoffs decoded in place on the prefill tier (no "
            "decode capacity)").inc(replica=src.name)
        if span is not None:
            span.finish(status="decode_in_place")

    def _finish(self, rep, lrid, toks) -> Dict[int, np.ndarray]:
        frid = self._rev.pop((id(rep), lrid), None)
        if frid is None:
            return {}
        self._where.pop(frid, None)
        rec = self._reqs.pop(frid, None)
        if rec is not None and rec.committed:
            # dedup on assembly (exactly-once): tokens a cold redrive
            # folded into the resubmitted prompt come back EXACTLY once,
            # prepended here — the peer only generated the remainder
            toks = np.concatenate([
                np.asarray(rec.committed, np.int32),
                np.asarray(toks, np.int32).reshape(-1)])
        st = rep.request_stats(lrid)
        if st is not None:
            st["replica"] = rep.name
            if rec is not None and rec.redrives:
                st["redrives"] = rec.redrives
            self._stats[frid] = st
            if rec is not None and rec.affinity_pages \
                    and not rec.redrives \
                    and not float(st.get("shared_tokens") or 0.0):
                # stale affinity view: routing promised
                # shared pages the replica no longer held at admission
                # — prefix_gen propagation should keep this at zero
                self._reg.counter(
                    "fleet_affinity_miss_total",
                    "affinity-routed requests that mapped no shared "
                    "pages on arrival").inc()
        rep.result(lrid)                      # drop the replica's copy
        self._results[frid] = toks
        while len(self._results) > self._results_cap:
            self._results.popitem(last=False)
        while len(self._stats) > self._results_cap:
            self._stats.popitem(last=False)
        self._trace.pop(frid, None)
        return {frid: toks}

    def run_until_idle(self, max_steps: Optional[int] = None
                       ) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        steps = 0
        while not self.idle():
            out.update(self.step())
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"fleet not idle in {max_steps} steps")
        return out

    def idle(self) -> bool:
        for r in self.replicas:
            try:
                if not r.idle():
                    return False
            except NotImplementedError:
                raise
            except Exception:
                if self.faults.enabled:
                    return False    # not idle: step() must eject it
                raise
        return True

    def result(self, frid: int) -> Optional[np.ndarray]:
        return self._results.pop(frid, None)

    def reject_reason(self, frid: int) -> Optional[Reject]:
        """Structured verdict for a request the fleet shed after
        acceptance (redrive budget spent, deadline expired before any
        token, or no replica left) — pop-on-read, mirroring
        ``ServingEngine.reject_reason``. A request is NEVER silently
        lost: it has a result or a reject."""
        return self._rejects.pop(frid, None)

    def request_stats(self, frid: int) -> Optional[Dict]:
        return self._stats.pop(frid, None)

    def progress(self, frid: int) -> Optional[List[int]]:
        """Tokens observed so far for an in-flight request (committed
        redrive prefix + the live replica's progress polls) — the
        incremental-token feed the streaming front door delivers from.
        None once the request has finished, shed, or was never
        accepted; non-destructive, unlike ``result``."""
        rec = self._reqs.get(frid)
        return None if rec is None else list(rec.observed)

    def trace_id(self, frid: int) -> int:
        return self._trace.get(frid, 0)

    def health(self) -> Dict[str, object]:
        """Fleet-level aggregation of every replica's health snapshot
        (the fleet ``/healthz`` payload). The fault-tolerance section
        carries per-replica breaker states, routable capacity, and the
        eject/redrive totals; ``degraded`` is set while any breaker is
        open or half-open, which the exposition endpoint surfaces as
        HTTP 503."""
        # called from the exposition HTTP thread while the pump mutates
        # the fleet: snapshot the replica list once so add/eject mid-
        # iteration can't blow up the scrape
        reps = list(self.replicas)
        per = {}
        for r in reps:
            try:
                per[r.name] = r.health()
            except NotImplementedError:
                raise
            except Exception as e:
                if not self.faults.enabled:
                    raise           # fault-free: health errors surface
                per[r.name] = {"error": f"{type(e).__name__}: {e}"}
        occ = [float(h.get("slot_occupancy", 0.0)) for h in per.values()]
        breakers = {r.name: self._breakers[id(r)].status()
                    for r in reps if id(r) in self._breakers}
        with self._view_lock:
            n_postmortems = len(self._postmortems)
        return {
            "replicas": len(reps),
            # chips behind the fleet: a tp=4 replica is 4
            # chips of capacity — the autoscaler and /healthz must not
            # read it as one
            "chips_total": sum(int(h.get("mesh_devices", 1) or 1)
                               for h in per.values()),
            "queue_depth_total": sum(int(h.get("queue_depth", 0) or 0)
                                     for h in per.values()),
            "requests_in_flight": sum(
                int(h.get("requests_in_flight", 0) or 0)
                for h in per.values()),
            "slot_occupancy_mean": (sum(occ) / len(occ)) if occ else 0.0,
            "recompiles": sum(int(h.get("recompiles", 0) or 0)
                              for h in per.values()),
            "migrations_total": self.migrations_total,
            "handoffs_total": self.handoffs_total,
            "routable": self.routable_count(),
            "ejected_total": self.ejected_total,
            "redrives_total": self.redrives_total,
            "postmortems": n_postmortems,
            "breakers": breakers,
            "degraded": any(b["state"] != CircuitBreaker.CLOSED
                            for b in breakers.values()),
            "per_replica": per,
        }

    # -- elasticity --------------------------------------------------------

    def add_replica(self, rep):
        """Attach an already-warmed replica (the autoscaler precompiles
        via ``warmup_plan`` BEFORE the replica takes traffic)."""
        self.replicas.append(rep)
        self._reg.gauge("fleet_replicas",
                        "replicas serving traffic").set(
                            len(self.replicas))

    def eject_replica(self, rep, *, reason: str = "crashed") -> int:
        """Hard removal of a dead replica — the involuntary counterpart
        of :meth:`drain_replica`. Its KV is gone, so nothing can be
        migrated: queued requests re-route and in-flight requests are
        **redriven** from the router's replay records (warm-restore of
        the newest micro-checkpoint when one exists, else resubmit
        ``prompt + tokens-observed-so-far`` with the remaining budget).
        Greedy decode is deterministic, so redriven outputs are
        bit-identical to a failure-free run; requests that cannot be
        redriven (budget spent, deadline expired, no replica left) shed
        with a structured :class:`~paddle_tpu_torch.serving.Reject` — never
        silently lost. Returns the number of requests redriven or
        shed."""
        if rep not in self.replicas:
            return 0
        rep.draining = True         # never a redrive target
        victims = [(frid, lrid)
                   for (okey, lrid), frid in list(self._rev.items())
                   if okey == id(rep)]
        for frid, lrid in victims:
            self._rev.pop((id(rep), lrid), None)
            self._where.pop(frid, None)
        self.replicas.remove(rep)
        self.ejected_total += 1
        self._breakers.pop(id(rep), None)
        self._reg.counter(
            "fleet_ejected_total",
            "replicas declared dead and removed").inc(
                reason=reason.split(":", 1)[0])
        self._reg.gauge("fleet_replicas",
                        "replicas serving traffic").set(
                            len(self.replicas))
        if self.tracer.enabled:
            self.tracer.record_span(
                "router.eject", duration_s=0.0, replica=rep.name,
                reason=reason, requests=len(victims))
        # flight recorder: the black box comes off BEFORE close() —
        # victim trace ids link the bundle to every redriven request's
        # timeline
        tids = []
        for frid, _lrid in victims:
            rec = self._reqs.get(frid)
            tid = ((rec.trace_id if rec is not None else 0)
                   or self._trace.get(frid, 0))
            if tid:
                tids.append(int(tid))
        self._dump_postmortem(
            rep, "eject", trace_ids=tids,
            extra={"cause": reason, "victims": len(victims)})
        try:
            rep.close()             # best-effort: it is already dead
        except Exception:
            pass
        for frid, _lrid in victims:
            self._redrive(frid, src=rep.name)
        return len(victims)

    def _dump_postmortem(self, rep, reason: str, *, trace_ids=(),
                         extra=None):
        """Pull ``rep``'s flight-recorder black box into the router's
        bounded bundle ring (and onto ``postmortem_dir`` when one is
        configured, for the offline renderer). Best-effort by design:
        postmortem capture must never turn one failure into two."""
        try:
            bundle = rep.postmortem(reason, trace_ids=trace_ids)
        except NotImplementedError:
            raise
        except Exception:
            bundle = None
        if bundle is None:
            return None
        if extra:
            bundle.setdefault("extra", {}).update(extra)
        with self._view_lock:
            self._postmortems.append(bundle)
        self._postmortem_seq += 1
        self._reg.counter(
            "fleet_postmortems_total",
            "postmortem bundles captured by the router").inc(
                reason=reason)
        if self.tracer.enabled:
            self.tracer.record_span(
                "router.postmortem", duration_s=0.0, replica=rep.name,
                reason=reason, victims=len(tuple(trace_ids)))
        if self.postmortem_dir:
            from paddle_tpu_torch.observability import flight as _flight
            try:
                os.makedirs(self.postmortem_dir, exist_ok=True)
                path = os.path.join(
                    self.postmortem_dir,
                    f"postmortem_{self._postmortem_seq:04d}_"
                    f"{rep.name}.json")
                _flight.write_bundle(bundle, path)
            except OSError:
                pass                # capture survives a full disk
        return bundle

    def postmortems(self, limit: Optional[int] = None) -> List[Dict]:
        """Captured postmortem bundles, oldest first (bounded ring) —
        the ``/debug/postmortem`` payload source (HTTP thread)."""
        with self._view_lock:
            out = list(self._postmortems)
        return out[-limit:] if limit else out

    def _redrive(self, frid: int, *, src: str = "?"):
        """Exactly-once redrive of one request whose replica died."""
        rec = self._reqs.get(frid)
        if rec is None:             # already finished or never recorded
            self._trace.pop(frid, None)
            return
        tid = rec.trace_id or self._trace.get(frid, 0)
        observed = list(rec.observed)
        # the observed stream may already be complete (the replica died
        # between emitting the last token and reporting the finish):
        # deliver it directly, exactly once
        if rec.eos_id is not None and rec.eos_id in observed:
            observed = observed[:observed.index(rec.eos_id) + 1]
            return self._finish_from_observed(frid, rec, observed, src)
        if len(observed) >= rec.max_new_tokens:
            return self._finish_from_observed(
                frid, rec, observed[:rec.max_new_tokens], src)
        rec.redrives += 1
        if rec.redrives > self.faults.max_redrives:
            return self._shed_redrive(frid, rec, "redrive_budget", src)
        # deadline awareness: once the first token was observed the TTFT
        # deadline is already met; before that, an expired deadline
        # sheds with a structured reason instead of redriving a request
        # nobody is waiting for
        deadline = None
        if rec.ttft_deadline_s is not None and not observed:
            dl_at = rec.submitted_at + rec.ttft_deadline_s
            now = self._clock()
            if now > dl_at:
                return self._shed_redrive(frid, rec, "deadline_expired",
                                          src)
            deadline = dl_at - now
        # warm path: restore the newest micro-checkpoint into a peer —
        # KV travels, only the post-checkpoint tail re-decodes
        if rec.checkpoint is not None:
            snap, rec.checkpoint = rec.checkpoint, None  # consume once
            span = None
            if self.tracer.enabled:
                span = self.tracer.start_span(
                    "router.redrive", trace_id=tid or None, mode="warm",
                    src=src, tokens_observed=len(observed))
            for peer in sorted(self._candidates(), key=self._load):
                try:
                    nrid = peer.restore(snap, parent_span=span)
                except NotImplementedError:
                    raise
                except Exception:
                    continue        # corrupt / no capacity / dying peer
                self._note_transport_success(peer, tid)
                self._where[frid] = (peer, nrid)
                self._rev[(id(peer), nrid)] = frid
                # the restored slot carries its generated tokens; the
                # observed stream continues from the snapshot's state
                rec.observed = list(rec.committed) + [
                    int(t) for t in snap["state"]["generated"]]
                self.redrives_total += 1
                self._reg.counter(
                    "fleet_redrive_total",
                    "in-flight requests redriven after replica "
                    "death").inc(mode="warm")
                if span is not None:
                    span.set_attrs(dst=peer.name)
                    span.finish()
                return
            if span is not None:
                span.finish(status="fallback_cold")
        # cold path: resubmit prompt + observed as the new prompt with
        # the remaining budget — greedy determinism makes the
        # continuation identical to the uninterrupted run
        if observed:
            new_prompt = np.concatenate([
                rec.prompt, np.asarray(observed, np.int32)])
        else:
            new_prompt = rec.prompt
        remaining = rec.max_new_tokens - len(observed)
        try:
            first, _hits = self._route(new_prompt)
        except SlotMigrationError:
            return self._shed_redrive(frid, rec, "no_replica", src)
        others = sorted((r for r in self._prompt_candidates()
                         if r is not first), key=self._load)
        last_shed: Optional[LoadShedError] = None
        for peer in [first] + others:
            try:
                nrid = peer.submit(new_prompt, remaining, rec.eos_id,
                                   lane=rec.lane,
                                   ttft_deadline_s=deadline,
                                   trace_id=tid or None)
            except LoadShedError as e:
                # alive but loaded: close-probe accounting, then move on
                if self.faults.enabled:
                    self._breaker(peer).record_success(tid)
                last_shed = e
                continue
            except NotImplementedError:
                raise
            except TRANSPORT_ERRORS as e:
                self._note_transport_failure(peer, e, tid)
                continue
            except Exception:
                continue            # dying peer: its own probe ejects it
            self._note_transport_success(peer, tid)
            self._where[frid] = (peer, nrid)
            self._rev[(id(peer), nrid)] = frid
            rec.committed = list(observed)
            rec.observed = list(observed)
            self.redrives_total += 1
            self._reg.counter(
                "fleet_redrive_total",
                "in-flight requests redriven after replica death").inc(
                    mode="cold")
            if self.tracer.enabled:
                self.tracer.record_span(
                    "router.redrive", duration_s=0.0,
                    trace_id=tid or None, mode="cold", src=src,
                    dst=peer.name, tokens_observed=len(observed),
                    remaining=remaining)
            return
        reason = (last_shed.reject.reason if last_shed is not None
                  else "no_replica")
        return self._shed_redrive(frid, rec, reason, src)

    def _finish_from_observed(self, frid, rec, observed, src):
        toks = np.asarray(observed, np.int32)
        self._results[frid] = toks
        while len(self._results) > self._results_cap:
            self._results.popitem(last=False)
        self._reqs.pop(frid, None)
        self._trace.pop(frid, None)
        self.redrives_total += 1
        self._reg.counter(
            "fleet_redrive_total",
            "in-flight requests redriven after replica death").inc(
                mode="observed")
        if self.tracer.enabled:
            self.tracer.record_span(
                "router.redrive", duration_s=0.0,
                trace_id=(rec.trace_id or None), mode="observed",
                src=src, tokens_observed=len(observed))

    def _shed_redrive(self, frid, rec, reason: str, src: str):
        """A request the fleet cannot redrive sheds with a structured
        verdict (surfaced via :meth:`reject_reason`) — the no-silent-
        loss contract."""
        self._rejects[frid] = Reject(reason, rec.lane, 0, 0.0, 0.001)
        while len(self._rejects) > self._results_cap:
            self._rejects.popitem(last=False)
        self._reqs.pop(frid, None)
        self._trace.pop(frid, None)
        self._reg.counter(
            "fleet_redrive_shed_total",
            "redrives shed with a structured reason").inc(reason=reason)
        if self.tracer.enabled:
            self.tracer.record_span(
                "router.redrive", duration_s=0.0, status="shed",
                trace_id=(rec.trace_id or None), src=src, reason=reason)
        # shed spike: losing requests in bulk is a fleet-level incident
        # even when no single replica died — the busiest survivor's
        # black box is the congestion witness
        self._sheds_since_dump += 1
        if (self.shed_spike_threshold
                and self._sheds_since_dump >= self.shed_spike_threshold):
            witness = None
            cands = [r for r in self.replicas
                     if not getattr(r, "draining", False)]
            if cands:
                witness = max(cands, key=self._load_or_zero)
            if witness is not None:
                self._dump_postmortem(
                    witness, "shed_spike",
                    trace_ids=(int(rec.trace_id),) if rec.trace_id else (),
                    extra={"sheds": self._sheds_since_dump,
                           "last_reason": reason, "last_src": src})
            self._sheds_since_dump = 0

    def _drain_crashed(self, rep, exc: BaseException) -> int:
        """A replica died mid-drain: fall through to eject + redrive
        (nothing is lost — queued requests already re-routed, in-flight
        requests redrive from the replay records)."""
        if not self.faults.enabled:
            raise exc
        self._reg.counter(
            "fleet_drain_crash_total",
            "replicas that died mid-drain (fell through to "
            "eject + redrive)").inc()
        if self.tracer.enabled:
            self.tracer.record_span(
                "router.drain_crashed", duration_s=0.0,
                replica=rep.name,
                error=f"{type(exc).__name__}: {exc}")
        return self.eject_replica(
            rep, reason=f"crashed_mid_drain:{type(exc).__name__}")

    def drain_replica(self, rep, *, remove: bool = True) -> int:
        """Live-drain one replica: stop admitting, re-route its queued
        requests, migrate every in-flight slot to a peer (snapshot →
        sha256-verified restore → resume decode), then detach it.
        Returns the number of in-flight requests migrated. A snapshot
        no peer can place is restored straight back into the source
        and the drain aborts with :class:`SlotMigrationError` — drain
        never loses a request."""
        if rep not in self.replicas:
            raise ValueError(f"{rep.name} is not in this fleet")
        if len(self.replicas) < 2:
            raise SlotMigrationError("cannot drain the last replica")
        rep.draining = True
        # queued (unadmitted) requests: plain re-route, KV not built
        # yet. Every remaining peer is tried in load order before a
        # shed counts (the first p2c-sampled target shedding is not a
        # fleet-wide verdict); a request EVERY peer sheds is dropped
        # with its fleet bookkeeping cleaned — the same outcome a
        # direct submit to a saturated fleet would have had.
        try:
            queued = rep.drain_queue()
        except NotImplementedError:
            raise
        except Exception as e:
            return self._drain_crashed(rep, e)
        for (lrid, prompt, mnew, eos, lane, dl) in queued:
            frid = self._rev.pop((id(rep), lrid), None)
            trace_id = self._trace.get(frid, 0) if frid else 0
            first, _hits = self._route(prompt, exclude=rep)
            others = sorted((r for r in self._prompt_candidates(exclude=rep)
                             if r is not first), key=self._load)
            nrid, target = None, None
            for peer in [first] + others:
                try:
                    nrid = peer.submit(prompt, mnew, eos, lane=lane,
                                       ttft_deadline_s=dl,
                                       trace_id=trace_id or None)
                    self._note_transport_success(peer, trace_id or 0)
                    target = peer
                    break
                except LoadShedError:
                    continue
                except TRANSPORT_ERRORS as e:
                    if not self.faults.enabled:
                        raise
                    self._note_transport_failure(peer, e,
                                                 trace_id or 0)
                    continue
            if nrid is None:
                if frid is not None:
                    self._where.pop(frid, None)
                    self._trace.pop(frid, None)
                    rec = self._reqs.pop(frid, None)
                    # structured verdict, never silence: the caller can
                    # distinguish "shed everywhere" from "still running"
                    self._rejects[frid] = Reject(
                        "requeue_shed", rec.lane if rec else lane,
                        0, 0.0, 0.001)
                    while len(self._rejects) > self._results_cap:
                        self._rejects.popitem(last=False)
                self._reg.counter(
                    "fleet_requeue_shed_total",
                    "drain re-routes shed by every remaining replica"
                ).inc()
                if self.tracer.enabled:
                    self.tracer.record_span(
                        "router.requeue", duration_s=0.0, status="shed",
                        trace_id=trace_id or None, src=rep.name)
                continue
            if frid is not None:
                self._where[frid] = (target, nrid)
                self._rev[(id(target), nrid)] = frid
            if self.tracer.enabled:
                self.tracer.record_span(
                    "router.requeue", duration_s=0.0,
                    trace_id=trace_id or None, src=rep.name,
                    dst=target.name)
        migrated = 0
        # the drain-vs-crash race: a replica that dies HERE — after its
        # queue was handed over but before migration completes — must
        # not take the in-flight requests with it. The failure falls
        # through to the eject path, which redrives them from the
        # router's replay records.
        try:
            snaps = rep.snapshot_inflight()
        except NotImplementedError:
            raise
        except Exception as e:
            return self._drain_crashed(rep, e)
        for pos, (lrid, snap) in enumerate(snaps):
            frid = self._rev.pop((id(rep), lrid), None)
            span = None
            if self.tracer.enabled:
                span = self.tracer.start_span(
                    "router.migrate",
                    trace_id=int(snap.get("trace_id") or 0) or None,
                    src=rep.name)
            peers = sorted(self._candidates(exclude=rep),
                           key=self._load)
            nrid, target = None, None
            for peer in peers:
                try:
                    nrid = peer.restore(snap, parent_span=span)
                    self._note_transport_success(peer)
                    target = peer
                    break
                except SlotMigrationError:
                    continue
                except TRANSPORT_ERRORS as e:
                    if not self.faults.enabled:
                        raise
                    self._note_transport_failure(peer, e)
                    continue
            if nrid is None:
                # nowhere to put it: give this one AND every remaining
                # snapshot back (their slots were already released for
                # the transfer), then abort — drain never loses a
                # request
                for bfrid, bsnap in [(frid, snap)] + [
                        (self._rev.pop((id(rep), blrid), None), bsnap2)
                        for (blrid, bsnap2) in snaps[pos + 1:]]:
                    back = rep.restore(bsnap)
                    if bfrid is not None:
                        self._where[bfrid] = (rep, back)
                        self._rev[(id(rep), back)] = bfrid
                rep.draining = False
                if span is not None:
                    span.finish(status="aborted")
                raise SlotMigrationError(
                    "no peer capacity for in-flight request; "
                    "drain aborted")
            if frid is not None:
                self._where[frid] = (target, nrid)
                self._rev[(id(target), nrid)] = frid
            migrated += 1
            self.migrations_total += 1
            self._reg.counter(
                "fleet_migrations_total",
                "in-flight requests live-migrated between replicas"
            ).inc()
            if span is not None:
                span.set_attrs(dst=target.name,
                               kv_tokens=int(snap["state"]["length"]))
                span.finish()
        if remove:
            self.replicas.remove(rep)
            rep.close()
            self._reg.gauge("fleet_replicas",
                            "replicas serving traffic").set(
                                len(self.replicas))
        return migrated


class FleetMonitor:
    """Aggregates per-replica health into fleet-level gauges in ONE
    registry, served from one exposition endpoint: ``collect()`` after
    each fleet step (or on a poll thread) refreshes
    ``fleet_replicas`` / ``fleet_queue_depth`` /
    ``fleet_requests_in_flight`` / ``fleet_slot_occupancy`` (mean and
    max) / ``fleet_page_utilization`` plus per-replica labeled series,
    and :meth:`start_exposition` exposes them with the router's
    aggregated ``/healthz``."""

    # per-replica labeled series collect() owns — dropped for vanished
    # replicas so an ejected replica's last gauge values don't haunt
    # /metrics (and dashboards) for the life of the process
    _PER_REPLICA_METRICS = ("fleet_replica_queue_depth",
                            "fleet_replica_slot_occupancy",
                            "fleet_replica_tp",
                            "fleet_replica_burn_rate",
                            "fleet_replica_headroom",
                            "fleet_breaker_state")

    def __init__(self, router: FleetRouter, registry=None):
        from paddle_tpu_torch import observability as obs
        self.router = router
        self.reg = registry or router._reg
        self.tracer = router.tracer
        self._obs = obs
        self._seen_replicas: set = set()

    def _drop_stale(self, live) -> int:
        dropped = 0
        for name in self._seen_replicas - set(live):
            for mname in self._PER_REPLICA_METRICS:
                m = self.reg.get(mname)
                if m is not None:
                    dropped += m.remove_matching(replica=name)
        self._seen_replicas = set(live)
        return dropped

    def collect(self) -> Dict[str, object]:
        h = self.router.health()
        self._drop_stale(h["per_replica"])
        g = self.reg.gauge
        g("fleet_replicas", "replicas serving traffic").set(
            h["replicas"])
        g("fleet_chips", "accelerator chips behind the fleet "
          "(tp-degree-weighted replica count)").set(
              h.get("chips_total", h["replicas"]))
        g("fleet_queue_depth", "queued requests across the fleet").set(
            h["queue_depth_total"])
        g("fleet_requests_in_flight",
          "admitted requests across the fleet").set(
              h["requests_in_flight"])
        g("fleet_routable_replicas",
          "replicas new work can land on (breaker-closed, "
          "not draining)").set(h.get("routable", h["replicas"]))
        for name, bs in (h.get("breakers") or {}).items():
            g("fleet_breaker_state",
              "per-replica circuit breaker "
              "(0 closed / 1 half-open / 2 open)").set(
                  BREAKER_GAUGE[bs["state"]], replica=name)
        occ, util, burn = [], [], []
        head_min: Dict[str, float] = {}
        for name, rh in h["per_replica"].items():
            occ.append(float(rh.get("slot_occupancy", 0.0)))
            util.append(float(rh.get("page_utilization", 0.0)))
            # disaggregation: tiered replicas carry their
            # tier on every per-replica series; colocated fleets keep
            # the exact pre-tier label sets (dashboards and exact-label
            # value() lookups stay byte-identical)
            tier = str(rh.get("tier") or "colocated")
            lbl = ({"replica": name} if tier == "colocated"
                   else {"replica": name, "tier": tier})
            # resource-headroom plane: per-replica gauges +
            # the fleet-level bottleneck (min across replicas) the
            # autoscaler and /healthz read
            for res, v in (rh.get("headroom") or {}).items():
                if res in ("flops", "pages", "slots", "hbm", "spill"):
                    v = float(v)
                    g("fleet_replica_headroom",
                      "per-replica resource headroom "
                      "(1 = idle, 0 = saturated)").set(
                          v, resource=res, **lbl)
                    head_min[res] = min(head_min.get(res, 1.0), v)
            g("fleet_replica_queue_depth",
              "per-replica queued requests").set(
                  rh.get("queue_depth", 0), **lbl)
            g("fleet_replica_slot_occupancy",
              "per-replica decode-slot occupancy").set(
                  rh.get("slot_occupancy", 0.0), **lbl)
            g("fleet_replica_tp",
              "per-replica tensor-parallel degree (mesh chips)").set(
                  rh.get("mesh_devices", 1) or 1, **lbl)
            slo = rh.get("slo")
            if slo:
                burn.append(float(slo.get("burn_fast", 0.0)))
                g("fleet_replica_burn_rate",
                  "per-replica fast-window SLO burn").set(
                      slo.get("burn_fast", 0.0), **lbl)
        if occ:
            g("fleet_slot_occupancy_mean",
              "mean decode-slot occupancy").set(sum(occ) / len(occ))
            g("fleet_slot_occupancy_max",
              "max decode-slot occupancy").set(max(occ))
        if util:
            g("fleet_page_utilization_mean",
              "mean page-pool utilization").set(sum(util) / len(util))
        if burn:
            g("fleet_burn_rate_max",
              "hottest replica's fast-window burn").set(max(burn))
        for res, v in head_min.items():
            g("fleet_headroom_min",
              "fleet bottleneck headroom per resource "
              "(min across replicas)").set(v, resource=res)
        h["headroom"] = head_min
        return h

    def start_exposition(self, port: int = 0, host: str = "127.0.0.1"):
        """One live endpoint for the whole fleet: ``/metrics`` serves
        the aggregated registry, ``/healthz`` the router's fleet
        summary, ``/traces`` the shared tracer's ring (router spans and
        every replica's request spans — one timeline)."""
        srv = self._obs.ExpositionServer(registry=self.reg,
                                         tracer=self.tracer,
                                         port=port, host=host)
        srv.add_health("fleet", lambda: self.collect())
        srv.add_postmortem("fleet", self.router.postmortems)
        return srv.start()
