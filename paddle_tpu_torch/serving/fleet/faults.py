"""Fleet fault machinery: chaos injection, circuit breakers, detection.

``drain_replica`` alone survives only *voluntary* departure: it
live-migrates a healthy replica's slots. A replica that crashes, hangs,
or starts throwing mid-step is routine at production scale ("engines as
cattle" is only half-true until involuntary death is survivable), and
nothing could provoke one on demand. This module makes those failures
first-class, with deterministic, unit-testable injection:

- :class:`ChaosReplica` — a wrapper over any
  :class:`~paddle_tpu_torch.serving.fleet.ReplicaHandle` that injects
  *scheduled* faults: crash on step N (every call after raises, dead-
  host semantics), hang after step N (steps stop
  progressing and ``health()`` reports an infinitely stale heartbeat —
  what a hung probe looks like from the router), the first K submits
  failing (a flaky transport), the first K health probes failing
  (corrupt health endpoint), and crash-on-snapshot (death *mid-drain*,
  after the queue is handed over but before migration completes).
  :func:`chaos_schedule` derives a seeded, reproducible fault schedule
  for property tests.
- :class:`CircuitBreaker` — per-replica closed → open on a failure
  threshold, half-open probe after a cooldown, closed again on probe
  success. The router stops routing to an open breaker (transient
  sickness pauses traffic without the terminal verdict of ejection)
  and deliberately routes ONE probe request when the breaker
  half-opens; transitions surface as a gauge, a counter, and trace
  events carrying the triggering request's original trace id.
- :class:`FailureDetector` — turns raw failure signals into a death
  verdict: a :class:`ReplicaCrashed` is immediately terminal; other
  step/submit/probe exceptions count toward a consecutive-failure
  threshold (transient flakes are the breaker's job, not death); a
  replica-surfaced background-loop crash (``health()["failed"]``) and
  a stale heartbeat with work pending (``heartbeat_age_s`` past the
  probe timeout) are terminal. The router acts on a verdict with
  :meth:`~paddle_tpu_torch.serving.fleet.FleetRouter.eject_replica` — the
  hard counterpart of drain: KV is gone, so queued requests re-route
  and in-flight requests are *redriven* exactly-once.
- :class:`FaultPolicy` — one knob bundle (thresholds, timeouts,
  redrive budget) the router takes as ``faults=``.

Everything is host-side and clock-injectable: the chaos battery runs
with zero real sleeping and zero steady-state recompiles.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional, Tuple


class ReplicaCrashed(RuntimeError):
    """Terminal replica failure: the process/transport is gone. The
    detector treats this as immediately fatal (no consecutive-failure
    grace) — a dead host does not come back to finish its step."""


class ReplicaUnavailable(RuntimeError):
    """Transient replica failure (flaky transport, overloaded process):
    retryable on a peer, counted by the breaker and the detector's
    consecutive-failure threshold, but not terminal by itself."""


# ---------------------------------------------------------------------------
# chaos injection


@dataclasses.dataclass
class ChaosSpec:
    """One replica's fault schedule. Steps are 1-based counts of
    ``step()`` calls on the wrapper."""

    crash_on_step: Optional[int] = None     # step N raises; dead after
    hang_after_step: Optional[int] = None   # steps stop progressing
    submit_failures: int = 0                # first K submits raise
    health_failures: int = 0                # first K health probes raise
    crash_on_snapshot: bool = False         # dies mid-drain
    crash_on_handoff: bool = False          # prefill dies mid-handoff
    crash_on_restore: bool = False          # decode dies mid-restore
    crash_on_export: bool = False           # dies mid-prefix-page-fetch


def chaos_schedule(seed: int, n_replicas: int, *,
                   max_crash_step: int = 16,
                   p_crash: float = 0.5, p_hang: float = 0.25,
                   max_submit_failures: int = 3) -> List[ChaosSpec]:
    """Seeded, reproducible fault schedule for ``n_replicas`` — the
    property-test driver: same seed, same chaos, byte-for-byte."""
    rng = random.Random(seed)
    specs = []
    for _ in range(n_replicas):
        roll = rng.random()
        if roll < p_crash:
            specs.append(ChaosSpec(
                crash_on_step=rng.randint(1, max_crash_step)))
        elif roll < p_crash + p_hang:
            specs.append(ChaosSpec(
                hang_after_step=rng.randint(1, max_crash_step)))
        else:
            specs.append(ChaosSpec(
                submit_failures=rng.randint(0, max_submit_failures)))
    return specs


class ChaosReplica:
    """Deterministic fault-injecting wrapper over a ``ReplicaHandle``.

    The router only ever sees the wrapper, so injected faults look
    exactly like a failing transport: ``step()`` raising, ``submit()``
    raising, ``health()`` raising or reporting a stale heartbeat. After
    a crash fires, EVERY subsequent operation raises
    :class:`ReplicaCrashed` (dead-host semantics); a hung replica keeps
    answering ``health()`` but stops making progress and its heartbeat
    age reads infinite. ``spec`` fields can also be given as keyword arguments.
    """

    def __init__(self, inner, spec: Optional[ChaosSpec] = None, **kw):
        self.inner = inner
        self.spec = spec or ChaosSpec(**kw)
        self.name = inner.name
        self.draining = False
        self.dead = False
        self.hung = False
        self.steps_seen = 0
        self.submit_failures_injected = 0
        self.health_failures_injected = 0

    # -- fault gates -------------------------------------------------------

    def _check(self):
        if self.dead:
            raise ReplicaCrashed(f"chaos: {self.name} is dead")

    # -- ReplicaHandle surface --------------------------------------------

    def step(self):
        self._check()
        self.steps_seen += 1
        s = self.spec
        if s.crash_on_step is not None and self.steps_seen >= s.crash_on_step:
            self.dead = True
            raise ReplicaCrashed(
                f"chaos: {self.name} crashed at step {self.steps_seen}")
        if (s.hang_after_step is not None
                and self.steps_seen >= s.hang_after_step):
            self.hung = True
            return {}               # no progress, no error: a hang
        return self.inner.step()

    def submit(self, prompt, max_new_tokens, eos_id=None, *,
               lane="default", ttft_deadline_s=None, trace_id=None):
        self._check()
        if self.submit_failures_injected < self.spec.submit_failures:
            self.submit_failures_injected += 1
            raise ReplicaUnavailable(
                f"chaos: {self.name} submit failure "
                f"#{self.submit_failures_injected}")
        return self.inner.submit(prompt, max_new_tokens, eos_id,
                                 lane=lane,
                                 ttft_deadline_s=ttft_deadline_s,
                                 trace_id=trace_id)

    def health(self):
        self._check()
        if self.health_failures_injected < self.spec.health_failures:
            self.health_failures_injected += 1
            raise ReplicaUnavailable(
                f"chaos: {self.name} health probe failure "
                f"#{self.health_failures_injected}")
        h = dict(self.inner.health())
        if self.hung:
            # what a hung replica looks like from outside: the probe
            # answers (cached state) but the loop stopped beating
            h["heartbeat_age_s"] = float("inf")
        return h

    def idle(self):
        # a hang does not change idleness: the work is still there, it
        # just never finishes — the router's heartbeat probe (not this
        # predicate) is what declares the replica dead
        self._check()
        return self.inner.idle()

    def snapshot_inflight(self):
        self._check()
        if self.spec.crash_on_snapshot:
            self.dead = True
            raise ReplicaCrashed(
                f"chaos: {self.name} crashed mid-drain (snapshot)")
        return self.inner.snapshot_inflight()

    def page_size(self):
        self._check()
        return self.inner.page_size()

    def prefix_digests(self):
        self._check()
        return self.inner.prefix_digests()

    def export_prefix_pages(self, digests):
        self._check()
        if self.spec.crash_on_export:
            self.dead = True
            raise ReplicaCrashed(
                f"chaos: {self.name} crashed mid-prefix-export")
        return self.inner.export_prefix_pages(digests)

    def import_prefix_pages(self, bundle):
        self._check()
        return self.inner.import_prefix_pages(bundle)

    def can_accept(self, total_tokens):
        self._check()
        return not self.draining and self.inner.can_accept(total_tokens)

    def result(self, rid):
        self._check()
        return self.inner.result(rid)

    def request_stats(self, rid):
        self._check()
        return self.inner.request_stats(rid)

    def progress(self, since=None):
        self._check()
        return self.inner.progress(since)

    def poll_checkpoints(self):
        self._check()
        return self.inner.poll_checkpoints()

    def poll_handoffs(self):
        self._check()
        if self.spec.crash_on_handoff:
            # the prefill-tier chaos leg: the replica dies while the
            # router is draining its handoff outbox — parked slots go
            # down with it and must redrive through the replay records
            self.dead = True
            raise ReplicaCrashed(
                f"chaos: {self.name} crashed mid-handoff")
        return self.inner.poll_handoffs()

    def reject_reason(self, rid):
        self._check()
        return self.inner.reject_reason(rid)

    def drain_queue(self):
        self._check()
        return self.inner.drain_queue()

    def restore(self, snap, *, parent_span=None):
        self._check()
        if self.spec.crash_on_restore:
            # the decode-tier chaos leg: the replica dies mid-restore —
            # the router still holds the snapshot and must place it
            # elsewhere (or fall back to the source) with nothing lost
            self.dead = True
            raise ReplicaCrashed(
                f"chaos: {self.name} crashed mid-restore")
        return self.inner.restore(snap, parent_span=parent_span)

    def warmup(self):
        self.inner.warmup()
        return self

    def postmortem(self, reason, trace_ids=()):
        # NO _check(): the whole point of a flight recorder is that a
        # dead replica still hands over its black box
        return self.inner.postmortem(reason, trace_ids=trace_ids)

    def running(self):
        return (not self.dead and not self.hung
                and getattr(self.inner, "running", lambda: False)())

    def close(self):
        # best-effort: ejecting a dead replica must not raise again
        try:
            self.inner.close()
        except Exception:
            pass

    # convenience pass-throughs the bench/tests read and write
    @property
    def engine(self):
        return self.inner.engine

    @property
    def busy_s(self):
        return self.inner.busy_s

    @busy_s.setter
    def busy_s(self, v):
        self.inner.busy_s = v


# ---------------------------------------------------------------------------
# circuit breaker


class CircuitBreaker:
    """Per-replica request gate: ``closed`` (healthy) → ``open`` after
    ``threshold`` consecutive failures (no traffic) → ``half_open``
    after ``cooldown_s`` (exactly one probe request allowed) → back to
    ``closed`` on probe success or ``open`` on probe failure.

    ``on_transition(old, new, trace_id)`` fires on every state change —
    the router wires it to the ``fleet_breaker_state`` gauge, the
    transition counter, and a ``fleet.breaker`` trace event on the
    triggering request's original trace id.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, threshold: int = 5, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._on_transition = on_transition
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.probe_inflight = False
        self.transitions: List[Tuple[str, str]] = []

    def _move(self, new: str, trace_id: int = 0):
        old, self.state = self.state, new
        if old != new:
            self.transitions.append((old, new))
            if self._on_transition is not None:
                self._on_transition(old, new, trace_id)

    def poll(self):
        """Advance open → half_open once the cooldown has elapsed.
        Called by the router on every routing pass."""
        if (self.state == self.OPEN and self.opened_at is not None
                and self._clock() - self.opened_at >= self.cooldown_s):
            self.probe_inflight = False
            self._move(self.HALF_OPEN)

    def allow(self) -> bool:
        """May a request be routed here right now? Half-open allows
        exactly one in-flight probe at a time."""
        self.poll()
        if self.state == self.CLOSED:
            return True
        if self.state == self.HALF_OPEN:
            return not self.probe_inflight
        return False

    def note_probe(self):
        """The router is sending the half-open probe request."""
        if self.state == self.HALF_OPEN:
            self.probe_inflight = True

    def record_success(self, trace_id: int = 0):
        self.failures = 0
        self.probe_inflight = False
        if self.state != self.CLOSED:
            self.opened_at = None
            self._move(self.CLOSED, trace_id)

    def record_failure(self, trace_id: int = 0):
        self.failures += 1
        self.probe_inflight = False
        if self.state == self.HALF_OPEN:
            self.opened_at = self._clock()     # probe failed: re-open
            self._move(self.OPEN, trace_id)
        elif self.state == self.CLOSED and self.failures >= self.threshold:
            self.opened_at = self._clock()
            self._move(self.OPEN, trace_id)

    def status(self) -> Dict[str, object]:
        return {"state": self.state, "failures": self.failures,
                "cooldown_s": self.cooldown_s,
                "open_age_s": (None if self.opened_at is None
                               else self._clock() - self.opened_at)}


# numeric encoding for the fleet_breaker_state gauge
BREAKER_GAUGE = {CircuitBreaker.CLOSED: 0.0,
                 CircuitBreaker.HALF_OPEN: 1.0,
                 CircuitBreaker.OPEN: 2.0}


# ---------------------------------------------------------------------------
# failure detection


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How the router reacts to involuntary failure. ``enabled=False``
    restores the fault-free router byte-for-byte (no probes, no breakers, a
    replica exception propagates).

    Keep ``breaker_threshold`` BELOW ``max_consecutive_failures``: the
    breaker must trip first so a transiently flaky transport stops
    receiving submits (freezing its failure count) *before* the
    detector's consecutive-failure verdict ejects it — ejection is for
    the genuinely dead. With the order inverted, every flaky replica
    is ejected before its breaker ever opens and half-open recovery
    never happens."""

    enabled: bool = True
    max_consecutive_failures: int = 5   # step/submit/probe raises → dead
    probe_timeout_s: float = 30.0       # stale heartbeat w/ work → dead
    breaker_threshold: int = 3          # failures → breaker opens
    breaker_cooldown_s: float = 30.0    # open → half-open probe delay
    max_redrives: int = 3               # per-request redrive budget


class FailureDetector:
    """Failure signals → death verdicts, per replica (keyed by name).

    Terminal immediately: :class:`ReplicaCrashed`, a replica-surfaced
    background-loop crash (``health()["failed"]``), a heartbeat older
    than ``probe_timeout_s`` while the replica holds queued or
    in-flight work. Everything else (transient exceptions from step /
    submit / the health probe) counts toward
    ``max_consecutive_failures``; any success resets the count.
    """

    def __init__(self, *, max_consecutive_failures: int = 3,
                 probe_timeout_s: float = 30.0):
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.probe_timeout_s = float(probe_timeout_s)
        self._fails: Dict[str, int] = {}

    def observe_success(self, name: str):
        self._fails[name] = 0

    def observe_failure(self, name: str, exc: BaseException
                        ) -> Optional[str]:
        """Returns a death reason, or None (still within grace)."""
        if isinstance(exc, ReplicaCrashed):
            return "crashed"
        n = self._fails.get(name, 0) + 1
        self._fails[name] = n
        if n >= self.max_consecutive_failures:
            return f"consecutive_failures:{n}"
        return None

    def check_health(self, name: str, health: Dict[str, object]
                     ) -> Optional[str]:
        """Death verdict from a successful probe's payload: the replica
        surfacing its own loop crash, or a hang (stale heartbeat while
        work is pending)."""
        if health.get("failed"):
            return f"replica_failed:{health.get('last_error', '?')}"
        age = health.get("heartbeat_age_s")
        has_work = (int(health.get("queue_depth", 0) or 0)
                    + int(health.get("requests_in_flight", 0) or 0)) > 0
        if age is not None and has_work and float(age) > self.probe_timeout_s:
            return f"heartbeat_timeout:{float(age):.3f}s"
        return None

    def consecutive_failures(self, name: str) -> int:
        return self._fails.get(name, 0)
