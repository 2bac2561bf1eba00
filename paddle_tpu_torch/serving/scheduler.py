"""Serving schedulers: keep every decode slot full, and meet SLOs.

Lock-step batch decoding finishes when the *longest* request finishes;
every early-EOS sequence wastes its slot as padding until then. Here a
fixed number of decode slots run one fixed-shape step together, and the
scheduler (pure host logic — no jax, unit-testable with randomized
arrivals):

  - admits queued requests into free slots the moment slots + pages are
    available;
  - evicts a sequence the step it finishes (EOS or its own length cap),
    releasing its slot and pages for the next admission;
  - tracks queue-wait / first-token timestamps for the engine's metrics.

Two policies:

``ContinuousBatchingScheduler`` — plain FIFO with head blocking: a
too-big-for-now request blocks the queue rather than starving. Simple,
starvation-free, but one huge request at the head stalls every
interactive request behind it.

``SLOScheduler`` — priority lanes (ordered, e.g. ``interactive`` before
``batch``), per-request TTFT deadlines with earliest-deadline-first
boosting of at-risk requests, admission that *skips* requests that do
not fit yet (no head-of-line blocking) with a bounded-skip
anti-starvation rule (a request passed over ``starvation_skips`` times
becomes blocking until it fits), and load shedding: rather than
queueing forever, ``submit`` raises a structured
:class:`LoadShedError` when the queue is full or the estimated TTFT
already blows the request's deadline.

The scheduler never touches device state: the engine owns the device
steps and the paged cache; this class only decides *which request sits
in which slot when*.

This module is the port's own copy of ``paddle_tpu/serving/scheduler.py``
(pure numpy, kept nearly verbatim); ``REJECT_REASONS`` must stay
identical to the reference's, which the wire format and the fleet key on.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S0,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    submitted_at: float = 0.0
    lane: str = "default"
    ttft_deadline_s: Optional[float] = None
    skips: int = 0                  # admission passes that skipped it
    boosted: bool = False           # already EDF-boosted (one trace event)

    @property
    def total_tokens(self) -> int:
        return int(self.prompt.shape[0]) + self.max_new_tokens

    def deadline_at(self) -> Optional[float]:
        if self.ttft_deadline_s is None:
            return None
        return self.submitted_at + self.ttft_deadline_s


#: the Reject.reason vocabulary — the ONE source of truth. The wire
#: protocol validates decoded rejects against it, the parametrized wire
#: tests enumerate it, and ``analysis.conformance.lint_reject_vocab``
#: statically checks that every constructed literal is registered and
#: every entry is constructed somewhere.
REJECT_REASONS = (
    "queue_full",            # submit: bounded queue at capacity
    "deadline_infeasible",   # submit: est TTFT already past the deadline
    "deadline_expired",      # queued past its TTFT deadline (engine reap
                             # or router pre-redrive check)
    "redrive_budget",        # router: per-request redrive budget spent
    "no_replica",            # router: no live replica can accept it
    "requeue_shed",          # router: drain-requeue landed nowhere
    "slow_reader",           # front door: client stream backpressure
)


@dataclasses.dataclass
class Reject:
    """Structured load-shed verdict (the body of :class:`LoadShedError`):
    everything a client needs to back off sensibly instead of the
    request silently queueing forever. ``reason`` is one of
    :data:`REJECT_REASONS`."""
    reason: str
    lane: str
    queue_depth: int
    est_ttft_s: float
    retry_after_s: float


class LoadShedError(RuntimeError):
    """Raised by ``SLOScheduler.submit`` instead of queueing a request
    the server cannot serve within its SLO; carries a :class:`Reject`."""

    def __init__(self, reject: Reject):
        super().__init__(
            f"load shed ({reject.reason}): lane={reject.lane} "
            f"queue_depth={reject.queue_depth} "
            f"est_ttft={reject.est_ttft_s:.3f}s "
            f"retry_after={reject.retry_after_s:.3f}s")
        self.reject = reject


@dataclasses.dataclass
class SlotState:
    request: Request
    generated: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0              # prompt tokens already in the cache
    admitted_at: float = 0.0
    first_token_at: Optional[float] = None

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= int(self.request.prompt.shape[0])

    def finished(self) -> bool:
        r = self.request
        if len(self.generated) >= r.max_new_tokens:
            return True
        return (r.eos_id is not None and self.generated
                and self.generated[-1] == r.eos_id)


class ContinuousBatchingScheduler:
    """FIFO queue + slot table. ``can_admit(request)`` is injected by the
    engine (page availability lives in the cache, not here)."""

    def __init__(self, num_slots: int,
                 can_admit: Optional[Callable[[Request], bool]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.num_slots = num_slots
        self.slots: List[Optional[SlotState]] = [None] * num_slots
        self.queue: Deque[Request] = deque()
        self._can_admit = can_admit or (lambda r: True)
        self._clock = clock
        self._ids = itertools.count()
        # decision-event sink: event_cb(rid, name, **attrs). The engine
        # wires this to each request's trace span, so skip/boost/shed
        # verdicts land on the request timeline with their reasons.
        self.event_cb: Optional[Callable] = None

    def _event(self, rid: int, name: str, **attrs):
        if self.event_cb is not None:
            self.event_cb(rid, name, **attrs)

    # -- queue ------------------------------------------------------------

    def _make_request(self, prompt, max_new_tokens, eos_id, lane,
                      ttft_deadline_s) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        return Request(next(self._ids), prompt, max_new_tokens, eos_id,
                       submitted_at=self._clock(), lane=lane,
                       ttft_deadline_s=ttft_deadline_s)

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, *, lane: str = "default",
               ttft_deadline_s: Optional[float] = None) -> int:
        req = self._make_request(prompt, max_new_tokens, eos_id, lane,
                                 ttft_deadline_s)
        self.queue.append(req)
        return req.rid

    def queue_depth(self) -> int:
        return len(self.queue)

    def note_ttft(self, seconds: float):
        """Engine feedback hook (TTFT estimator); FIFO ignores it."""

    # -- slot bookkeeping -------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def decode_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefill_done]

    def occupancy(self) -> float:
        return len(self.active_slots()) / self.num_slots

    def admit(self, on_admit=None) -> List[int]:
        """Move queued requests into free slots (FIFO, head-blocking).
        Returns the slot indices admitted this call; the engine then
        prefills them. Stops at the first request the cache cannot hold
        yet — its pages free up as running sequences finish.

        ``on_admit(slot, request)`` fires immediately per admission,
        BEFORE the next request's ``can_admit`` check — the engine
        reserves pages there, so one call admitting several requests
        can never over-commit the pool against a stale free count."""
        admitted = []
        for slot in self.free_slots():
            if not self.queue:
                break
            if not self._can_admit(self.queue[0]):
                break
            req = self.queue.popleft()
            self.slots[slot] = SlotState(req, admitted_at=self._clock())
            if on_admit is not None:
                on_admit(slot, req)
            admitted.append(slot)
        return admitted

    def evict_finished(self) -> Dict[int, SlotState]:
        """Pop every finished slot; returns {slot: final state}."""
        done = {}
        for i, st in enumerate(self.slots):
            if st is not None and st.finished():
                done[i] = st
                self.slots[i] = None
        return done

    def idle(self) -> bool:
        return not self.queue and not self.active_slots()


class SLOScheduler(ContinuousBatchingScheduler):
    """SLO-aware admission: priority lanes + TTFT deadlines + bounded
    skipping + load shedding. Slot bookkeeping (eviction, decode-slot
    tracking) is shared with the FIFO base; only *who gets in when* and
    *who is turned away* differ.

    Admission order each call:

    1. Requests whose TTFT deadline is **at risk** (now + the EWMA
       TTFT estimate crosses the deadline), earliest deadline first —
       they jump every lane.
    2. Everything else by lane priority (``lanes`` order), FIFO within
       a lane.

    A candidate that does not fit (``can_admit`` false — typically no
    pages yet) is *skipped*, not blocking the line, and its skip count
    increments; once a request has been skipped ``starvation_skips``
    times, admission stops behind it until it fits (the FIFO
    head-blocking guarantee, applied only where starvation is real).

    ``submit`` sheds load instead of queueing forever: with the queue at
    ``max_queue_depth``, or with a requested deadline the EWMA TTFT
    estimate says is infeasible, it raises :class:`LoadShedError`
    carrying a structured :class:`Reject`. Deadline shedding only
    applies once the queue is *saturated* (``shed_saturation_waves``
    full admission waves deep) — below saturation the EDF boost can
    still rescue an at-risk request, so it is admitted and, if it
    misses anyway, reaped by :meth:`shed_expired`.
    """

    def __init__(self, num_slots: int,
                 can_admit: Optional[Callable[[Request], bool]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 lanes: Sequence[str] = ("interactive", "default", "batch"),
                 max_queue_depth: Optional[int] = None,
                 starvation_skips: int = 64,
                 deadline_slack_s: float = 0.0,
                 shed_saturation_waves: float = 2.0):
        super().__init__(num_slots, can_admit=can_admit, clock=clock)
        self.lane_order = {name: i for i, name in enumerate(lanes)}
        self.max_queue_depth = max_queue_depth
        self.starvation_skips = starvation_skips
        self.deadline_slack_s = deadline_slack_s
        self.shed_saturation_waves = shed_saturation_waves
        self._ttft_ewma = 0.0       # engine-fed; 0 = no estimate yet
        self.shed_total = 0

    # -- TTFT estimator ---------------------------------------------------

    def note_ttft(self, seconds: float):
        """Engine feedback: observed TTFT of a completed admission,
        folded into the EWMA the shedding/at-risk decisions use."""
        a = 0.3
        self._ttft_ewma = (seconds if self._ttft_ewma == 0.0
                           else a * seconds + (1 - a) * self._ttft_ewma)

    def est_ttft_s(self) -> float:
        """Crude queue-aware TTFT estimate: the EWMA of served requests
        scaled by how many queue waves sit ahead of a new arrival."""
        waves = 1.0 + len(self.queue) / max(self.num_slots, 1)
        return self._ttft_ewma * waves

    # -- submission + shedding --------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, *, lane: str = "default",
               ttft_deadline_s: Optional[float] = None) -> int:
        if lane not in self.lane_order:
            raise ValueError(f"unknown lane {lane!r} "
                             f"(have {sorted(self.lane_order)})")
        est = self.est_ttft_s()
        if (self.max_queue_depth is not None
                and len(self.queue) >= self.max_queue_depth):
            self.shed_total += 1
            raise LoadShedError(Reject(
                "queue_full", lane, len(self.queue), est,
                retry_after_s=max(self._ttft_ewma, 0.001)))
        saturated = (len(self.queue)
                     >= self.shed_saturation_waves * self.num_slots)
        if (saturated and ttft_deadline_s is not None
                and est > ttft_deadline_s > 0):
            self.shed_total += 1
            raise LoadShedError(Reject(
                "deadline_infeasible", lane, len(self.queue), est,
                retry_after_s=max(est - ttft_deadline_s, 0.001)))
        return super().submit(prompt, max_new_tokens, eos_id, lane=lane,
                              ttft_deadline_s=ttft_deadline_s)

    # -- admission --------------------------------------------------------

    def _admission_order(self) -> List[Request]:
        now = self._clock()
        at_risk: List[Tuple[float, int, Request]] = []
        rest: List[Tuple[int, float, int, Request]] = []
        for i, req in enumerate(self.queue):
            dl = req.deadline_at()
            if (dl is not None and self._ttft_ewma > 0.0
                    and now + self._ttft_ewma + self.deadline_slack_s >= dl):
                if not req.boosted:     # one boost event per request
                    req.boosted = True
                    self._event(req.rid, "sched_boost",
                                deadline_in_s=round(dl - now, 6),
                                est_ttft_s=round(self._ttft_ewma, 6))
                at_risk.append((dl, i, req))
            else:
                rest.append((self.lane_order.get(req.lane, 0),
                             req.submitted_at, i, req))
        at_risk.sort(key=lambda t: t[:2])       # earliest deadline first
        rest.sort(key=lambda t: t[:3])          # lane, then FIFO
        return [t[-1] for t in at_risk] + [t[-1] for t in rest]

    def admit(self, on_admit=None) -> List[int]:
        """Move queued requests into free slots in SLO order. A request
        that cannot fit yet is skipped (no head blocking) unless its
        skip count has crossed ``starvation_skips`` — then it blocks
        admission of everything ordered behind it until it fits."""
        admitted: List[int] = []
        free = self.free_slots()
        if not free or not self.queue:
            return admitted     # saturated: skip the whole-queue sort
        for req in self._admission_order():
            if not free:
                break
            if not self._can_admit(req):
                req.skips += 1
                if req.skips > self.starvation_skips:
                    if req.skips == self.starvation_skips + 1:
                        # once per request: admit() runs every step, and
                        # a head-blocked request can stay blocked for
                        # hours — per-pass events would grow its live
                        # span without bound
                        self._event(req.rid, "sched_block",
                                    skips=req.skips)
                    break           # anti-starvation: now it head-blocks
                self._event(req.rid, "sched_skip", skips=req.skips,
                            reason="no_capacity")
                continue
            slot = free.pop(0)
            self.queue.remove(req)
            self.slots[slot] = SlotState(req, admitted_at=self._clock())
            if on_admit is not None:
                on_admit(slot, req)
            admitted.append(slot)
        return admitted

    def shed_expired(self) -> List[Request]:
        """Pop queued requests whose TTFT deadline has already passed —
        serving them late helps nobody and burns pages interactive
        traffic needs. The engine reports them as structured rejects."""
        now = self._clock()
        dead = [r for r in self.queue
                if r.deadline_at() is not None and now > r.deadline_at()]
        for r in dead:
            self.queue.remove(r)
            self.shed_total += 1
        return dead
