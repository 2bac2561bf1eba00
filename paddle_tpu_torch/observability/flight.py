"""Crash flight recorder (``paddle_tpu/observability/flight.py``):
bounded black-box ring + postmortem bundles.

:class:`FlightRecorder` rides along with an engine, keeps a bounded ring
of recent health snapshots next to the
:class:`~paddle_tpu_torch.observability.anatomy.StepAnatomy` record
ring, and on demand dumps one self-contained, schema-validated
postmortem bundle:

- ``anatomy``: the recent per-step anatomy records;
- ``health``: the last health snapshot (+ the bounded trajectory in
  ``snapshots``);
- ``metrics``: a flat registry snapshot at dump time;
- ``chrome_trace``: the tracer ring rendered as Chrome trace-event
  JSON (Perfetto-loadable), so victim ``trace_ids`` are clickable;
- ``reason`` / ``replica`` / ``ts``: why, who, when.

Bundles validate via :func:`validate_postmortem_bundle` and carry the
reference's schema name, so either package's validator reads either
package's bundles. Everything is host-side and bounded, and a dump
after a device fault still works: the rings outlive the device state.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from paddle_tpu_torch.observability import registry as _registry
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.observability.anatomy import (StepAnatomy,
                                                    validate_anatomy_records)

POSTMORTEM_SCHEMA = "paddle_tpu.postmortem-v1"

# a replica keeps the last few bundles it dumped so /debug/postmortem
# can serve them after the fact without unbounded growth
MAX_BUNDLES_KEPT = 8


class FlightRecorder:
    """Bounded black box for one replica/engine.

    ``note(health)`` appends a health snapshot (the engine calls it from
    its health refresh — cheap dict copy, every ``snapshot_every``-th
    call lands); ``dump(reason, ...)`` assembles the postmortem bundle.
    Thread-safe: a monitor may dump from its own thread while the engine
    step thread keeps noting.
    """

    def __init__(self, name: str = "replica",
                 anatomy: Optional[StepAnatomy] = None,
                 registry: Optional[_registry.MetricsRegistry] = None,
                 tracer: Optional[_tracing.Tracer] = None,
                 capacity: int = 256, snapshot_every: int = 8,
                 anatomy_tail: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        self.name = name
        self.anatomy = anatomy
        self.registry = registry or _registry.default()
        self.tracer = tracer or _tracing.default()
        self.snapshot_every = snapshot_every
        self.anatomy_tail = anatomy_tail
        self._snaps: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._notes = 0
        self._bundles: "deque[Dict[str, Any]]" = deque(
            maxlen=MAX_BUNDLES_KEPT)
        self._c_dumps = self.registry.counter(
            "flight_postmortems_total",
            "postmortem bundles dumped, by reason")

    # -- black-box feed ---------------------------------------------------
    def note(self, health: Dict[str, Any]) -> None:
        """Record a health snapshot; only every ``snapshot_every``-th
        call lands in the ring (the engine notes once per step)."""
        with self._lock:
            self._notes += 1
            if (self._notes - 1) % self.snapshot_every:
                return
            self._snaps.append({"ts": time.time(), "health": dict(health)})

    def snapshots(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._snaps)

    # -- postmortem -------------------------------------------------------
    def dump(self, reason: str, trace_ids: Iterable[int] = (),
             health: Optional[Dict[str, Any]] = None,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Assemble a postmortem bundle NOW. Safe on a dead replica:
        everything read here is host-side ring state."""
        snaps = self.snapshots()
        if health is None:
            health = snaps[-1]["health"] if snaps else {}
        anatomy_recs: List[Dict[str, Any]] = []
        anatomy_summary: Dict[str, Any] = {}
        if self.anatomy is not None:
            anatomy_recs = self.anatomy.records(limit=self.anatomy_tail)
            anatomy_summary = self.anatomy.summary()
        try:
            chrome = _tracing.records_to_chrome(
                s.to_record() for s in self.tracer.spans())
        except Exception:                     # never let telemetry break
            chrome = {"traceEvents": []}      # the dump path
        bundle: Dict[str, Any] = {
            "schema": POSTMORTEM_SCHEMA,
            "reason": str(reason),
            "replica": self.name,
            "ts": time.time(),
            "health": dict(health),
            "snapshots": snaps,
            "anatomy": anatomy_recs,
            "anatomy_summary": anatomy_summary,
            "metrics": self.registry.snapshot(),
            "trace_ids": sorted({int(t) for t in trace_ids}),
            "chrome_trace": chrome,
        }
        if extra:
            bundle["extra"] = dict(extra)
        self._c_dumps.inc(reason=str(reason))
        with self._lock:
            self._bundles.append(bundle)
        return bundle

    def bundles(self) -> List[Dict[str, Any]]:
        """Recently dumped bundles, oldest → newest (bounded)."""
        with self._lock:
            return list(self._bundles)


# -- schema validation ----------------------------------------------------

def validate_postmortem_bundle(bundle: Dict[str, Any]) -> None:
    """Assert the postmortem bundle schema; raises ValueError with a
    precise message."""

    def fail(msg):
        raise ValueError(f"postmortem bundle: {msg}")

    if not isinstance(bundle, dict):
        fail(f"is {type(bundle).__name__}, not an object")
    if bundle.get("schema") != POSTMORTEM_SCHEMA:
        fail(f"schema is {bundle.get('schema')!r}, "
             f"expected {POSTMORTEM_SCHEMA!r}")
    for field, types in (("reason", (str,)), ("replica", (str,)),
                         ("ts", (int, float)), ("health", (dict,)),
                         ("snapshots", (list,)), ("anatomy", (list,)),
                         ("metrics", (dict,)), ("trace_ids", (list,)),
                         ("chrome_trace", (dict,))):
        v = bundle.get(field)
        if not isinstance(v, types) or isinstance(v, bool):
            fail(f"missing/mistyped {field!r} "
                 f"({type(v).__name__}, want {types})")
    if not bundle["reason"]:
        fail("empty reason")
    for i, t in enumerate(bundle["trace_ids"]):
        if not isinstance(t, int) or isinstance(t, bool) or t < 0:
            fail(f"trace_ids[{i}] is {t!r}, want non-negative int")
    for i, snap in enumerate(bundle["snapshots"]):
        if not isinstance(snap, dict) or "ts" not in snap \
                or not isinstance(snap.get("health"), dict):
            fail(f"snapshots[{i}] malformed: {snap!r}")
    for k, v in bundle["metrics"].items():
        if not isinstance(k, str) \
                or not isinstance(v, (int, float)) or isinstance(v, bool):
            fail(f"metrics[{k!r}] is {v!r}, want numeric scalar")
    try:
        validate_anatomy_records(bundle["anatomy"])
    except ValueError as e:
        fail(f"anatomy section invalid: {e}")
    try:
        _tracing.chrome_trace_valid(bundle["chrome_trace"])
    except ValueError as e:
        fail(f"chrome_trace invalid: {e}")
