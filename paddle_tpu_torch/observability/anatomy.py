"""Step-time anatomy (``paddle_tpu/observability/anatomy.py``): where
one serving step's wall time goes.

Per *step*: how much time is host gap between steps, how much is spent
inside the device calls, split by phase (prefill / decode / draft /
verify), and how much is host assembly. :class:`StepAnatomy` is the
host-side accumulator the engine drives around its device calls
(captured CUDA graphs on the card); nothing here runs inside a graph:

- ``begin_step()`` stamps the step start and the host gap since the
  previous step ended;
- ``add_phase(phase, start, end)`` records one timed device interval
  (the engine already holds these stamps around every call);
- ``set_collective(real_s, probe_s)`` lands a sampled collectives-elided
  probe (the ``tp_probe`` discipline: the same shapes with the
  all-reduces elided; the delta is the exposed collective time);
- ``end_step(tokens=...)`` closes the record, pushes it into a bounded
  ring, publishes registry histograms/gauges, and emits trace spans so
  one Perfetto export shows anatomy alongside ``serving.request``.

Records are plain dicts validated by :func:`validate_anatomy_record` /
:func:`validate_anatomy_records`: monotonic step ids, non-negative
times, and phase sums bounded by step wall time.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from paddle_tpu_torch.observability import registry as _registry
from paddle_tpu_torch.observability import tracing as _tracing

ANATOMY_SCHEMA_VERSION = 1

# the engine's phase vocabulary; validation accepts these plus any
# future phase name (schema checks types, not the closed set)
PHASES = ("prefill", "decode", "draft", "verify")

# phase-time floats compare against wall time measured by separate
# clock reads; allow this much skew before calling the record corrupt
_EPS = 1e-6


class StepAnatomy:
    """Per-step wall-time decomposition with a bounded record ring.

    Single-writer (the engine step thread); reads (``records()``,
    ``summary()``, the flight recorder's dump) are lock-protected so
    exposition/monitor threads can snapshot mid-step.
    """

    now = staticmethod(time.monotonic)

    def __init__(self, registry: Optional[_registry.MetricsRegistry] = None,
                 tracer: Optional[_tracing.Tracer] = None,
                 capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.registry = registry or _registry.default()
        self.tracer = tracer or _tracing.default()
        self.capacity = capacity
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._cur: Optional[Dict[str, Any]] = None
        self._last_end: Optional[float] = None
        self._step_seq = 0
        self._mono0 = time.monotonic()
        self._wall0 = time.time()
        # totals for summary() — cheap running sums, not ring-derived,
        # so the summary reflects the whole run even after ring wrap
        self._tot = {"steps": 0, "wall_s": 0.0, "gap_s": 0.0,
                     "host_s": 0.0, "tokens": 0,
                     "probe_samples": 0, "collective_exposed_s": 0.0,
                     "probed_wall_s": 0.0}
        self._tot_phase: Dict[str, float] = {}
        r = self.registry
        self._h_wall = r.histogram(
            "anatomy_step_wall_seconds",
            "serving step wall time (begin_step..end_step)")
        self._h_gap = r.histogram(
            "anatomy_host_gap_seconds",
            "host gap between consecutive steps")
        self._h_phase = r.histogram(
            "anatomy_phase_seconds",
            "device-busy time per step by phase")
        self._h_coll = r.histogram(
            "anatomy_collective_exposed_seconds",
            "sampled exposed collective time per probed step")
        self._g_gap_frac = r.gauge(
            "anatomy_host_gap_frac",
            "fraction of timeline spent in host gaps between steps")
        self._g_host_frac = r.gauge(
            "anatomy_host_frac",
            "fraction of step wall spent in host assembly/data wait")
        self._g_coll_frac = r.gauge(
            "anatomy_collective_exposed_frac",
            "exposed collective time / wall on probed steps")
        self._c_steps = r.counter(
            "anatomy_steps_total", "anatomy records closed").child()
        self._c_probes = r.counter(
            "anatomy_probe_samples_total",
            "collective probe samples taken").child()
        self._phase_children: Dict[str, object] = {}

    def to_wall(self, t: float) -> float:
        return self._wall0 + (t - self._mono0)

    # -- step lifecycle ---------------------------------------------------
    def begin_step(self, step_id: Optional[int] = None) -> None:
        t0 = self.now()
        gap = (t0 - self._last_end) if self._last_end is not None else 0.0
        if step_id is None:
            step_id = self._step_seq
        self._step_seq = step_id + 1
        self._cur = {"step": int(step_id), "t0": t0,
                     "gap_s": max(gap, 0.0), "phases": {},
                     "intervals": [], "collective": None}

    def add_phase(self, phase: str, start: float, end: float) -> None:
        """Attribute one device interval (tracer-clock stamps the engine
        already took around the device call) to ``phase``."""
        cur = self._cur
        if cur is None:
            return
        dur = max(end - start, 0.0)
        cur["phases"][phase] = cur["phases"].get(phase, 0.0) + dur
        cur["intervals"].append((phase, start, end))

    def cancel_step(self) -> None:
        """Abandon the open step without recording it (an idle engine
        tick). The gap anchor still advances, so the next real step's
        host gap measures dispatch overhead, not queue-empty waiting."""
        if self._cur is not None:
            self._cur = None
            self._last_end = self.now()

    def set_collective(self, real_s: float, probe_s: float) -> None:
        """Land a sampled collectives-elided probe: ``real_s`` is the
        tp step's wall, ``probe_s`` the same shapes with the all-reduces
        elided; the positive delta is the exposed collective time."""
        cur = self._cur
        if cur is None:
            return
        cur["collective"] = (float(real_s), float(probe_s))

    def end_step(self, tokens: int = 0) -> Optional[Dict[str, Any]]:
        cur = self._cur
        if cur is None:
            return None
        self._cur = None
        t1 = self.now()
        wall = max(t1 - cur["t0"], 0.0)
        phases = {p: round(s, 9) for p, s in cur["phases"].items()}
        busy = sum(phases.values())
        host = max(wall - busy, 0.0)
        rec: Dict[str, Any] = {
            "kind": "anatomy",
            "schema_version": ANATOMY_SCHEMA_VERSION,
            "step": cur["step"],
            "ts": self.to_wall(cur["t0"]),
            "wall_s": round(wall, 9),
            "host_gap_s": round(cur["gap_s"], 9),
            "host_s": round(host, 9),
            "phases": phases,
            "tokens": int(tokens),
        }
        if cur["collective"] is not None:
            real_s, probe_s = cur["collective"]
            rec["probe_wall_s"] = round(probe_s, 9)
            rec["collective_exposed_s"] = round(max(real_s - probe_s, 0.0),
                                                9)
        self._publish(rec, cur, t1)
        self._last_end = t1
        with self._lock:
            self._ring.append(rec)
        return rec

    def _publish(self, rec: Dict[str, Any], cur: Dict[str, Any],
                 t1: float) -> None:
        wall = rec["wall_s"]
        self._h_wall.observe(wall)
        self._h_gap.observe(rec["host_gap_s"])
        for phase, s in rec["phases"].items():
            ch = self._phase_children.get(phase)
            if ch is None:
                ch = self._phase_children[phase] = \
                    self._h_phase.child(phase=phase)
            ch.observe(s)
        self._c_steps.inc()
        t = self._tot
        t["steps"] += 1
        t["wall_s"] += wall
        t["gap_s"] += rec["host_gap_s"]
        t["host_s"] += rec["host_s"]
        t["tokens"] += rec["tokens"]
        for phase, s in rec["phases"].items():
            self._tot_phase[phase] = self._tot_phase.get(phase, 0.0) + s
        timeline = t["wall_s"] + t["gap_s"]
        if timeline > 0:
            self._g_gap_frac.set(t["gap_s"] / timeline)
        if t["wall_s"] > 0:
            self._g_host_frac.set(t["host_s"] / t["wall_s"])
        if "collective_exposed_s" in rec:
            self._c_probes.inc()
            self._h_coll.observe(rec["collective_exposed_s"])
            t["probe_samples"] += 1
            t["collective_exposed_s"] += rec["collective_exposed_s"]
            t["probed_wall_s"] += wall
            if t["probed_wall_s"] > 0:
                self._g_coll_frac.set(
                    t["collective_exposed_s"] / t["probed_wall_s"])
        tracer = self.tracer
        if tracer.enabled:
            attrs = {"step": rec["step"], "host_gap_s": rec["host_gap_s"],
                     "host_s": rec["host_s"], "tokens": rec["tokens"]}
            if "collective_exposed_s" in rec:
                attrs["collective_exposed_s"] = rec["collective_exposed_s"]
            sp = tracer.record_span("anatomy.step", start=cur["t0"],
                                    end=t1, **attrs)
            for phase, s0, s1 in cur["intervals"]:
                tracer.record_span(f"anatomy.{phase}", start=s0, end=s1,
                                   parent=sp, step=rec["step"])

    # -- views ------------------------------------------------------------
    def records(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Ring snapshot, oldest → newest."""
        with self._lock:
            out = list(self._ring)
        if limit is not None:
            out = out[-limit:] if limit > 0 else []
        return out

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def summary(self) -> Dict[str, Any]:
        """Whole-run aggregate (survives ring wrap): phase split,
        host-gap fraction, and the sampled collective economics."""
        t = dict(self._tot)
        steps = t["steps"]
        wall = t["wall_s"]
        timeline = wall + t["gap_s"]
        out: Dict[str, Any] = {
            "steps": steps,
            "wall_s": wall,
            "tokens": t["tokens"],
            "host_gap_frac": (t["gap_s"] / timeline) if timeline else 0.0,
            "host_frac": (t["host_s"] / wall) if wall else 0.0,
            "phase_s": dict(self._tot_phase),
            "phase_frac": {p: (s / wall if wall else 0.0)
                           for p, s in self._tot_phase.items()},
            "probe_samples": t["probe_samples"],
        }
        if t["probe_samples"]:
            out["collective_exposed_s"] = (
                t["collective_exposed_s"] / t["probe_samples"])
            out["collective_exposed_frac"] = (
                t["collective_exposed_s"] / t["probed_wall_s"]
                if t["probed_wall_s"] else 0.0)
        return out

    def export_jsonl(self, path: str) -> int:
        """Append the ring to a JSONL file (one flushed line per record,
        the run log's crash-safety contract). Returns records written."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        recs = self.records()
        with open(path, "a", encoding="utf-8") as f:
            for rec in recs:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
        return len(recs)


# -- schema validation (check_metrics_log --anatomy) ------------------------

def validate_anatomy_record(rec: Dict[str, Any], *, index: int = 0,
                            prev_step: Optional[int] = None) -> int:
    """Schema-check one anatomy record; returns its step id so callers
    can thread the monotonicity check. Raises ValueError with a precise
    message."""

    def fail(msg):
        raise ValueError(f"anatomy record {index}: {msg} (record={rec!r})")

    if not isinstance(rec, dict):
        fail("not a JSON object")
    if rec.get("kind") != "anatomy":
        fail(f"kind is {rec.get('kind')!r}, expected 'anatomy'")
    step = rec.get("step")
    if not isinstance(step, int) or isinstance(step, bool):
        fail("missing/mistyped integer 'step'")
    if prev_step is not None and step <= prev_step:
        fail(f"step ids not monotonic: {step} after {prev_step}")
    for field in ("wall_s", "host_gap_s", "host_s", "ts"):
        v = rec.get(field)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            fail(f"missing/mistyped numeric {field!r}")
        if field != "ts" and v < 0:
            fail(f"negative {field}: {v}")
    phases = rec.get("phases")
    if not isinstance(phases, dict):
        fail("missing 'phases' object")
    for p, s in phases.items():
        if not isinstance(p, str):
            fail(f"non-string phase key {p!r}")
        if not isinstance(s, (int, float)) or isinstance(s, bool) or s < 0:
            fail(f"phase {p!r} has bad duration {s!r}")
    if sum(phases.values()) > rec["wall_s"] + _EPS:
        fail(f"phase sum {sum(phases.values()):.9f} exceeds wall "
             f"{rec['wall_s']:.9f}")
    if "collective_exposed_s" in rec:
        v = rec["collective_exposed_s"]
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            fail(f"bad collective_exposed_s {v!r}")
    tok = rec.get("tokens", 0)
    if not isinstance(tok, int) or isinstance(tok, bool) or tok < 0:
        fail(f"bad tokens {tok!r}")
    return step


def validate_anatomy_records(recs: Iterable[Dict[str, Any]]) -> int:
    """Validate an in-memory record sequence (monotonic step ids
    included); returns the record count."""
    prev: Optional[int] = None
    n = 0
    for i, rec in enumerate(recs):
        prev = validate_anatomy_record(rec, index=i, prev_step=prev)
        n += 1
    return n


def validate_anatomy_log(path: str, *, require_steps: int = 0) -> int:
    """Validate an anatomy JSONL export; returns the record count. A
    trailing partial line (crash artifact) is tolerated."""
    from paddle_tpu_torch.observability import runlog
    n = validate_anatomy_records(runlog.read_run_log(path))
    if n < require_steps:
        raise ValueError(
            f"{path}: {n} anatomy records < required {require_steps}")
    return n
