"""Request-lifecycle tracing (``paddle_tpu/observability/tracing.py``):
low-overhead spans in a bounded ring.

One trace per request, one span per phase (prefill chunk, decode block),
with events for the point decisions in between (admitted, sched_skip,
cow_copy, shed):

- **Bounded memory.** Completed spans land in a ring buffer
  (``deque(maxlen=capacity)``).
- **Zero cost when disabled.** ``span()`` returns a process-wide no-op
  singleton; hot paths guard their span fan-out behind ``enabled``.
  Everything here is host-side around the engine's device calls, never
  inside a captured CUDA graph, so tracing on or off cannot change what
  the graphs run.
- **Thread-correct parentage.** The current-span stack is thread-local;
  an explicit ``parent=`` crosses threads.

The exporters write the buffer as span JSONL (:meth:`Tracer.export_jsonl`,
the reference's record schema, checked by :func:`validate_trace_log`) and
as Chrome trace-event JSON (:func:`records_to_chrome`,
:meth:`Tracer.export_chrome`, offline :func:`chrome_trace_from_jsonl`)
loadable in Perfetto, with span events as instant markers.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

# span/trace id 0 is reserved for "none" (the no-op span advertises it)
_NO_ID = 0

# bumped when the span JSONL record shape changes incompatibly
TRACE_SCHEMA_VERSION = 1


class Span:
    """One timed region. Also its own context manager: ``with
    tracer.span("x"):`` pushes/pops the thread-local stack; manual spans
    (``start_span`` … ``finish``) skip the stack for cross-step or
    cross-thread lifecycles (a serving request lives across many
    ``step()`` calls)."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start", "end", "attrs", "events", "thread", "status",
                 "_on_stack")

    def __init__(self, tracer: "Tracer", trace_id: int, span_id: int,
                 parent_id: int, name: str, start: float,
                 attrs: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs = attrs or {}
        self.events: List[tuple] = []      # (t, name, attrs)
        self.thread = threading.current_thread().name
        self.status = "ok"
        self._on_stack = False

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None
                else self.tracer.now()) - self.start

    def set_attrs(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def add_event(self, name: str, **attrs) -> "Span":
        """Point annotation inside the span (scheduler decisions, CoW
        copies, SLO alerts); exported as Chrome instant events."""
        self.events.append((self.tracer.now(), name, attrs))
        return self

    def finish(self, status: Optional[str] = None,
               end: Optional[float] = None):
        """Complete the span and move it into the ring buffer. Safe to
        call once; a second call is ignored (exception paths)."""
        if self.end is not None:
            return
        self.end = self.tracer.now() if end is None else end
        if status is not None:
            self.status = status
        self.tracer._record(self)

    # -- context-manager protocol (stack-tracked spans) -------------------
    def __enter__(self) -> "Span":
        self.tracer._push(self)
        self._on_stack = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._on_stack:
            self.tracer._pop(self)
            self._on_stack = False
        self.finish(status="error" if exc_type is not None else None)
        return False

    def to_record(self) -> Dict[str, Any]:
        """JSONL record: ids, name, wall-clock start, duration, thread,
        status, attributes and events."""
        tr = self.tracer
        rec: Dict[str, Any] = {
            "kind": "span",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "ts": tr.to_wall(self.start),
            "dur_s": round(self.duration_s, 9),
            "thread": self.thread,
            "status": self.status,
        }
        if self.attrs:
            rec["attrs"] = _jsonable_dict(self.attrs)
        if self.events:
            rec["events"] = [
                {"ts": tr.to_wall(t), "name": n,
                 **({"attrs": _jsonable_dict(a)} if a else {})}
                for t, n, a in self.events]
        return rec


class _NoopSpan:
    """The disabled-mode span: a single shared instance whose every
    method is a no-op — ``tracer.span()`` while disabled allocates
    nothing."""

    __slots__ = ()
    trace_id = _NO_ID
    span_id = _NO_ID
    parent_id = _NO_ID
    name = ""
    status = "noop"
    events: List[tuple] = []
    attrs: Dict[str, Any] = {}
    duration_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attrs(self, **attrs):
        return self

    def add_event(self, name, **attrs):
        return self

    def finish(self, status=None, end=None):
        pass


NOOP_SPAN = _NoopSpan()


class _Stack(threading.local):
    def __init__(self):
        self.spans: List[Span] = []


class Tracer:
    """Span factory + bounded ring buffer + exporters.

    The clock is ``time.monotonic`` (matching the engine's step timers);
    :meth:`to_wall` maps it onto unix time via an anchor taken at
    construction so exported records carry real timestamps.
    """

    now = staticmethod(time.monotonic)

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = bool(enabled)
        self._buf: "deque[Span]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._stack = _Stack()
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._mono0 = time.monotonic()
        self._wall0 = time.time()
        self.dropped = 0            # spans evicted by the ring bound

    # -- lifecycle --------------------------------------------------------
    def enable(self, capacity: Optional[int] = None):
        if capacity is not None and capacity != self.capacity:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            with self._lock:
                self.capacity = capacity
                evicted = max(len(self._buf) - capacity, 0)
                self.dropped += evicted     # shrinking evicts oldest
                self._buf = deque(self._buf, maxlen=capacity)
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def clear(self):
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def to_wall(self, t: float) -> float:
        return self._wall0 + (t - self._mono0)

    # -- span creation ----------------------------------------------------
    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        """Stack-tracked span context manager. Disabled → the shared
        no-op (zero allocation). Parent defaults to this thread's
        current span; a root span starts a new trace."""
        if not self.enabled:
            return NOOP_SPAN
        return self._make(name, parent, attrs)

    def start_span(self, name: str, parent: Optional[Span] = None,
                   trace_id: Optional[int] = None, **attrs):
        """Manual span — NOT pushed on the thread stack; the caller owns
        its lifetime and must ``finish()`` it (request-lifecycle roots
        that live across many engine steps, cross-thread children).
        ``trace_id`` adopts an externally minted trace id (a fleet
        router's, a remote caller's) instead of starting a fresh trace —
        the propagation hook that lets one timeline cross process
        boundaries where no parent ``Span`` object can travel."""
        if not self.enabled:
            return NOOP_SPAN
        return self._make(name, parent, attrs, trace_id=trace_id)

    def record_span(self, name: str, start: Optional[float] = None,
                    end: Optional[float] = None,
                    duration_s: Optional[float] = None,
                    parent: Optional[Span] = None,
                    status: Optional[str] = None,
                    trace_id: Optional[int] = None,
                    **attrs) -> Optional[Span]:
        """Record an already-measured interval as a completed span (the
        engine times its device calls anyway; this turns those stamps
        into timeline entries without a second clock read). Give either
        ``start``/``end`` in this tracer's clock, or ``duration_s``
        (ends now)."""
        if not self.enabled:
            return None
        if end is None:
            end = self.now()
        if start is None:
            start = end - (duration_s or 0.0)
        sp = self._make(name, parent, attrs, start=start,
                        trace_id=trace_id)
        sp.finish(status=status, end=end)
        return sp

    def _make(self, name, parent, attrs, start=None,
              trace_id=None) -> Span:
        if parent is None:
            st = self._stack.spans
            parent = st[-1] if st else None
        if parent is None or parent.span_id == _NO_ID:
            if trace_id is None:
                trace_id = next(self._trace_ids)
            parent_id = _NO_ID
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        return Span(self, trace_id, next(self._span_ids), parent_id,
                    name, self.now() if start is None else start, attrs)

    def current(self) -> Optional[Span]:
        st = self._stack.spans
        return st[-1] if st else None

    def _push(self, span: Span):
        self._stack.spans.append(span)

    def _pop(self, span: Span):
        st = self._stack.spans
        if st and st[-1] is span:
            st.pop()
        elif span in st:            # exception-skewed exit order
            st.remove(span)

    def _record(self, span: Span):
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)

    # -- views ------------------------------------------------------------
    def spans(self, name: Optional[str] = None,
              trace_id: Optional[int] = None,
              limit: Optional[int] = None) -> List[Span]:
        """Snapshot of the ring (oldest → newest), optionally filtered."""
        with self._lock:
            out = list(self._buf)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if limit is not None:
            out = out[-limit:] if limit > 0 else []
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name span counts and total seconds (the ``report()``
        table)."""
        agg: Dict[str, Dict[str, float]] = {}
        for s in self.spans():
            a = agg.setdefault(s.name, {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += s.duration_s
        return agg

    # -- exporter ---------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto / chrome://tracing): spans
        as complete ("X") events, span events as instant ("i") markers,
        pid/tid from the recording process/thread. The ``args`` carry
        trace/span ids so one request's lifecycle is clickable."""
        out = records_to_chrome(s.to_record() for s in self.spans())
        out["otherData"] = {"tracer_capacity": self.capacity,
                            "dropped": self.dropped}
        return out

    def export_jsonl(self, path: str) -> int:
        """Append every buffered span to a JSONL file after one
        ``trace_meta`` line, one flushed line per span (a crash loses at
        most the partial final line, as the run log). Returns spans
        written."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        spans = self.spans()
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(
                {"kind": "trace_meta",
                 "schema_version": TRACE_SCHEMA_VERSION,
                 "ts": time.time(), "capacity": self.capacity,
                 "dropped": self.dropped}) + "\n")
            f.flush()
            for s in spans:
                f.write(json.dumps(s.to_record(), sort_keys=True,
                                   default=str) + "\n")
                f.flush()
        return len(spans)

    def export_chrome(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome(), f, default=str)
        return path


def _jsonable_dict(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            try:
                out[k] = float(v)     # numpy/device scalars
            except Exception:
                out[k] = str(v)
    return out


# -- trace JSONL schema validation (check_metrics_log --trace) -------------

_SPAN_REQUIRED = {
    "trace_id": (int,),
    "span_id": (int,),
    "parent_id": (int,),
    "name": (str,),
    "ts": (int, float),
    "dur_s": (int, float),
}


def validate_trace_record(rec: Dict[str, Any], *, index: int = 0):
    """Schema-check one trace JSONL record; raises ValueError with a
    precise message."""

    def fail(msg):
        raise ValueError(f"trace record {index}: {msg} (record={rec!r})")

    if not isinstance(rec, dict):
        fail("not a JSON object")
    kind = rec.get("kind")
    if kind == "trace_meta":
        if not isinstance(rec.get("schema_version"), int):
            fail("trace_meta missing integer 'schema_version'")
        return
    if kind != "span":
        fail(f"unknown kind {kind!r} (expected 'span' or 'trace_meta')")
    for field, types in _SPAN_REQUIRED.items():
        v = rec.get(field)
        if not isinstance(v, types) or isinstance(v, bool):
            fail(f"missing/mistyped span field {field!r}")
    if rec["dur_s"] < 0:
        fail(f"negative dur_s: {rec['dur_s']}")
    if rec["span_id"] == rec["parent_id"]:
        fail("span is its own parent")
    for ev in rec.get("events", ()):
        if not isinstance(ev, dict) or not isinstance(ev.get("name"), str) \
                or not isinstance(ev.get("ts"), (int, float)):
            fail(f"malformed event {ev!r}")
    if rec["name"] == "router.handoff":
        # a handoff span rides the request's trace id and names its
        # source; a placed handoff also names its decode destination
        attrs = rec.get("attrs") or {}
        if not attrs.get("src"):
            fail("router.handoff span missing 'src' attr")
        if rec["trace_id"] == 0:
            fail("router.handoff span is off the request's trace "
                 "(trace_id=0)")
        if rec.get("status", "ok") == "ok" and not attrs.get("dst"):
            fail("placed router.handoff span missing 'dst' attr")


def validate_trace_log(path: str, *, require_spans: int = 0) -> int:
    """Validate every record of a span JSONL export; returns the span
    count. A trailing partial line (crash artifact) is tolerated."""
    from paddle_tpu_torch.observability import runlog
    spans = 0
    for i, rec in enumerate(runlog.read_run_log(path)):
        validate_trace_record(rec, index=i)
        if rec.get("kind") == "span":
            spans += 1
    if spans < require_spans:
        raise ValueError(
            f"{path}: {spans} span records < required {require_spans}")
    return spans


def chrome_trace_valid(trace: Dict[str, Any], *, require_events: int = 0):
    """Assert the Chrome trace-event invariants Perfetto needs: a
    ``traceEvents`` list whose every entry carries ``ph``/``ts``/
    ``pid``/``tid`` (and ``dur`` for complete events). Raises
    ValueError."""
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("chrome trace: missing traceEvents list")
    for i, e in enumerate(evs):
        for k in ("ph", "ts", "pid", "tid", "name"):
            if k not in e:
                raise ValueError(f"chrome trace event {i}: missing {k!r}")
        if e["ph"] == "X" and "dur" not in e:
            raise ValueError(f"chrome trace event {i}: X without dur")
    if len(evs) < require_events:
        raise ValueError(f"chrome trace: {len(evs)} events < required "
                         f"{require_events}")
    return len(evs)


def records_to_chrome(records: Iterable[Dict[str, Any]]
                      ) -> Dict[str, Any]:
    """Span JSONL records (``Span.to_record`` shape) → Chrome trace-
    event JSON: the one function behind :meth:`Tracer.to_chrome`,
    :func:`chrome_trace_from_jsonl` and the flight recorder's bundles."""
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    recs = list(records)
    base = min((r["ts"] for r in recs), default=0.0)
    for r in recs:
        tid = tids.setdefault(r.get("thread", "main"), len(tids))
        args = dict(r.get("attrs", {}), trace_id=r["trace_id"],
                    span_id=r["span_id"], parent_id=r["parent_id"],
                    status=r.get("status", "ok"))
        events.append({"name": r["name"], "cat": "span", "ph": "X",
                       "ts": (r["ts"] - base) * 1e6,
                       "dur": max(r["dur_s"], 0.0) * 1e6,
                       "pid": pid, "tid": tid, "args": args})
        for ev in r.get("events", ()):
            events.append({"name": ev["name"], "cat": "event", "ph": "i",
                           "s": "t", "ts": (ev["ts"] - base) * 1e6,
                           "pid": pid, "tid": tid,
                           "args": dict(ev.get("attrs", {}),
                                        trace_id=r["trace_id"],
                                        span_id=r["span_id"])})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace_from_jsonl(path: str, out_path: str) -> str:
    """Offline conversion: span JSONL export → Chrome trace file."""
    from paddle_tpu_torch.observability import runlog
    recs = [r for r in runlog.read_run_log(path) if r.get("kind") == "span"]
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(records_to_chrome(recs), f)
    return out_path


# -- process-wide default tracer (disabled until someone enables it) -------

_DEFAULT = Tracer(enabled=False)


def default() -> Tracer:
    return _DEFAULT


def enable(capacity: Optional[int] = None) -> Tracer:
    """Turn on the process-wide tracer."""
    return _DEFAULT.enable(capacity)


def disable() -> Tracer:
    return _DEFAULT.disable()
