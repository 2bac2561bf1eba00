"""Profiling (``paddle_tpu/profiler.py``; fluid's ``RecordEvent``, the
CUPTI device tracer and ``tools/timeline.py``): host regions and the
device timeline.

- :func:`record_event` names a region: a ``torch.profiler.record_function``
  range (so it shows in a :func:`profiler` trace beside the kernels it
  launched), a span in the registry's ``record_event_span_seconds``
  histogram (:func:`paddle_tpu_torch.observability.report` lists them),
  a span of the default tracer when it is enabled, and a row of the host
  event table of the innermost :func:`profiler` or
  :func:`profile_to_chrome_trace` block on this thread.
- :func:`profiler` collects that table and prints its sorted summary;
  with ``output_dir`` it also runs ``torch.profiler`` (CPU activity, and
  CUDA activity on the card: every kernel by name) and writes its Chrome
  trace to ``output_dir/trace.json``.
- :func:`chrome_trace` writes the host table as a Chrome trace;
  :func:`step_marker` marks a training step (``ProfilerStep#<n>``, the
  name ``torch.profiler`` gives its own steps).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.observability.report import observe_span

#: the file :func:`profiler` writes its device trace to, in output_dir
TRACE_FILE = "trace.json"


class _Events(threading.local):
    def __init__(self):
        self.active: Optional[List] = None


_EVENTS = _Events()


@contextlib.contextmanager
def record_event(name: str):
    """Annotate a region (module docstring). The time is the host's: on
    the card the region returns before the device finishes the work it
    launched."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    observe_span(name, dt)
    tr = _tracing.default()
    if tr.enabled:
        tr.record_span(name, duration_s=dt, cat="record_event")
    if _EVENTS.active is not None:
        _EVENTS.active.append((name, dt, t0))


@contextlib.contextmanager
def _collect_events(out: list):
    """A fresh host-event table for this thread; the previous one back,
    and ``(events, wall seconds)`` appended to ``out``, on exit."""
    prev = _EVENTS.active
    _EVENTS.active = []
    t0 = time.perf_counter()
    try:
        yield
    finally:
        events = _EVENTS.active
        _EVENTS.active = prev
        out.append((events, time.perf_counter() - t0))


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiler(output_dir: Optional[str] = None, *, summary: bool = True):
    """Profile a region (EnableProfiler/DisableProfiler). Always collects
    the host ``record_event`` table and prints its sorted summary on exit
    (``summary``). With ``output_dir`` the region also runs under
    ``torch.profiler`` and its Chrome trace (host ops, and every CUDA
    kernel with its name on the card) lands in
    ``output_dir/trace.json``; the block gets the ``torch.profiler``
    object (``key_averages()``), else None."""
    res = []
    prof = None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
    try:
        with _collect_events(res):
            yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(output_dir, TRACE_FILE))
        events, wall = res[0]
        if summary and events:
            print(format_summary(events, wall))


def format_summary(events, wall: float) -> str:
    """The sorted per-event table (``profiler.cc``'s summaries)."""
    agg: Dict[str, List[float]] = {}
    for name, dt, *_ in events:
        agg.setdefault(name, []).append(dt)
    rows = sorted(agg.items(), key=lambda kv: -sum(kv[1]))
    lines = [f"{'Event':<32}{'Calls':>8}{'Total(s)':>12}{'Avg(ms)':>12}"
             f"{'Ratio':>8}"]
    for name, ts in rows:
        tot = sum(ts)
        lines.append(f"{name:<32}{len(ts):>8}{tot:>12.4f}"
                     f"{1e3 * tot / len(ts):>12.3f}"
                     f"{tot / max(wall, 1e-9):>8.2%}")
    return "\n".join(lines)


def chrome_trace(events, path: str, *, pid: int = 0):
    """Write host events ``(name, seconds, start)`` as a Chrome trace
    (``tools/timeline.py``'s ``_ChromeTraceFormatter``): complete ("X")
    events in microseconds from the first start. The device timeline is
    :func:`profiler`'s ``trace.json``."""
    if not events:
        trace = {"traceEvents": []}
    else:
        base = min(t0 for _, _, t0 in events)
        trace = {"traceEvents": [
            {"name": name, "ph": "X", "pid": pid, "tid": 0,
             "ts": (t0 - base) * 1e6, "dur": dt * 1e6, "cat": "host"}
            for name, dt, t0 in events]}
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


@contextlib.contextmanager
def profile_to_chrome_trace(path: str, *, summary: bool = False):
    """Profile a region and write its host event table as a Chrome trace
    (``fluid.profiler.profiler(output='timeline')``)."""
    res = []
    try:
        with _collect_events(res):
            yield
    finally:
        events, wall = res[0]
        chrome_trace(events, path)
        if summary and events:
            print(format_summary(events, wall))


@contextlib.contextmanager
def step_marker(step: int):
    """Mark a training step: a ``ProfilerStep#<step>`` range in the
    trace."""
    with torch.profiler.record_function(f"ProfilerStep#{int(step)}"):
        yield


def trace_kernel_names(path: str) -> List[str]:
    """The names of the device kernels in a :func:`profiler` trace file
    (its events of category ``kernel``)."""
    with open(path) as f:
        trace = json.load(f)
    return [e.get("name", "") for e in trace.get("traceEvents", [])
            if str(e.get("cat", "")).lower() == "kernel"]


__all__ = ["TRACE_FILE", "chrome_trace", "format_summary", "profiler",
           "profile_to_chrome_trace", "record_event", "step_marker",
           "trace_kernel_names"]
