"""The run summary (``paddle_tpu/observability/report.py``): one
``report()`` renders what the port's registry saw (counters, gauges,
histograms), the profiler's ``record_event`` spans (fed into the same
registry by :func:`observe_span`), the tracer's spans by name, the step
anatomy and the SLO burn rates and alerts, as one text block (the
reference's sorted profiler summary over the whole telemetry surface).
"""

from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch.observability import registry as _registry
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.observability.registry import (Counter, Gauge,
                                                     Histogram, _fmt_labels)

SPAN_METRIC = "record_event_span_seconds"

#: distinct span names kept before new ones lump into "__other__"
_SPAN_NAME_CAP = 256


def observe_span(name: str, seconds: float,
                 reg: Optional[_registry.MetricsRegistry] = None):
    """Feed one ``record_event`` span into the registry (the summary's
    bridge; called by :mod:`paddle_tpu_torch.profiler`). Past
    ``_SPAN_NAME_CAP`` distinct names a new one is counted under
    ``__other__``: the registry keeps a series per name for the life of
    the process."""
    h = (reg or _registry.default()).histogram(
        SPAN_METRIC, "host record_event span durations")
    if len(h.labels_seen()) >= _SPAN_NAME_CAP and \
            (("name", str(name)),) not in h.labels_seen():
        name = "__other__"
    h.observe(seconds, name=name)


def report(reg: Optional[_registry.MetricsRegistry] = None,
           tracer: Optional[_tracing.Tracer] = None) -> str:
    """Render the unified observability summary."""
    reg = reg or _registry.default()
    tracer = tracer or _tracing.default()
    scalars: List[str] = []
    hists: List[str] = []
    spans: List[tuple] = []
    for m in reg.metrics():
        for key in m.labels_seen():
            labels = dict(key)
            if isinstance(m, Histogram):
                s = m.summary(**labels)
                if not s["count"]:
                    continue
                if m.name == SPAN_METRIC:
                    spans.append((labels.get("name", "?"), s))
                    continue
                hists.append(
                    f"{m.name}{_fmt_labels(key)}  count={s['count']} "
                    f"mean={s['mean']:.6g} min={s['min']:.6g} "
                    f"max={s['max']:.6g} sum={s['sum']:.6g}")
            else:
                kind = "c" if isinstance(m, Counter) else "g"
                scalars.append(f"{m.name}{_fmt_labels(key)} "
                               f"[{kind}] {m.value(**labels):.6g}")
    lines = ["== paddle_tpu_torch observability report =="]
    if scalars:
        lines.append("-- counters / gauges --")
        lines.extend(sorted(scalars))
    if hists:
        lines.append("-- histograms --")
        lines.extend(sorted(hists))
    if spans:
        lines.append("-- record_event spans --")
        lines.append(f"{'Event':<32}{'Calls':>8}{'Total(s)':>12}"
                     f"{'Avg(ms)':>12}{'Max(ms)':>12}")
        for name, s in sorted(spans, key=lambda kv: -kv[1]["sum"]):
            lines.append(
                f"{name:<32}{s['count']:>8}{s['sum']:>12.4f}"
                f"{1e3 * s['mean']:>12.3f}{1e3 * s['max']:>12.3f}")
    trace_summary = tracer.summary()
    if trace_summary:
        lines.append("-- trace spans --")
        lines.append(f"{'Span':<32}{'Count':>8}{'Total(s)':>12}")
        for name, a in sorted(trace_summary.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<32}{a['count']:>8.0f}"
                         f"{a['total_s']:>12.4f}")
        if tracer.dropped:
            lines.append(f"(ring dropped {tracer.dropped} older spans)")
    anatomy_lines = _anatomy_lines(reg)
    if anatomy_lines:
        lines.append("-- anatomy --")
        lines.extend(anatomy_lines)
    slo_lines = _slo_lines(reg)
    if slo_lines:
        lines.append("-- slo --")
        lines.extend(slo_lines)
    if len(lines) == 1:
        lines.append("(no metrics recorded)")
    return "\n".join(lines)


def _anatomy_lines(reg: _registry.MetricsRegistry) -> List[str]:
    """Step-anatomy digest, when a StepAnatomy fed this registry: the
    per-phase device-busy split, host-gap/host fractions, sampled
    collective-exposed time, and the resource-headroom snapshot."""
    out: List[str] = []
    phase_h = reg.get("anatomy_phase_seconds")
    if isinstance(phase_h, Histogram):
        sums = {}
        for key in phase_h.labels_seen():
            s = phase_h.summary(**dict(key))
            if s["count"]:
                sums[dict(key).get("phase", "?")] = s["sum"]
        busy = sum(sums.values())
        if busy > 0:
            split = " ".join(f"{p}={v / busy:.1%}"
                             for p, v in sorted(sums.items(),
                                                key=lambda kv: -kv[1]))
            out.append(f"phase_split {split} (busy={busy:.4g}s)")
    for gname, label in (("anatomy_host_gap_frac", "host_gap_frac"),
                         ("anatomy_host_frac", "host_frac"),
                         ("anatomy_collective_exposed_frac",
                          "collective_exposed_frac")):
        g = reg.get(gname)
        if isinstance(g, Gauge) and g.labels_seen():
            out.append(f"{label} {g.value():.4g}")
    coll = reg.get("anatomy_collective_exposed_seconds")
    if isinstance(coll, Histogram):
        s = coll.summary()
        if s["count"]:
            out.append(f"collective_exposed mean={s['mean']:.6g}s "
                       f"samples={s['count']}")
    head = reg.get("serving_headroom")
    if isinstance(head, Gauge):
        parts = []
        for key in sorted(head.labels_seen()):
            labels = dict(key)
            parts.append(f"{labels.get('resource', '?')}="
                         f"{head.value(**labels):.3g}")
        if parts:
            out.append("headroom " + " ".join(parts))
    return out


def _slo_lines(reg: _registry.MetricsRegistry) -> List[str]:
    """Current burn rates + alert counts, when SLO monitoring ran."""
    out: List[str] = []
    burn = reg.get("slo_burn_rate")
    if isinstance(burn, Gauge):
        for key in sorted(burn.labels_seen()):
            labels = dict(key)
            out.append(f"burn_rate slo={labels.get('slo', '?')} "
                       f"window={labels.get('window', '?')} "
                       f"{burn.value(**labels):.4g}")
    alerts = reg.get("slo_alerts_total")
    if isinstance(alerts, Counter):
        for key in sorted(alerts.labels_seen()):
            labels = dict(key)
            out.append(f"alerts slo={labels.get('slo', '?')} "
                       f"severity={labels.get('severity', '?')} "
                       f"{alerts.value(**labels):.0f}")
    return out
