"""Metrics registry: Counter / Gauge / Histogram with labels.

The subset of ``paddle_tpu/observability/registry.py`` the serving
engine and its observability (tracing, the SLO monitor, step anatomy,
the flight recorder, the exposition server) call: plain host-side
Python, one lock per metric and per registry, label sets keyed by sorted
``(key, value)`` tuples so ``counter.inc(reason="a")`` and
``counter.inc(reason="b")`` are independent series of one metric;
bound children for per-step hot paths, a flat ``snapshot()`` and the
Prometheus text exposition.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    # Prometheus exposition: backslash, double-quote and newline must be
    # escaped inside label values or the whole dump is unparseable
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    return ("{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
            + "}")


class _Metric:
    kind = "untyped"
    _child_cls: type = None

    def __init__(self, name: str, help: str = ""):
        if not name or any(c in name for c in " \t\n{}\","):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    def _cell(self, labels: Dict[str, object]):
        key = _label_key(labels)
        with self._lock:
            cell = self._series.get(key)
            if cell is None:
                cell = self._series[key] = self._new_cell()
            return cell

    def child(self, **labels):
        """Bind one label set to a reusable handle: its updates take one
        lock acquisition and no label-key sort (per-step metrics)."""
        return self._child_cls(self, self._cell(labels))

    def labels_seen(self) -> List[LabelKey]:
        with self._lock:
            return list(self._series)


class _BoundChild:
    """A (metric, cell) pair: pre-resolved series handle."""

    __slots__ = ("_metric", "_cell")

    def __init__(self, metric: _Metric, cell):
        self._metric = metric
        self._cell = cell


class _CounterChild(_BoundChild):
    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(
                f"counter {self._metric.name} cannot decrease (n={n})")
        with self._metric._lock:
            self._cell[0] += n

    def value(self) -> float:
        with self._metric._lock:
            return self._cell[0]


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"
    _child_cls = _CounterChild

    def _new_cell(self):
        return [0.0]

    def inc(self, n: float = 1.0, **labels) -> "Counter":
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        cell = self._cell(labels)
        with self._lock:
            cell[0] += n
        return self

    def value(self, **labels) -> float:
        cell = self._cell(labels)
        with self._lock:
            return cell[0]


class _GaugeChild(_BoundChild):
    def set(self, v: float):
        with self._metric._lock:
            self._cell[0] = float(v)

    def value(self) -> float:
        with self._metric._lock:
            return self._cell[0]


class Gauge(_Metric):
    """Point-in-time value."""

    kind = "gauge"
    _child_cls = _GaugeChild

    def _new_cell(self):
        return [0.0]

    def set(self, v: float, **labels) -> "Gauge":
        cell = self._cell(labels)
        with self._lock:
            cell[0] = float(v)
        return self

    def value(self, **labels) -> float:
        cell = self._cell(labels)
        with self._lock:
            return cell[0]


#: default buckets suit step/span latencies (seconds): 100us .. 100s
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
                   1.0, 5.0, 10.0, 50.0, 100.0)


class _HistCell:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)  # +1 = +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class _HistogramChild(_BoundChild):
    def observe(self, v: float):
        self._metric._observe_cell(self._cell, float(v))


class Histogram(_Metric):
    """Cumulative-bucket histogram + running min/max/sum/count."""

    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _new_cell(self):
        return _HistCell(len(self.buckets))

    def observe(self, v: float, **labels) -> "Histogram":
        self._observe_cell(self._cell(labels), float(v))
        return self

    def _observe_cell(self, cell: _HistCell, v: float):
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            cell.counts[i] += 1
            cell.count += 1
            cell.sum += v
            cell.min = min(cell.min, v)
            cell.max = max(cell.max, v)

    def summary(self, **labels) -> Dict[str, float]:
        cell = self._cell(labels)
        with self._lock:
            if not cell.count:
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0}
            return {"count": cell.count, "sum": cell.sum,
                    "mean": cell.sum / cell.count,
                    "min": cell.min, "max": cell.max}

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile (the ``histogram_quantile``
        convention), clamped to the observed [min, max]. ``q`` in
        [0, 1]; 0.0 for an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        cell = self._cell(labels)
        with self._lock:
            if not cell.count:
                return 0.0
            target = q * cell.count
            cum = 0.0
            lo = cell.min
            for i, c in enumerate(cell.counts):
                hi = (self.buckets[i] if i < len(self.buckets)
                      else cell.max)
                if c and cum + c >= target:
                    frac = (target - cum) / c
                    v = lo + frac * max(hi - lo, 0.0)
                    return min(max(v, cell.min), cell.max)
                cum += c
                lo = hi
            return cell.max

    def count_and_over(self, v: float, **labels):
        """(total, definitely-over-``v``) in one lock acquisition (the
        SLO monitor's atomic read). "Over" is conservative: only buckets
        whose whole range lies above ``v`` count, so a budget on a
        bucket edge counts exactly."""
        v = float(v)
        cell = self._cell(labels)
        with self._lock:
            total = float(cell.count)
            if not cell.count or v >= cell.max:
                return total, 0.0
            if v < cell.min:
                return total, total
            over = 0.0
            lo = -math.inf
            for i, c in enumerate(cell.counts):
                if lo >= v:
                    over += c
                lo = (self.buckets[i] if i < len(self.buckets)
                      else math.inf)
            return total, over

    def _render_cell(self, labels: Dict[str, object]):
        """(counts, count, sum) under the metric lock: a render whose
        bucket total agrees with its ``_count`` line."""
        cell = self._cell(labels)
        with self._lock:
            return list(cell.counts), cell.count, cell.sum


class MetricsRegistry:
    """Name -> metric table; the process-wide instance is :func:`default`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{'name{label="v"}': scalar}`` view; histograms flatten
        to ``_count/_sum/_mean/_min/_max`` suffixes."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            for key in m.labels_seen():
                lab = _fmt_labels(key)
                if isinstance(m, Histogram):
                    s = m.summary(**dict(key))
                    for suffix in ("count", "sum", "mean", "min", "max"):
                        out[f"{m.name}_{suffix}{lab}"] = s[suffix]
                else:
                    out[f"{m.name}{lab}"] = m.value(**dict(key))
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        for m in self.metrics():
            keys = m.labels_seen()
            if not keys:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key in keys:
                labels = dict(key)
                if isinstance(m, Histogram):
                    counts, count, total = m._render_cell(labels)
                    cum = 0
                    for b, c in zip(m.buckets, counts):
                        cum += c
                        lab = _fmt_labels(key + (("le", repr(float(b))),))
                        lines.append(f"{m.name}_bucket{lab} {cum}")
                    cum += counts[-1]
                    lab = _fmt_labels(key + (("le", "+Inf"),))
                    lines.append(f"{m.name}_bucket{lab} {cum}")
                    lab = _fmt_labels(key)
                    lines.append(f"{m.name}_sum{lab} {_fmt_num(total)}")
                    lines.append(f"{m.name}_count{lab} {count}")
                else:
                    lab = _fmt_labels(key)
                    lines.append(
                        f"{m.name}{lab} {_fmt_num(m.value(**labels))}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


_DEFAULT = MetricsRegistry()


def default() -> MetricsRegistry:
    return _DEFAULT
