"""Metrics registry: Counter / Gauge / Histogram with labels.

The subset of ``paddle_tpu/observability/registry.py`` the serving
engine calls: plain host-side Python, one lock per metric and per
registry, label sets keyed by sorted ``(key, value)`` tuples so
``counter.inc(reason="a")`` and ``counter.inc(reason="b")`` are
independent series of one metric. Tracing, the SLO monitor, step
anatomy and the flight recorder are later slices.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

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


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

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


class Gauge(_Metric):
    """Point-in-time value."""

    kind = "gauge"

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


class Histogram(_Metric):
    """Cumulative-bucket histogram + running min/max/sum/count."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _new_cell(self):
        return _HistCell(len(self.buckets))

    def observe(self, v: float, **labels) -> "Histogram":
        v = float(v)
        cell = self._cell(labels)
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
        return self

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


_DEFAULT = MetricsRegistry()


def default() -> MetricsRegistry:
    return _DEFAULT
