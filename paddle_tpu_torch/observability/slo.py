"""SLO burn-rate monitoring (``paddle_tpu/observability/slo.py``): see
deadline pressure BEFORE requests fail.

The serving engine already histograms TTFT and queue-wait; this module
turns those aggregates into the standard multi-window burn-rate signal
(the SRE-workbook alerting recipe): the **burn rate** is the observed
violation fraction — requests whose latency blew the budget — divided
by the error budget the objective allows. Burn 1.0 = exactly consuming
the budget; burn 14 = the whole month's budget gone in ~2 days.

Two windows guard against both failure modes of threshold alerting: the
**fast** window catches a sudden cliff quickly, the **slow** window
keeps one latency spike from paging anyone — an alert needs BOTH
windows over the threshold. Alerts are edge-triggered (one count per
excursion, re-armed when the burn drops back under), published three
ways at once:

  - ``slo_burn_rate{slo,window}`` gauge (scrapeable via ``/metrics``),
  - ``slo_alerts_total{slo,severity}`` counter,
  - an ``slo.alert`` span event into the trace timeline, so the alert
    sits next to the exact requests that caused it in Perfetto.

The monitor is pull-based and host-side: ``check()`` reads cumulative
histogram state under the registry locks (no per-request work on the
hot path) — the serving engine calls it once per ``step()``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.observability import registry as _registry
from paddle_tpu_torch.observability import tracing as _tracing

# (severity, burn threshold) — highest first; the classic page/ticket
# split: page at 14.4x (a 30-day budget gone in 2 days), ticket at 6x
DEFAULT_THRESHOLDS = (("page", 14.4), ("ticket", 6.0))


class BurnRateMonitor:
    """Burn-rate watch over one latency histogram vs one budget.

    ``objective`` is the target success fraction (0.99 → 1% of requests
    may exceed ``budget_s`` before the error budget is gone).
    ``windows`` is (fast_s, slow_s). A fake ``clock`` makes the window
    arithmetic unit-testable without sleeping.
    """

    def __init__(self, metric: str = "serving_ttft_seconds",
                 budget_s: float = 1.0, *,
                 objective: float = 0.99,
                 windows: Tuple[float, float] = (60.0, 300.0),
                 thresholds: Sequence[Tuple[str, float]]
                 = DEFAULT_THRESHOLDS,
                 registry: Optional[_registry.MetricsRegistry] = None,
                 tracer: Optional[_tracing.Tracer] = None,
                 clock=time.monotonic):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), "
                             f"got {objective}")
        if budget_s <= 0:
            raise ValueError(f"budget_s must be > 0, got {budget_s}")
        fast, slow = windows
        if fast > slow:
            raise ValueError(f"fast window {fast} > slow window {slow}")
        self.metric = metric
        self.budget_s = float(budget_s)
        self.objective = float(objective)
        self.error_budget = 1.0 - self.objective
        self.windows = (float(fast), float(slow))
        self.thresholds = sorted(thresholds, key=lambda t: -t[1])
        self.reg = registry or _registry.default()
        self.tracer = tracer or _tracing.default()
        self._clock = clock
        # (t, total_count, over_budget_count) samples, pruned past the
        # slow window (+1 baseline). Appends are rate-limited to
        # fast_window/60 so the deque holds ~60 fast-window / ~300
        # slow-window samples no matter how often check() runs — the
        # engine calls it every step, and per-step cost/memory must not
        # scale with step rate
        self._samples: Deque[Tuple[float, float, float]] = deque()
        self._min_sample_interval = max(self.windows[0] / 60.0, 1e-3)
        self._active: set = set()    # severities currently firing
        self.alerts_total = 0
        self.burn: Dict[str, float] = {"fast": 0.0, "slow": 0.0}
        self._g = self.reg.gauge(
            "slo_burn_rate",
            "error-budget burn rate (violation frac / allowed frac)")
        self._c = self.reg.counter(
            "slo_alerts_total", "edge-triggered SLO burn-rate alerts")
        # t=0 baseline so the first window covers monitoring start
        self._samples.append((self._clock(), *self._read()))

    # -- histogram read ----------------------------------------------------
    def _read(self) -> Tuple[float, float]:
        """(total, over_budget) cumulative counts from the histogram; a
        metric that does not exist yet reads as no traffic. Violations
        use the CONSERVATIVE bucket count (``count_over``): samples in
        the budget's own bucket never page — put the budget on a bucket
        edge for exact accounting."""
        h = self.reg.get(self.metric)
        if not isinstance(h, _registry.Histogram):
            return 0.0, 0.0
        total = 0.0
        over = 0.0
        for key in h.labels_seen():
            # one lock acquisition per series: a concurrent writer can
            # never skew over vs total within a sample
            t, o = h.count_and_over(self.budget_s, **dict(key))
            total += t
            over += o
        return total, over

    # -- the periodic check ------------------------------------------------
    def check(self) -> Dict[str, float]:
        """Sample the histogram, recompute both windows' burn rates,
        update the gauges, and fire/re-arm alerts. Returns the burn
        dict (also kept on ``self.burn``)."""
        now = self._clock()
        total, over = self._read()
        # rate-limited history: burn below always uses the CURRENT
        # (total, over) against the sampled baselines, so skipping an
        # append never staleness the result — it only bounds the deque
        if now - self._samples[-1][0] >= self._min_sample_interval:
            self._samples.append((now, total, over))
        slow_w = self.windows[1]
        # prune: keep one sample at-or-before the slow window start as
        # that window's baseline
        while len(self._samples) >= 2 \
                and self._samples[1][0] <= now - slow_w:
            self._samples.popleft()
        for name, win in zip(("fast", "slow"), self.windows):
            self.burn[name] = self._window_burn(now, win, total, over)
            self._g.set(self.burn[name], slo=self.metric, window=name)
        self._update_alerts()
        return dict(self.burn)

    def _window_burn(self, now, win, total, over) -> float:
        base_t, base_total, base_over = self._samples[0]
        for s in self._samples:
            if s[0] <= now - win:
                base_t, base_total, base_over = s
            else:
                break
        d_total = total - base_total
        # clamp into [0, d_total]: the conservative "over" count is not
        # monotonic across count_and_over's exact/conservative regimes
        # (e.g. all-violating traffic reads exact until an in-budget
        # sample lowers cell.min), and a negative violation delta must
        # never publish a negative burn rate
        d_over = max(min(over - base_over, d_total), 0.0)
        if d_total <= 0:
            return 0.0
        return (d_over / d_total) / self.error_budget

    def _update_alerts(self):
        """One count per excursion: firing a severity also marks every
        LOWER severity active (they are the same excursion), so burn
        decaying from the page band through the ticket band does not
        mint a second alert — only a fresh excursion (full recovery
        first) or an escalation to a higher severity counts."""
        fast, slow = self.burn["fast"], self.burn["slow"]
        fired = None
        fired_thr = None
        for sev, thr in self.thresholds:
            if fast >= thr and slow >= thr:
                fired, fired_thr = sev, thr  # highest severity only
                break
        for sev, thr in self.thresholds:
            if fast < thr or slow < thr:
                self._active.discard(sev)    # re-arm on recovery
        if fired is not None and fired not in self._active:
            for sev, thr in self.thresholds:
                if thr <= fired_thr:
                    self._active.add(sev)
            self.alerts_total += 1
            self._c.inc(slo=self.metric, severity=fired)
            if self.tracer.enabled:
                self.tracer.record_span(
                    "slo.alert", duration_s=0.0, severity=fired,
                    slo=self.metric, budget_s=self.budget_s,
                    burn_fast=round(fast, 3), burn_slow=round(slow, 3))

    # -- views -------------------------------------------------------------
    def alerting(self) -> List[str]:
        return sorted(self._active)

    def status(self) -> Dict[str, object]:
        """One JSON-able dict for /healthz and report()."""
        return {
            "slo": self.metric,
            "budget_s": self.budget_s,
            "objective": self.objective,
            "burn_fast": round(self.burn["fast"], 4),
            "burn_slow": round(self.burn["slow"], 4),
            "alerting": self.alerting(),
            "alerts_total": self.alerts_total,
        }
