"""Hot-path step telemetry (``paddle_tpu/observability/telemetry.py``):
the glue between a training loop and the registry, the JSONL run log and
the recompile detector.

:class:`StepTelemetry` is what :meth:`Trainer.fit
<paddle_tpu_torch.trainer.Trainer.fit>` drives: one object owning the
per-step bookkeeping so the loop stays one call per step. Telemetry must
never take down a training run, so device-memory polling is guarded.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from paddle_tpu_torch.observability import aggregate as _agg
from paddle_tpu_torch.observability import recompile as _recompile
from paddle_tpu_torch.observability import registry as _registry
from paddle_tpu_torch.observability import runlog as _runlog

#: ``torch.cuda.memory_stats()`` keys -> the reference's stat names
_MEMORY_KEYS = {"allocated_bytes.all.current": "bytes_in_use",
                "allocated_bytes.all.peak": "peak_bytes_in_use",
                "reserved_bytes.all.current": "bytes_reserved"}


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory stats (``torch.cuda.memory_stats``) under the
    reference's names, plus ``bytes_limit`` (the card's total memory).
    Returns {} without a card: callers treat memory as optional."""
    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        keep = {name: float(stats[k]) for k, name in _MEMORY_KEYS.items()
                if k in stats}
        keep["bytes_limit"] = float(
            torch.cuda.get_device_properties(i).total_memory)
        out[f"gpu:{i}"] = keep
    return out


def record_memory_gauges(reg: Optional[_registry.MetricsRegistry] = None
                         ) -> Dict[str, Dict[str, float]]:
    """Poll device memory into ``device_memory_bytes`` gauges; returns
    the raw stats dict (for the JSONL record)."""
    reg = reg or _registry.default()
    stats = device_memory_stats()
    if stats:
        g = reg.gauge("device_memory_bytes", "per-card memory stats")
        for dev, kv in stats.items():
            for stat, v in kv.items():
                g.set(v, device=dev, stat=stat)
    return stats


class StepTelemetry:
    """Per-step metrics for one training run.

    Owns step-time/throughput histograms, counters and a gauge in
    ``registry``, an optional JSONL :class:`~paddle_tpu_torch.observability.
    runlog.RunLogWriter` and a :class:`~paddle_tpu_torch.observability.
    recompile.RecompileDetector` over the process's graph captures (a
    capture after the second step is a recompile).

    Loop protocol::

        tel = StepTelemetry("train", run_log=path)
        for ...:
            t0 = perf(); batch = next(it); tel.data_wait(perf() - t0)
            t1 = perf(); state, m = step(state, **batch)
            tel.step(gstep, feeds=batch, step_time_s=perf() - t1,
                     examples=bsz, epoch=e)
        tel.close()

    Step time is the host's time in the step call: on the card the launch
    (or graph replay) returns before the device finishes, so in steady
    state the device's backpressure makes per-step times honest, while the
    first steps can look fast; a rate over a run is taken from wall time
    ending in a synchronise. Every ``aggregate_every`` steps of a run of
    more than one process, every process all-gathers the step's headline
    numbers and process 0 logs the min/mean/max line
    (:mod:`~paddle_tpu_torch.observability.aggregate`); every process
    must step in lockstep then, as the ranks of a sharded step do.
    """

    def __init__(self, name: str = "train", *,
                 run_log: Optional[str] = None,
                 run_meta: Optional[Dict[str, Any]] = None,
                 registry: Optional[_registry.MetricsRegistry] = None,
                 log_fn: Callable[[str], None] = print,
                 memory_every: int = 50,
                 aggregate_every: int = 0,
                 detect_recompiles: bool = True):
        self.name = name
        self.reg = registry or _registry.default()
        self.log_fn = log_fn
        self.memory_every = memory_every
        self.aggregate_every = aggregate_every
        self.writer = None
        if run_log:
            self.writer = _runlog.RunLogWriter(
                run_log, meta=dict(run_meta or {}, name=name))
        # a train step's first call runs eagerly and its second captures
        # (paddle_tpu_torch.train.TrainStepGraphs): both are warm-up
        self.detector = (_recompile.RecompileDetector(
            f"{name}_step", warmup=2, registry=self.reg, log_fn=log_fn)
            if detect_recompiles else None)
        self._wait_s = 0.0
        self._steps = 0
        self._h_step = self.reg.histogram(
            f"{name}_step_seconds", "per-step wall time")
        self._h_wait = self.reg.histogram(
            f"{name}_data_wait_seconds", "host blocked on the input "
            "pipeline per step")
        self._c_steps = self.reg.counter(f"{name}_steps_total")
        self._c_examples = self.reg.counter(f"{name}_examples_total")
        self._c_tokens = self.reg.counter(f"{name}_tokens_total")
        self._g_eps = self.reg.gauge(f"{name}_examples_per_sec",
                                     "throughput of the latest step")

    # -- per-step protocol -------------------------------------------------
    def data_wait(self, seconds: float):
        """Host time spent blocked fetching the next batch."""
        self._wait_s = max(0.0, float(seconds))
        self._h_wait.observe(self._wait_s)

    def step(self, step: int, *, step_time_s: float, examples: int,
             feeds: Optional[Dict[str, Any]] = None,
             tokens: Optional[int] = None,
             metrics: Optional[Dict[str, float]] = None,
             epoch: Optional[int] = None) -> Dict[str, Any]:
        """Record one completed step; returns the JSONL record (also
        written to the run log when one is attached)."""
        step_time_s = max(float(step_time_s), 1e-9)
        self._steps += 1
        self._h_step.observe(step_time_s)
        self._c_steps.inc()
        self._c_examples.inc(examples)
        eps = examples / step_time_s
        self._g_eps.set(eps)
        if self.detector is not None:
            self.detector.check(step=step, feeds=feeds)
        # the data-wait vs compute split is (data_wait_s, step_time_s):
        # fetch blocking is outside the step timer
        rec: Dict[str, Any] = {
            "kind": "step", "step": int(step),
            "step_time_s": round(step_time_s, 6),
            "examples_per_sec": round(eps, 3),
            "data_wait_s": round(self._wait_s, 6),
        }
        if tokens:
            self._c_tokens.inc(tokens)
            rec["tokens_per_sec"] = round(tokens / step_time_s, 3)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        if self.detector is not None:
            rec["recompiles"] = self.detector.recompiles
            rec["compiles_cum"] = self.detector.compiles_cum
        if metrics:
            rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        if self.memory_every and self._steps % self.memory_every == 0:
            mem = record_memory_gauges(self.reg)
            if mem:
                rec["memory"] = mem
        self._wait_s = 0.0
        if self.writer is not None:
            self.writer.write(rec)
        if self.aggregate_every and self._steps % self.aggregate_every == 0:
            self.aggregate_line(rec)
        return rec

    # -- cross-process -----------------------------------------------------
    def aggregate_line(self, rec: Dict[str, Any]):
        """More than one process: all-gather the step's headline numbers
        and log the min/mean/max skew line from process 0. One process:
        nothing."""
        if _agg.process_count() == 1:
            return
        stats = _agg.aggregate({
            "step_time_s": rec["step_time_s"],
            "examples_per_sec": rec["examples_per_sec"],
            "data_wait_s": rec.get("data_wait_s", 0.0),
        })
        if _agg.process_index() == 0:
            self.log_fn(f"[observability] step {rec['step']} "
                        + _agg.format_aggregate(stats))

    def close(self, summary: Optional[Dict[str, Any]] = None):
        if self.writer is not None:
            rec = {"kind": "summary", "steps": self._steps}
            s = self._h_step.summary()
            rec["step_time_mean_s"] = round(s["mean"], 6)
            rec["step_time_max_s"] = round(s["max"], 6)
            if self.detector is not None:
                rec["recompiles"] = self.detector.recompiles
                rec["compiles_cum"] = self.detector.compiles_cum
            if summary:
                rec.update(summary)
            self.writer.write(rec)
            self.writer.close()
