"""Runtime telemetry (``paddle_tpu/observability``): metrics, traces,
exposition, SLO burn rates, step anatomy, the flight recorder, the JSONL
run log, step telemetry and the one-block run summary (:func:`report`),
all host-side Python over one metrics registry. The file tier writes and
reads what they record: span JSONL (``Tracer.export_jsonl``,
``validate_trace_log``, ``chrome_trace_from_jsonl``), anatomy JSONL
(``StepAnatomy.export_jsonl``, ``validate_anatomy_log``) and postmortem
bundles (``write_bundle``, ``read_bundle``, ``validate_postmortem_file``),
checked by ``python -m paddle_tpu_torch.tools.check_metrics_log`` and
rendered by ``python -m paddle_tpu_torch.tools.postmortem``."""

from paddle_tpu_torch.observability import (aggregate, anatomy, exposition,
                                            flight, runlog, slo, telemetry,
                                            tracing)
from paddle_tpu_torch.observability.anatomy import (StepAnatomy,
                                                    validate_anatomy_log,
                                                    validate_anatomy_record,
                                                    validate_anatomy_records)
from paddle_tpu_torch.observability.exposition import ExpositionServer
from paddle_tpu_torch.observability.flight import (POSTMORTEM_SCHEMA,
                                                   FlightRecorder,
                                                   read_bundle,
                                                   validate_postmortem_bundle,
                                                   validate_postmortem_file,
                                                   write_bundle)
from paddle_tpu_torch.observability.recompile import (RecompileDetector,
                                                      capture_count)
from paddle_tpu_torch.observability.registry import (Counter, Gauge,
                                                     Histogram,
                                                     MetricsRegistry,
                                                     counter, default,
                                                     gauge, histogram)
from paddle_tpu_torch.observability.runlog import (RunLogWriter,
                                                   read_run_log,
                                                   validate_record,
                                                   validate_run_log)
from paddle_tpu_torch.observability.report import (SPAN_METRIC,
                                                   observe_span, report)
from paddle_tpu_torch.observability.slo import BurnRateMonitor
from paddle_tpu_torch.observability.telemetry import StepTelemetry
from paddle_tpu_torch.observability.tracing import (Span, Tracer,
                                                    chrome_trace_from_jsonl,
                                                    chrome_trace_valid,
                                                    validate_trace_log,
                                                    validate_trace_record)



def render_prometheus(reg: MetricsRegistry = None) -> str:
    """Prometheus text-format exposition of ``reg`` (default registry)."""
    return (reg or default()).render_prometheus()


def snapshot(reg: MetricsRegistry = None) -> dict:
    """Flat scalar snapshot of ``reg`` (default registry)."""
    return (reg or default()).snapshot()


__all__ = ["BurnRateMonitor", "Counter", "ExpositionServer",
           "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
           "POSTMORTEM_SCHEMA", "RecompileDetector", "RunLogWriter",
           "SPAN_METRIC", "Span",
           "StepAnatomy", "StepTelemetry", "Tracer", "aggregate", "anatomy",
           "capture_count", "chrome_trace_from_jsonl", "chrome_trace_valid",
           "counter", "default", "exposition", "flight", "gauge",
           "histogram", "observe_span", "read_bundle", "read_run_log",
           "render_prometheus", "report", "runlog", "slo", "snapshot",
           "telemetry", "tracing", "validate_anatomy_log",
           "validate_anatomy_record", "validate_anatomy_records",
           "validate_postmortem_bundle", "validate_postmortem_file",
           "validate_record", "validate_run_log", "validate_trace_log",
           "validate_trace_record", "write_bundle"]
