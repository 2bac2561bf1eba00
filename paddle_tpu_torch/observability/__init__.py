"""Runtime telemetry (``paddle_tpu/observability``): metrics, traces,
exposition, SLO burn rates, step anatomy, the flight recorder, the JSONL
run log, step telemetry and the one-block run summary (:func:`report`),
all host-side Python over one metrics registry."""

from paddle_tpu_torch.observability import (aggregate, anatomy, exposition,
                                            flight, runlog, slo, telemetry,
                                            tracing)
from paddle_tpu_torch.observability.anatomy import (StepAnatomy,
                                                    validate_anatomy_record,
                                                    validate_anatomy_records)
from paddle_tpu_torch.observability.exposition import ExpositionServer
from paddle_tpu_torch.observability.flight import (POSTMORTEM_SCHEMA,
                                                   FlightRecorder,
                                                   validate_postmortem_bundle)
from paddle_tpu_torch.observability.recompile import (RecompileDetector,
                                                      capture_count)
from paddle_tpu_torch.observability.registry import (Counter, Gauge,
                                                     Histogram,
                                                     MetricsRegistry,
                                                     default)
from paddle_tpu_torch.observability.runlog import (RunLogWriter,
                                                   read_run_log,
                                                   validate_record,
                                                   validate_run_log)
from paddle_tpu_torch.observability.report import (SPAN_METRIC,
                                                   observe_span, report)
from paddle_tpu_torch.observability.slo import BurnRateMonitor
from paddle_tpu_torch.observability.telemetry import StepTelemetry
from paddle_tpu_torch.observability.tracing import (Span, Tracer,
                                                    chrome_trace_valid)

__all__ = ["BurnRateMonitor", "Counter", "ExpositionServer",
           "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
           "POSTMORTEM_SCHEMA", "RecompileDetector", "RunLogWriter",
           "SPAN_METRIC", "Span",
           "StepAnatomy", "StepTelemetry", "Tracer", "aggregate", "anatomy",
           "capture_count", "chrome_trace_valid", "default", "exposition",
           "flight", "observe_span", "read_run_log", "report", "runlog",
           "slo", "telemetry",
           "tracing", "validate_anatomy_record", "validate_anatomy_records",
           "validate_postmortem_bundle", "validate_record",
           "validate_run_log"]
