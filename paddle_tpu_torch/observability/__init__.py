"""Runtime telemetry (``paddle_tpu/observability``): metrics, traces,
exposition, SLO burn rates, step anatomy and the flight recorder, all
host-side Python over one metrics registry."""

from paddle_tpu_torch.observability import (anatomy, exposition, flight,
                                            slo, tracing)
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
from paddle_tpu_torch.observability.slo import BurnRateMonitor
from paddle_tpu_torch.observability.tracing import (Span, Tracer,
                                                    chrome_trace_valid)

__all__ = ["BurnRateMonitor", "Counter", "ExpositionServer",
           "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
           "POSTMORTEM_SCHEMA", "RecompileDetector", "Span", "StepAnatomy",
           "Tracer", "anatomy", "capture_count", "chrome_trace_valid",
           "default", "exposition", "flight", "slo", "tracing",
           "validate_anatomy_record", "validate_anatomy_records",
           "validate_postmortem_bundle"]
