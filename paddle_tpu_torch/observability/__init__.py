from paddle_tpu_torch.observability.registry import (Counter, Gauge,
                                                     Histogram,
                                                     MetricsRegistry,
                                                     default)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "default"]
