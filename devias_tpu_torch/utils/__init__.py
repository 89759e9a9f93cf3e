"""Host-side utilities of the port: logging, profiling and the program's
spans and counters."""

from devias_tpu_torch.utils.logging import MetricLogger, SmoothedValue, TensorLogger
from devias_tpu_torch.utils.profiling import (count, counter_totals, device_span, device_span_ms, profile_trace, span,
                                              span_totals)

__all__ = ["MetricLogger", "SmoothedValue", "TensorLogger", "count", "counter_totals", "device_span",
           "device_span_ms", "profile_trace", "span", "span_totals"]
