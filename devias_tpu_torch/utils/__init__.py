"""Host-side utilities of the port: logging and profiling."""

from devias_tpu_torch.utils.logging import MetricLogger, SmoothedValue, TensorLogger
from devias_tpu_torch.utils.profiling import StepTimer, profile_trace

__all__ = ["MetricLogger", "SmoothedValue", "StepTimer", "TensorLogger", "profile_trace"]
