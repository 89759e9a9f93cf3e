"""Host-side utilities of the port."""

from devias_tpu_torch.utils.logging import MetricLogger, SmoothedValue, TensorLogger

__all__ = ["MetricLogger", "SmoothedValue", "TensorLogger"]
