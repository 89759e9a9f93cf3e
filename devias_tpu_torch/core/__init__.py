"""Schedules of the port."""

from devias_tpu_torch.core.schedules import cosine_schedule, cosine_wd_schedule

__all__ = ["cosine_schedule", "cosine_wd_schedule"]
