"""Schedules and the process groups of sequence-parallel training."""

from devias_tpu_torch.core.dist import (
    DATA_AXIS,
    SEQ_AXIS,
    SPMesh,
    make_sp_mesh,
    maybe_init_distributed,
    seq_parallel_tokens,
)
from devias_tpu_torch.core.schedules import cosine_schedule, cosine_wd_schedule

__all__ = ["DATA_AXIS", "SEQ_AXIS", "SPMesh", "cosine_schedule", "cosine_wd_schedule", "make_sp_mesh",
           "maybe_init_distributed", "seq_parallel_tokens"]
