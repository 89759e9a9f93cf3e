"""Schedules, the process layouts of data-, sequence-, tensor- and
pipeline-parallel training, and the placement of a train state over them."""

from devias_tpu_torch.core.dist import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    SPMesh,
    make_mesh,
    make_sp_mesh,
    maybe_init_distributed,
    seq_parallel_tokens,
    shard_train_state,
)
from devias_tpu_torch.core.pipeline import make_pp_mesh, pipeline_tokens
from devias_tpu_torch.core.schedules import cosine_schedule, cosine_wd_schedule

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SEQ_AXIS", "SPMesh", "cosine_schedule", "cosine_wd_schedule",
           "make_mesh", "make_pp_mesh", "make_sp_mesh", "maybe_init_distributed", "pipeline_tokens",
           "seq_parallel_tokens", "shard_train_state"]
