"""Steps, optimizer and train state of the port."""

from devias_tpu_torch.train.optim import FusedAdamW, FusedSGD, OptimConfig, ScheduledOptimizer, make_optimizer
from devias_tpu_torch.train.state import TrainState
from devias_tpu_torch.train.step import (
    TrainStepConfig,
    make_classification_train_step,
    make_eval_step,
    make_hvu_train_step,
    make_multi_task_train_step,
    make_slot_train_step,
)

__all__ = ["FusedAdamW", "FusedSGD", "OptimConfig", "ScheduledOptimizer", "TrainState", "TrainStepConfig",
           "make_classification_train_step", "make_eval_step", "make_hvu_train_step", "make_multi_task_train_step",
           "make_optimizer", "make_slot_train_step"]
