"""Steps, optimizer and train state of the port."""

from devias_tpu_torch.train.optim import FusedAdamW, OptimConfig, make_optimizer
from devias_tpu_torch.train.state import TrainState
from devias_tpu_torch.train.step import TrainStepConfig, make_eval_step, make_slot_train_step

__all__ = ["FusedAdamW", "OptimConfig", "TrainState", "TrainStepConfig", "make_eval_step", "make_optimizer",
           "make_slot_train_step"]
