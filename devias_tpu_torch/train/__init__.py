"""Steps of the port."""

from devias_tpu_torch.train.step import make_eval_step

__all__ = ["make_eval_step"]
