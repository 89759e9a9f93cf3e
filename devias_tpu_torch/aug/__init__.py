"""Augmentations of the port."""

from devias_tpu_torch.aug.fame import FAMEConfig, compute_fame_masks, fame_augment

__all__ = ["FAMEConfig", "compute_fame_masks", "fame_augment"]
