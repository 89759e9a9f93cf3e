"""Augmentations of the port."""

from devias_tpu_torch.aug.fame import FAMEConfig, compute_fame_masks, fame_augment, fame_augment_hvu
from devias_tpu_torch.aug.mixup import MixupConfig, mixup_cutmix, mixup_draws

__all__ = ["FAMEConfig", "MixupConfig", "compute_fame_masks", "fame_augment", "fame_augment_hvu", "mixup_cutmix",
           "mixup_draws"]
