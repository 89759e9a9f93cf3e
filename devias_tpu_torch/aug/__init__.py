"""Augmentations of the port."""

from devias_tpu_torch.aug.fame import FAMEConfig, compute_fame_masks, fame_augment, fame_augment_hvu
from devias_tpu_torch.aug.mixup import MixupConfig, mixup_cutmix, mixup_draws
from devias_tpu_torch.aug.segformer_mix import segformer_frame_masks, segformer_mix_sample

__all__ = ["FAMEConfig", "MixupConfig", "compute_fame_masks", "fame_augment", "fame_augment_hvu", "mixup_cutmix",
           "mixup_draws", "segformer_frame_masks", "segformer_mix_sample"]
