"""Training losses of the port."""

from devias_tpu_torch.losses.matching import match_action_scene_slots
from devias_tpu_torch.losses.slot_loss import (
    SlotLossConfig,
    bce_with_logits,
    cosine_orthogonality_loss,
    cross_entropy,
    devias_slot_loss,
    hvu_slot_loss,
    kl_div_log_target,
    label_smoothing_cross_entropy,
    multi_task_loss,
    pad_teacher_logits,
    soft_target_cross_entropy,
)

__all__ = [
    "SlotLossConfig", "bce_with_logits", "cosine_orthogonality_loss", "cross_entropy", "devias_slot_loss",
    "hvu_slot_loss", "kl_div_log_target", "label_smoothing_cross_entropy", "match_action_scene_slots",
    "multi_task_loss", "pad_teacher_logits", "soft_target_cross_entropy",
]
