"""Training losses of the port."""

from devias_tpu_torch.losses.matching import match_action_scene_slots
from devias_tpu_torch.losses.slot_loss import (
    SlotLossConfig,
    bce_with_logits,
    cosine_orthogonality_loss,
    cross_entropy,
    devias_slot_loss,
    kl_div_log_target,
    pad_teacher_logits,
)

__all__ = [
    "SlotLossConfig", "bce_with_logits", "cosine_orthogonality_loss", "cross_entropy", "devias_slot_loss",
    "kl_div_log_target", "match_action_scene_slots", "pad_teacher_logits",
]
