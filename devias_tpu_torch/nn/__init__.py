"""Models of the port: the video ViT, the slot aggregation block, heads."""

from devias_tpu_torch.nn.agg import AggregationBlock
from devias_tpu_torch.nn.heads import MaskPredictor, MLPHead
from devias_tpu_torch.nn.models import PlainViT, SlotViT, create_model, select_slots_by_head
from devias_tpu_torch.nn.vit import VideoViT, sinusoid_position_table

__all__ = [
    "AggregationBlock", "MaskPredictor", "MLPHead", "PlainViT", "SlotViT", "VideoViT",
    "create_model", "select_slots_by_head", "sinusoid_position_table",
]
