"""Box algebra, receptive-field mapping, anchors and mask compaction."""

from frcnn_tpu_torch.geometry import boxes
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
from frcnn_tpu_torch.geometry.localizer import (
    LayerInfo,
    Localizer,
    layer_infos_for_tap,
)

__all__ = ["boxes", "LayerInfo", "Localizer", "layer_infos_for_tap",
           "AnchorGenerator"]
