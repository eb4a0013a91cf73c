"""Normalization, NMS, ROI pooling and the fused first block, each kernel beside its plain PyTorch version."""

from frcnn_tpu_torch.ops.nms import nms, nms_indices_sorted, per_class_nms
from frcnn_tpu_torch.ops.roi_pool import adaptive_max_pool, prepare_roi_rects

__all__ = [
    "nms",
    "nms_indices_sorted",
    "per_class_nms",
    "adaptive_max_pool",
    "prepare_roi_rects",
]
