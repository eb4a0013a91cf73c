"""Greedy non-maximum suppression: the plain PyTorch version.

Port of the JAX package's ``ops/nms.py`` and of the function its Pallas
kernel computes (``ops/pallas_nms.py::pallas_nms_keep_mask``):

* IoU uses the legacy +1 pixel area convention;
* boxes are processed by descending score, ties to the larger original
  index, invalid entries last;
* a box is suppressed unless its IoU with a kept box is <= the threshold
  (equal IoU survives);
* at most ``max_out`` picks per image.

:func:`nms_keep_mask` is the plain version of the CUDA kernel in
``ops/nms_kernel.py``: the same IoU, in the same operation order, so the
two agree bit for bit.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.geometry.matching import compact_mask


def sort_desc_with_ref_ties(scores: torch.Tensor, valid: torch.Tensor):
    """Per row: descending score, ties to the larger original index,
    invalid entries last. Returns the permutation [..., N] (int64)."""
    n = scores.shape[-1]
    s = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    # a stable descending sort keeps ties in input order; sorting the
    # reversed row therefore puts the larger original index first
    _, rev = torch.sort(s.flip(-1), dim=-1, descending=True, stable=True)
    return (n - 1) - rev


def nms_keep_mask(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                  iou_threshold: float, max_out: int) -> torch.Tensor:
    """Greedy NMS over boxes already in processing order.

    boxes_sorted: [B, N, 4] float32; valid_sorted: [B, N] bool.
    Returns the keep mask [B, N] bool over the sorted order.
    """
    x0, y0, x1, y1 = boxes_sorted.float().unbind(-1)
    area = (x1 - x0 + 1.0) * (y1 - y0 + 1.0)
    # iou[b, i, j]: box j against a kept box i, in the kernel's order
    iw = torch.clamp(
        torch.minimum(x1[:, None, :], x1[:, :, None])
        - torch.maximum(x0[:, None, :], x0[:, :, None]) + 1.0, min=0.0)
    ih = torch.clamp(
        torch.minimum(y1[:, None, :], y1[:, :, None])
        - torch.maximum(y0[:, None, :], y0[:, :, None]) + 1.0, min=0.0)
    inter = iw * ih
    iou = inter / (area[:, None, :] + area[:, :, None] - inter)
    survives = iou <= iou_threshold

    alive = valid_sorted.clone()
    keep = torch.zeros_like(alive)
    count = torch.zeros(alive.shape[0], dtype=torch.int32,
                        device=alive.device)
    for i in range(alive.shape[1]):
        pick = alive[:, i]
        keep[:, i] = pick
        count = count + pick.to(torch.int32)
        alive = alive & (survives[:, i, :] | ~pick[:, None])
        alive = alive & (count < max_out)[:, None]
    return keep


def sorted_nms(boxes, scores, valid, iou_threshold: float, max_out: int,
               keep_mask_fn):
    """Sort, greedy keep mask (``keep_mask_fn``), compaction.

    boxes [B, N, 4], scores [B, N], valid [B, N] bool. Returns (indices
    [B, max_out] int32 into the original order, -1 padded; keep_valid
    [B, max_out] bool), picks in descending score order.
    """
    perm = sort_desc_with_ref_ties(scores, valid)
    boxes_sorted = torch.gather(boxes, 1, perm[:, :, None].expand(-1, -1, 4))
    valid_sorted = torch.gather(valid, 1, perm)
    keep = keep_mask_fn(boxes_sorted.contiguous(), valid_sorted.contiguous(),
                        iou_threshold, max_out)
    slots, slot_valid, _ = compact_mask(keep, max_out)
    src = torch.gather(perm, 1, slots.clamp(min=0).long())
    indices = torch.where(slot_valid, src, torch.full_like(src, -1))
    return indices.to(torch.int32), slot_valid


def nms(boxes, scores, valid, iou_threshold: float, max_out: int):
    """Batched NMS through the plain keep mask (see :func:`sorted_nms`)."""
    return sorted_nms(boxes, scores, valid, iou_threshold, max_out,
                      nms_keep_mask)


def class_offset_boxes(boxes, classes, valid):
    """The per-class NMS coordinate-offset trick: translate each class's
    boxes into a disjoint region so one joint NMS equals per-class runs.
    The span is global over every valid box of the batch."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    span = (
        torch.max(torch.where(valid, boxes.amax(dim=-1), zero))
        - torch.min(torch.where(valid, boxes.amin(dim=-1), zero))
        + 2.0
    )
    return boxes + (classes.to(boxes.dtype) * span)[..., None]
