"""Greedy non-maximum suppression: the plain PyTorch version.

Port of the JAX package's ``ops/nms.py`` and of the function its Pallas
kernel computes (``ops/pallas_nms.py::pallas_nms_keep_mask``):

* IoU uses the legacy +1 pixel area convention;
* boxes are processed by descending score, ties to the larger original
  index, invalid entries last;
* a box is suppressed unless its IoU with a kept box is <= the threshold
  (equal IoU survives);
* at most ``max_out`` picks per image;
* a pick's coordinates are read as the Pallas kernel reads them
  (:func:`picked_coords`): a non-finite coordinate anywhere in an image
  makes that coordinate of every other pick NaN, so such a pick
  suppresses every later box.

:func:`nms_keep_slots` is the plain version of the CUDA kernel in
``ops/nms_kernel.py``: the same IoU, in the same operation order, so the
two agree bit for bit, and the same compaction of the keep mask.

The public entries :func:`nms`, :func:`per_class_nms` and
:func:`nms_indices_sorted` take the JAX package's arguments, unbatched or
with a leading batch axis. They run the plain keep mask on CPU tensors and
the CUDA kernel on CUDA tensors (``nms_kernel.nms_keep_slots``: up to
``nms_kernel.MAX_DIRECT``, 1842816 boxes per image, and ``ValueError``
past that). :func:`plain_nms` is the batched plain path on any device, for the
detector's reference path.
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


def picked_coords(c: torch.Tensor) -> torch.Tensor:
    """A coordinate plane [B, N] as the Pallas kernel reads it for a pick.

    The kernel extracts a pick's coordinates as a one-hot sum over the
    image's row, and 0 * inf and 0 * NaN are NaN: a non-finite value of
    any other box of the row, valid or not, makes that coordinate NaN."""
    bad = ~torch.isfinite(c)
    others = bad.sum(dim=-1, keepdim=True) - bad.to(torch.int64) > 0
    return torch.where(others, torch.full_like(c, float("nan")), c)


def nms_keep_mask(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                  iou_threshold: float, max_out: int) -> torch.Tensor:
    """Greedy NMS over boxes already in processing order.

    boxes_sorted: [B, N, 4] float32; valid_sorted: [B, N] bool.
    Returns the keep mask [B, N] bool over the sorted order.

    As the Pallas kernel walks: each trip picks every image's first alive
    box and suppresses with one IoU row against it, so memory is O(B * N)
    for any N; trips stop once no image has an alive box.
    """
    x0, y0, x1, y1 = boxes_sorted.float().unbind(-1)
    p0, q0, p1, q1 = (picked_coords(c) for c in (x0, y0, x1, y1))
    area = (x1 - x0 + 1.0) * (y1 - y0 + 1.0)
    alive = valid_sorted.clone()
    keep = torch.zeros_like(alive)
    count = torch.zeros(alive.shape[0], dtype=torch.int32,
                        device=alive.device)
    rows = torch.arange(alive.shape[0], device=alive.device)
    for trip in range(min(alive.shape[1], max_out)):
        if trip % 16 == 0 and not bool(alive.any()):
            break
        pick = alive.any(dim=1)
        i = alive.to(torch.uint8).argmax(dim=1)      # the first alive box
        keep[rows, i] |= pick
        alive[rows, i] = False
        count = count + pick.to(torch.int32)
        px0, py0, px1, py1 = (c[rows, i][:, None] for c in (p0, q0, p1, q1))
        parea = (px1 - px0 + 1.0) * (py1 - py0 + 1.0)
        # the pick's row, the later box first, in the kernel's order
        iw = torch.clamp(torch.minimum(x1, px1) - torch.maximum(x0, px0)
                         + 1.0, min=0.0)
        ih = torch.clamp(torch.minimum(y1, py1) - torch.maximum(y0, py0)
                         + 1.0, min=0.0)
        inter = iw * ih
        survives = inter / (area + parea - inter) <= iou_threshold
        alive = alive & (survives | ~pick[:, None])
        alive = alive & (count < max_out)[:, None]
    return keep


def nms_keep_slots(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                   iou_threshold: float, max_out: int):
    """:func:`nms_keep_mask` and its compaction: (keep [B, N] bool, slots
    [B, max_out] int32, the sorted positions of the picks in pick order,
    -1 padded)."""
    keep = nms_keep_mask(boxes_sorted, valid_sorted, iou_threshold, max_out)
    return keep, compact_mask(keep, max_out)[0]


def sorted_nms(boxes, scores, valid, iou_threshold: float, max_out: int,
               keep_slots_fn):
    """Sort, greedy keep mask and its slots (``keep_slots_fn``, as
    :func:`nms_keep_slots`), indices into the original order.

    boxes [B, N, 4], scores [B, N], valid [B, N] bool. Returns (indices
    [B, max_out] int32 into the original order, -1 padded; keep_valid
    [B, max_out] bool), picks in descending score order.
    """
    perm = sort_desc_with_ref_ties(scores, valid)
    boxes_sorted = torch.gather(boxes, 1, perm[:, :, None].expand(-1, -1, 4))
    valid_sorted = torch.gather(valid, 1, perm)
    _, slots = keep_slots_fn(boxes_sorted.contiguous(),
                             valid_sorted.contiguous(), iou_threshold,
                             max_out)
    slot_valid = slots >= 0
    src = torch.gather(perm, 1, slots.clamp(min=0).long())
    indices = torch.where(slot_valid, src, torch.full_like(src, -1))
    return indices.to(torch.int32), slot_valid


def plain_nms(boxes, scores, valid, iou_threshold: float, max_out: int):
    """Batched NMS through the plain keep mask on any device (see
    :func:`sorted_nms`)."""
    return sorted_nms(boxes, scores, valid, iou_threshold, max_out,
                      nms_keep_slots)


def resolve_nms_scores(boxes, scores=None):
    """The reference's score argument (``nms.lua:37-43``): ``None`` orders
    by ``max_y``, the string ``'area'`` by the +1-pixel box area, an
    ``int`` selects a box column (0-based), and anything else is the score
    tensor itself."""
    if scores is None:
        return boxes[..., 3]
    if isinstance(scores, str):
        if scores != "area":
            raise ValueError(f"unknown nms scores string: {scores!r}")
        return ((boxes[..., 2] - boxes[..., 0] + 1.0)
                * (boxes[..., 3] - boxes[..., 1] + 1.0))
    if isinstance(scores, int):
        return boxes[..., scores]
    return scores


def nms_indices_sorted(boxes_sorted, valid_sorted, iou_threshold: float,
                       max_out: int):
    """Greedy NMS over boxes already in processing order, [N, 4] / [N] or
    [B, N, 4] / [B, N]. Returns (keep_slots [..., max_out] int32, the
    sorted positions of the picks, -1 padded; keep_valid [..., max_out]
    bool)."""
    from frcnn_tpu_torch.ops import nms_kernel

    one = valid_sorted.dim() == 1
    if one:
        boxes_sorted, valid_sorted = boxes_sorted[None], valid_sorted[None]
    _, slots = nms_kernel.nms_keep_slots(
        boxes_sorted.float().contiguous(), valid_sorted.bool().contiguous(),
        iou_threshold, max_out)
    slots = slots[0] if one else slots
    return slots, slots >= 0


def nms(boxes, scores, valid, iou_threshold: float, max_out: int):
    """Sort (the reference's tie order) and greedy suppression.

    boxes [N, 4] or [B, N, 4]; scores of the same leading shape, or
    ``None`` / ``'area'`` / an int column (:func:`resolve_nms_scores`);
    valid bool of the same leading shape. Returns (indices [..., max_out]
    int32 into the original order, -1 padded; keep_valid [..., max_out]
    bool), picks in descending score order."""
    from frcnn_tpu_torch.ops import nms_kernel

    scores = resolve_nms_scores(boxes, scores)
    one = valid.dim() == 1
    if one:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    indices, keep_valid = nms_kernel.cuda_nms(boxes, scores, valid.bool(),
                                              iou_threshold, max_out)
    return (indices[0], keep_valid[0]) if one else (indices, keep_valid)


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


def per_class_nms(boxes, scores, classes, valid, num_classes: int,
                  iou_threshold: float, max_out: int):
    """Per-class NMS in one :func:`nms` through the coordinate-offset trick
    (``Detector.lua:124-136``); ``num_classes`` is not needed by it."""
    shifted = class_offset_boxes(boxes, classes, valid)
    return nms(shifted, scores, valid, iou_threshold, max_out)
