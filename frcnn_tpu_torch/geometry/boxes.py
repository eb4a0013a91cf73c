"""Box algebra on ``[..., 4]`` tensors of ``(minx, miny, maxx, maxy)``.

Port of the JAX package's ``geometry/boxes.py`` (what the detect and
train paths use). Boxes are half-open ``[min, max)``; :func:`iou` is the
plain IoU of anchor matching, :func:`iou_plus_one` the NMS IoU with the
+1-pixel area convention; the regression encoding is the reference's
corner-offset parameterization (``Anchors.lua:237-252``).
"""

from __future__ import annotations

import torch


def width(b):
    return b[..., 2] - b[..., 0]


def height(b):
    return b[..., 3] - b[..., 1]


def area(b):
    """Signed area (``Rect:area``, ``Rect.lua:60-62``)."""
    return width(b) * height(b)


def from_xywh(x, y, w, h):
    return torch.stack([x, y, x + w, y + h], dim=-1)


def overlaps(a, b):
    """Strict open-interval overlap test (``Rect.lua:90-93``)."""
    return (
        (a[..., 0] < b[..., 2])
        & (a[..., 2] > b[..., 0])
        & (a[..., 1] < b[..., 3])
        & (a[..., 3] > b[..., 1])
    )


def intersect_area(a, b):
    """Area of intersection; 0 when disjoint (``Rect.lua:126-136``)."""
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0],
                                                             b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1],
                                                             b[..., 1])
    return torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)


def iou(a, b):
    """Plain IoU of anchor/ROI matching (``Rect.IoU``, ``Rect.lua:138-141``).
    Broadcasts; 0 for two empty boxes."""
    i = intersect_area(a, b)
    u = area(a) + area(b) - i
    return torch.where(u > 0, i / torch.where(u > 0, u, torch.ones_like(u)),
                       torch.zeros_like(u))


def iou_matrix(a, b):
    """Pairwise IoU of ``a [..., N, 4]`` x ``b [..., M, 4]`` ->
    ``[..., N, M]`` (leading axes broadcast)."""
    return iou(a[..., :, None, :], b[..., None, :, :])


def iou_plus_one(a, b):
    """NMS IoU with widths/heights ``max - min + 1`` (``nms.lua:35, 85-86``)."""
    aw = a[..., 2] - a[..., 0] + 1.0
    ah = a[..., 3] - a[..., 1] + 1.0
    bw = b[..., 2] - b[..., 0] + 1.0
    bh = b[..., 3] - b[..., 1] + 1.0
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]) + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]) + 1.0, min=0.0)
    inter = iw * ih
    union = aw * ah + bw * bh - inter
    return inter / torch.where(union > 0, union, torch.ones_like(union))


def encode(anchor, target):
    """``Anchors.inputToAnchor`` (``Anchors.lua:237-243``): the target's min
    corner relative to the anchor's, over the anchor size, and the log size
    ratios -> ``[..., 4] = (tx, ty, tw, th)``."""
    aw = width(anchor)
    ah = height(anchor)
    tx = (target[..., 0] - anchor[..., 0]) / aw
    ty = (target[..., 1] - anchor[..., 1]) / ah
    tw = torch.log(width(target) / aw)
    th = torch.log(height(target) / ah)
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode(anchor, t):
    """``Anchors.anchorToInput`` (``Anchors.lua:245-252``): corner offsets
    scaled by the anchor size plus log size ratios -> box."""
    aw = width(anchor)
    ah = height(anchor)
    x = t[..., 0] * aw + anchor[..., 0]
    y = t[..., 1] * ah + anchor[..., 1]
    w = torch.exp(t[..., 2]) * aw
    h = torch.exp(t[..., 3]) * ah
    return from_xywh(x, y, w, h)
