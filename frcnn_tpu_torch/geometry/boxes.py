"""Box algebra on ``[..., 4]`` tensors of ``(minx, miny, maxx, maxy)``.

Port of the JAX package's ``geometry/boxes.py``, the reference's ``Rect``
class (``Rect.lua``) as elementwise tensor functions on any device. Boxes
are half-open ``[min, max)``: the pixel-tight box of pixel (x, y) is
``(x, y, x+1, y+1)``. :func:`iou` is the plain IoU of anchor matching,
:func:`iou_plus_one` the NMS IoU with the +1-pixel area convention; the
regression encoding is the reference's corner-offset parameterization
(``Anchors.lua:237-252``).
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


def center(b):
    """Center (cx, cy), stacked on the last axis (``Rect.lua:64-66``)."""
    return torch.stack([(b[..., 0] + b[..., 2]) * 0.5,
                        (b[..., 1] + b[..., 3]) * 0.5], dim=-1)


def from_xywh(x, y, w, h):
    return torch.stack([x, y, x + w, y + h], dim=-1)


def from_center_wh(cx, cy, w, h):
    """``Rect.fromCenterWidthHeight`` (``Rect.lua:34-36``)."""
    return from_xywh(cx - w * 0.5, cy - h * 0.5, w, h)


def _edges(b, *values):
    """``values`` (numbers or tensors, one per edge) stacked on a last axis
    of 4, in the type that ``b`` and the values promote to."""
    vs = [torch.as_tensor(v, device=b.device) for v in values]
    dtype = b.dtype
    for v in vs:
        dtype = torch.promote_types(dtype, v.dtype)
    return torch.stack(torch.broadcast_tensors(*(v.to(dtype) for v in vs)),
                       dim=-1)


def scale(b, sx, sy=None):
    sy = sx if sy is None else sy
    return b * _edges(b, sx, sy, sx, sy)


def offset(b, dx, dy):
    return b + _edges(b, dx, dy, dx, dy)


def inflate(b, ix, iy):
    return b + _edges(b, -ix, -iy, ix, iy)


def clip(b, clip_box):
    """Clamp all four edges into ``clip_box`` (``Rect:clip``,
    ``Rect.lua:73-80``): a box fully outside collapses onto the nearest
    clip edge."""
    c = torch.as_tensor(clip_box, dtype=b.dtype, device=b.device)
    cminx, cminy, cmaxx, cmaxy = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    return torch.stack([
        torch.minimum(torch.maximum(b[..., 0], cminx), cmaxx),
        torch.minimum(torch.maximum(b[..., 1], cminy), cmaxy),
        torch.maximum(torch.minimum(b[..., 2], cmaxx), cminx),
        torch.maximum(torch.minimum(b[..., 3], cmaxy), cminy),
    ], dim=-1)


def hflip(b, image_w):
    """Mirror inside an image of width ``image_w``
    (``BatchIterator.lua:58-62``)."""
    return torch.stack([image_w - b[..., 2], b[..., 1], image_w - b[..., 0],
                        b[..., 3]], dim=-1)


def vflip(b, image_h):
    return torch.stack([b[..., 0], image_h - b[..., 3], b[..., 2],
                        image_h - b[..., 1]], dim=-1)


def snap_to_int(b):
    """Floor the min corner, ceil the max corner (``Rect.lua:147-149``)."""
    return torch.stack([torch.floor(b[..., 0]), torch.floor(b[..., 1]),
                        torch.ceil(b[..., 2]), torch.ceil(b[..., 3])], dim=-1)


def is_empty(b):
    """``Rect:isEmpty`` (``Rect.lua:69-71``): both extents collapsed."""
    return (b[..., 0] == b[..., 2]) & (b[..., 1] == b[..., 3])


def overlaps(a, b):
    """Strict open-interval overlap test (``Rect.lua:90-93``)."""
    return (
        (a[..., 0] < b[..., 2])
        & (a[..., 2] > b[..., 0])
        & (a[..., 1] < b[..., 3])
        & (a[..., 3] > b[..., 1])
    )


def contains(outer, inner):
    """All four corners of ``inner`` inside half-open ``outer``
    (``Rect:contains`` on ``containsPt``, ``Rect.lua:82-88``)."""
    return (
        (outer[..., 0] <= inner[..., 0]) & (inner[..., 0] < outer[..., 2])
        & (outer[..., 1] <= inner[..., 1]) & (inner[..., 1] < outer[..., 3])
        & (outer[..., 0] <= inner[..., 2]) & (inner[..., 2] < outer[..., 2])
        & (outer[..., 1] <= inner[..., 3]) & (inner[..., 3] < outer[..., 3])
    )


def inside(outer, inner):
    """Closed containment of anchor validity: every vertex of ``inner`` in
    ``outer``, max edges included (``Anchors.lua:105-110``)."""
    return (
        (inner[..., 0] >= outer[..., 0]) & (inner[..., 1] >= outer[..., 1])
        & (inner[..., 2] <= outer[..., 2]) & (inner[..., 3] <= outer[..., 3])
    )


def union(a, b):
    """Bounding box of two boxes (``Rect.union``, ``Rect.lua:118-124``)."""
    return torch.stack([
        torch.minimum(a[..., 0], b[..., 0]),
        torch.minimum(a[..., 1], b[..., 1]),
        torch.maximum(a[..., 2], b[..., 2]),
        torch.maximum(a[..., 3], b[..., 3]),
    ], dim=-1)


def intersect(a, b):
    """Intersection box; the all-zero box when disjoint
    (``Rect.intersect``, ``Rect.lua:126-136``)."""
    minx = torch.maximum(a[..., 0], b[..., 0])
    miny = torch.maximum(a[..., 1], b[..., 1])
    maxx = torch.minimum(a[..., 2], b[..., 2])
    maxy = torch.minimum(a[..., 3], b[..., 3])
    ok = (maxx >= minx) & (maxy >= miny)
    out = torch.stack([minx, miny, maxx, maxy], dim=-1)
    return torch.where(ok[..., None], out, torch.zeros_like(out))


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
