"""Anchor/ground-truth matching and example sampling, batched over images.

Port of the JAX package's ``geometry/matching.py``:

* :func:`compact_mask` — first-K indices of a boolean mask;
* :func:`match_positives` — ``Anchors:findPositive`` (``Anchors.lua:147-195``):
  IoU > pos_threshold positives plus the order-dependent best-match
  fallback with its 0.025 tie band, as a prefix-max scan (``torch.cummax``)
  over the canonical anchor order;
* :func:`select_positive_pairs` — the [G, A] positive mask as at most P
  (anchor, gt) pairs, ROI-major;
* :func:`sample_negatives` — ``Anchors:sampleNegative`` (``Anchors.lua:197-235``)
  as Gumbel top-k with equal weight per (scale, aspect) range;
* :func:`nearby_negatives` — nearby aversion (``BatchIterator.lua:206-225``):
  anchors sharing a 16 px center bin with a positive, IoU below the
  negative threshold, drawn uniformly by Gumbel top-k.

The noise is an argument: the caller draws it (:func:`gumbel`, from a
``torch.Generator``), so a test can pass the exact draws of
``jax.random.gumbel``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frcnn_tpu_torch.geometry import boxes as B

BEST_MATCH_TIE_BAND = 0.025  # ``Anchors.lua:176``


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    [tiny, 1) as ``jax.random.gumbel`` draws it (float32)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def compact_mask(mask: torch.Tensor, k: int):
    """Indices of the first ``k`` True entries of ``mask`` along its last
    axis, in order, padded with -1. Batched over leading axes.

    Returns (indices [..., k] int32, valid [..., k] bool, count [...] int32).
    """
    n = mask.shape[-1]
    # a stable sort of (not mask) brings the True entries first, in order
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    if k > n:
        order = torch.nn.functional.pad(order, (0, k - n))
    order = order[..., :k]
    total = mask.sum(dim=-1)
    j = torch.arange(k, device=mask.device)
    valid = j < total[..., None]
    out = torch.where(valid, order, torch.full_like(order, -1))
    count = torch.clamp(total, max=k)
    return out.to(torch.int32), valid, count.to(torch.int32)


def match_positives(anchor_boxes, candidate_mask, gt_boxes, gt_mask,
                    pos_threshold: float, neg_threshold: float,
                    include_best: bool, iou=None):
    """Per-ROI positive anchor masks ``[B, G, A]`` bool.

    anchor_boxes [A, 4] (canonical order); candidate_mask [B, A] (anchors
    inside the image and the true-size maps); gt_boxes [B, G, 4]; gt_mask
    [B, G]; ``iou`` an optional precomputed [B, G, A] IoU.

    IoU > pos_threshold is positive. Otherwise, with ``include_best``, the
    running-best scan: an anchor enters the best set when its IoU is >= the
    running maximum (and > neg_threshold), and the set is flushed whenever
    an anchor beats the running maximum by more than 0.025
    (``Anchors.lua:169-181``); the set is used only by an ROI without a
    direct positive. Assumes neg_threshold >= 0.
    """
    if iou is None:
        iou = B.iou_matrix(gt_boxes, anchor_boxes)
    cand = candidate_mask[:, None, :] & (iou > 0.0)
    direct = cand & (iou > pos_threshold)
    has_direct = direct.any(dim=-1, keepdim=True)
    if include_best:
        v = torch.where(cand & (iou > neg_threshold), iou,
                        torch.full_like(iou, -1.0))
        run_max = torch.cummax(v, dim=-1).values
        m_before = torch.cat([torch.full_like(v[..., :1], -1.0),
                              run_max[..., :-1]], dim=-1)
        inserted = (v >= m_before) & (v > neg_threshold)
        resets = (v > m_before + BEST_MATCH_TIE_BAND).to(torch.int32)
        resets_after = resets.sum(dim=-1, keepdim=True) \
            - torch.cumsum(resets, dim=-1)
        best = inserted & (resets_after == 0)
        pos = torch.where(has_direct, direct, best)
    else:
        pos = direct
    return pos & gt_mask[..., None]


class PositiveSelection(NamedTuple):
    anchor_idx: torch.Tensor  # [B, P] int64
    gt_idx: torch.Tensor      # [B, P] int64
    valid: torch.Tensor       # [B, P] bool
    count: torch.Tensor       # [B] int32


def select_positive_pairs(pos_matrix, max_positives: int) -> PositiveSelection:
    """Flatten the [B, G, A] positive mask to at most ``max_positives``
    (anchor, gt) pairs per image, ROI-major like the reference match list."""
    b, g_count, a_count = pos_matrix.shape
    idx, valid, count = compact_mask(pos_matrix.reshape(b, g_count * a_count),
                                     max_positives)
    safe = torch.clamp(idx, min=0).to(torch.int64)
    return PositiveSelection(anchor_idx=safe % a_count,
                             gt_idx=torch.div(safe, a_count,
                                              rounding_mode="floor"),
                             valid=valid, count=count)


def sample_negatives(noise, anchor_boxes, valid_mask, range_id,
                     num_ranges: int, gt_boxes, gt_mask, neg_threshold,
                     count: int, requested, iou=None):
    """Random negative anchors: (indices [B, count] int64, valid [B, count]).

    noise [B, A] Gumbel draws; valid_mask [B, A]; range_id [A] int (scale*3
    + aspect); neg_threshold and requested [B] (or scalars). An anchor is
    clean when its IoU with every real ROI is <= the threshold; each range
    gets equal total weight, split evenly over its clean anchors
    (``Anchors.lua:205-207``); the draw is without replacement.
    """
    if iou is None:
        iou = B.iou_matrix(gt_boxes, anchor_boxes)
    thr = torch.as_tensor(neg_threshold, dtype=iou.dtype, device=iou.device)
    thr = thr.reshape(-1, 1, 1) if thr.dim() else thr
    iou = torch.where(gt_mask[..., None], iou, torch.zeros_like(iou))
    clean = valid_mask & ~(iou > thr).any(dim=1)
    cf = clean.to(torch.float32)
    rid = torch.as_tensor(range_id, device=iou.device).to(torch.int64)
    per_range = torch.zeros(cf.shape[0], num_ranges, dtype=torch.float32,
                            device=cf.device).index_add_(1, rid, cf)
    weight = torch.where(clean, 1.0 / torch.clamp(per_range[:, rid], min=1.0),
                         torch.zeros_like(cf))
    score = torch.where(clean, torch.log(torch.clamp(weight, min=1e-20))
                        + noise, torch.full_like(cf, -torch.inf))
    idx = torch.topk(score, count, dim=-1).indices
    n_clean = clean.sum(dim=-1)
    req = torch.as_tensor(requested, device=iou.device)
    cap = torch.minimum(req, n_clean)
    j = torch.arange(count, device=iou.device)
    valid = torch.gather(clean, 1, idx) & (j < cap.reshape(-1, 1))
    return idx, valid


def nearby_negatives(noise, anchor_boxes, bin_x, bin_y, fm_mask, pos_idx,
                     pos_valid, neg_threshold: float, count: int,
                     num_positives):
    """Nearby-aversion negatives: (indices [B, count] int64, valid).

    An anchor qualifies when it shares its 16 px center bin (both axes)
    with a selected positive anchor and its IoU with that positive is below
    the threshold; ``fm_mask`` [B, A] (in the true-size maps; no
    inside-image check, as ``findNearby``). At most ``num_positives`` [B]
    are kept, drawn uniformly (unique anchors: the reference's list may
    repeat one).
    """
    pos_idx = pos_idx.to(torch.int64)
    pbx = bin_x[pos_idx]
    pby = bin_y[pos_idx]
    pboxes = anchor_boxes[pos_idx]                          # [B, P, 4]
    same_bin = (bin_x == pbx[..., None]) & (bin_y == pby[..., None])
    iou = B.iou_matrix(pboxes, anchor_boxes)                # [B, P, A]
    cand = (same_bin & (iou < neg_threshold) & pos_valid[..., None]
            & fm_mask[:, None, :])
    cand_any = cand.any(dim=1)
    score = torch.where(cand_any, noise, torch.full_like(noise, -torch.inf))
    idx = torch.topk(score, count, dim=-1).indices
    cap = torch.minimum(torch.as_tensor(num_positives, device=noise.device),
                        cand_any.sum(dim=-1))
    j = torch.arange(count, device=noise.device)
    valid = torch.gather(cand_any, 1, idx) & (j < cap.reshape(-1, 1))
    return idx, valid
