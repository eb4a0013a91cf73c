"""Joint two-stage training objective.

Port of the JAX package's ``train/objective.py`` (``objective.lua:15-221``),
batched over the images of a step:

  1. masked input normalization (``BatchIterator.lua:142-161``);
  2. pnet forward (spatial dropout) -> 4 anchor maps + the feature map;
  3. anchor labeling on the device: positives with the best-match fallback,
     random negatives, nearby-aversion negatives (``BatchIterator.lua:198-225``);
  4. proposal losses at the labeled anchors: 2-class CE + 10x sum SmoothL1
     on the corner-offset regression (``objective.lua:91-140``);
  5. ROI adaptive max pool of the GROUND-TRUTH rect for positives and the
     anchor rect for negatives (``objective.lua:117-119, 137-139``);
  6. cnet forward (masked batch norm, dropout) and the detection losses:
     10x SmoothL1 on the refinement against a target encoded on the frozen
     decoded proposal (``objective.lua:109, 166-170``), class NLL with
     background, mean per image (``objective.lua:174``).

Total = (pcls_sum + 10 preg_sum + 10 dreg_sum + sum_img dcls_mean) /
cls_count: the reference's one ``gradient:div(cls_count)``
(``objective.lua:200``). The metrics are the four normalized series and the
counts (``objective.lua:202-216``).

Parameters are float32 masters: conv, linear and PReLU weights are cast to
the compute dtype inside autograd at each step (``models/factory.py::
cast_for_compute``), so their gradients reach the masters in float32.
``cfg.pallas_mode`` picks the ROI pool: "off" the plain versions of the
forward and its gradient (``ops/roi_pool.py``), otherwise the CUDA kernels
(``ops/roi_pool_kernel.py``), both skipping invalid rois. Random draws (the
Gumbel noise of the negative sampling, then the dropout masks of pnet and
of cnet) come from the ``torch.Generator`` passed in, in that order, all
before the forward. ``cfg.remat`` recomputes pnet in the backward pass;
``bwd_cut`` truncates the backward for profiling; a :class:`BatchShard`
makes the function one process's part of a data-parallel step
(``parallel/``).

Deliberate differences from the JAX objective: the regression targets of
padded (invalid) positive slots are zeroed before the masked sums, so a
degenerate gt box in a padded slot cannot turn the sums into NaN
(0 * inf); valid slots are unchanged.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.detect.detector import take_rows
from frcnn_tpu_torch.geometry import boxes as B
from frcnn_tpu_torch.geometry import matching as M
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
from frcnn_tpu_torch.models.factory import (
    cast_for_compute,
    compute_dtype,
    compute_param_names,
)
from frcnn_tpu_torch.ops import roi_pool as roi_plain
from frcnn_tpu_torch.ops import roi_pool_kernel
from frcnn_tpu_torch.ops.color import unwire_uint8
from frcnn_tpu_torch.ops.normalization import normalize_image
from frcnn_tpu_torch.train.losses import cross_entropy_fg_bg, nll_loss, smooth_l1


class TrainBatch(NamedTuple):
    """One fixed-shape training batch."""

    image: torch.Tensor          # [B, H, W, 3] float32 (or uint8 wire)
    true_hw: torch.Tensor        # [B, 2] int32 (h, w) of real content
    gt_boxes: torch.Tensor       # [B, G, 4] float32
    gt_classes: torch.Tensor     # [B, G] int32, 0-based (no background)
    gt_mask: torch.Tensor        # [B, G] bool
    is_background: torch.Tensor  # [B] bool, background-only slots

    def to(self, device) -> "TrainBatch":
        """The batch as tensors on ``device`` (other fields copied through
        numpy)."""
        return TrainBatch(*[
            (x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x))).to(device) for x in self])


class LabeledExamples(NamedTuple):
    """Per-image fixed-size example sets (indices into the flat anchors)."""

    pos_anchor: torch.Tensor     # [B, P] int64
    pos_gt: torch.Tensor         # [B, P] int64
    pos_valid: torch.Tensor      # [B, P] bool
    neg_anchor: torch.Tensor     # [B, N + NB] int64 (random, then nearby)
    neg_valid: torch.Tensor      # [B, N + NB] bool


class AnchorTables(NamedTuple):
    """An :class:`AnchorGenerator`'s tables as tensors on one device."""

    boxes: torch.Tensor          # [A, 4] float32
    range_id: torch.Tensor       # [A] int64, tap * 3 + aspect
    bin_x: torch.Tensor          # [A] int32
    bin_y: torch.Tensor          # [A] int32
    fy: torch.Tensor             # [A] int32
    fx: torch.Tensor             # [A] int32

    @staticmethod
    def of(gen: AnchorGenerator, device) -> "AnchorTables":
        def t(a):
            return torch.from_numpy(a).to(device)
        return AnchorTables(t(gen.boxes), t(gen.tap * 3 + gen.aspect).long(),
                            t(gen.bin_x), t(gen.bin_y), t(gen.fy), t(gen.fx))


def label_batch(cfg: Config, gen: AnchorGenerator, anchors: AnchorTables,
                batch: TrainBatch, noise_neg, noise_near) -> LabeledExamples:
    """Anchor labeling of every image of ``batch``; ``noise_neg`` and
    ``noise_near`` [B, A] are the Gumbel draws of the two samplers."""
    s = cfg.shapes
    h, w = batch.true_hw[:, 0], batch.true_hw[:, 1]
    fm_mask = gen.fm_valid_mask(h, w, fy=anchors.fy, fx=anchors.fx)
    cand = fm_mask & gen.inside_image_mask(h, w, boxes=anchors.boxes)
    # one [B, G, A] IoU shared by matching and negative sampling
    iou = B.iou_matrix(batch.gt_boxes, anchors.boxes)
    pos = M.match_positives(anchors.boxes, cand, batch.gt_boxes,
                            batch.gt_mask, cfg.positive_threshold,
                            cfg.negative_threshold, cfg.best_match, iou=iou)
    sel = M.select_positive_pairs(pos, s.max_positives)
    # random negatives: 16 per foreground image (BatchIterator.lua:203),
    # floor(0.05 * batch_size) at threshold 0 for a background slot
    # (BatchIterator.lua:259)
    bg = batch.is_background
    requested = torch.where(bg, int(0.05 * cfg.batch_size), 16)
    neg_thr = torch.where(bg, 0.0, cfg.negative_threshold).to(torch.float32)
    neg_idx, neg_valid = M.sample_negatives(
        noise_neg, anchors.boxes, cand, anchors.range_id,
        3 * len(cfg.scales), batch.gt_boxes, batch.gt_mask, neg_thr,
        s.max_negatives, requested, iou=iou)
    if cfg.nearby_aversion:
        near_idx, near_valid = M.nearby_negatives(
            noise_near, anchors.boxes, anchors.bin_x, anchors.bin_y, fm_mask,
            sel.anchor_idx, sel.valid, cfg.negative_threshold, s.max_nearby,
            sel.count)
    else:
        near_idx = torch.zeros_like(neg_idx[:, :1]).expand(-1, s.max_nearby)
        near_valid = torch.zeros_like(neg_valid[:, :1]).expand(
            -1, s.max_nearby)
    return LabeledExamples(
        pos_anchor=sel.anchor_idx, pos_gt=sel.gt_idx, pos_valid=sel.valid,
        neg_anchor=torch.cat([neg_idx, near_idx], dim=1),
        neg_valid=torch.cat([neg_valid, near_valid], dim=1))


def flatten_anchor_maps(gen: AnchorGenerator, anchor_maps):
    """[B, Hi, Wi, 18] x4 -> [B, A, 6] float32 in the canonical anchor
    order (tap, aspect, y, x)."""
    flats = []
    for m, (h, w) in zip(anchor_maps, gen.tap_dims):
        bsz = m.shape[0]
        x = m.reshape(bsz, h, w, 3, 6).permute(0, 3, 1, 2, 4)
        flats.append(x.reshape(bsz, 3 * h * w, 6))
    return torch.cat(flats, dim=1).float()


def _sub(tree: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix)}


class BatchShard(NamedTuple):
    """This process's part of a data-parallel step: images ``[rank * b,
    (rank + 1) * b)`` of a batch of ``world_size * b``. ``all_reduce``
    returns the sum of a tensor over the processes
    (``parallel/mesh.py::batch_shard``)."""

    rank: int
    world_size: int
    all_reduce: Callable[[torch.Tensor], torch.Tensor]


BWD_CUTS = ("fm", "maps")


def build_objective(cfg: Config, gen: AnchorGenerator, pnet, cnet,
                    bwd_cut: tuple = (), shard: BatchShard | None = None):
    """Returns ``loss_fn(params, batch_stats, batch, generator, labels=None)
    -> (total, (new_batch_stats, metrics))``.

    ``params``: float32 tensors keyed ``"pnet.<name>"`` / ``"cnet.<name>"``
    (``named_parameters`` of ``pnet``/``cnet``); ``batch_stats``: the
    running statistics keyed ``"cnet.<buffer name>"``; ``batch``: a
    :class:`TrainBatch` on the device; ``generator``: a ``torch.Generator``
    on the same device. ``labels``: a :class:`LabeledExamples` to use
    instead of drawing them (then no labeling noise is drawn). The metrics
    are 0-d float32 tensors; nothing is copied to the host.

    ``cfg.remat``: pnet's forward is recomputed in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations; its
    dropout masks are drawn before it and passed in, so the recompute
    replays them and the result is the same, bit for bit.

    ``bwd_cut``: the profiling-only cuts of the JAX objective: ``"fm"``
    detaches the feature map that goes into the ROI pool (no ROI-pool
    backward), ``"maps"`` also the anchor maps (no pnet backward). Forward
    values are the same in every mode.

    ``shard``: ``batch`` is this process's part of a data-parallel batch.
    Its labeling noise and dropout masks are its rows of the whole batch's
    draws, and the sums and counts are summed over the processes before
    the one division, so that the metrics are the whole batch's and the
    gradients summed over the processes are the whole batch's gradients;
    the new batch-norm statistics are averaged over the processes.
    """
    bad = set(bwd_cut) - set(BWD_CUTS)
    if bad:
        raise ValueError(f"bwd_cut takes {BWD_CUTS}, got {sorted(bad)}")
    s = cfg.shapes
    kh, kw = cfg.roi_pooling.kh, cfg.roi_pooling.kw
    R = s.max_roi_examples
    fm_loc = gen.fm_localizer
    cdt = compute_dtype(cfg)
    names_p = compute_param_names(pnet)
    names_c = compute_param_names(cnet)
    pool = (roi_plain.adaptive_max_pool_grad if cfg.pallas_mode == "off"
            else roi_pool_kernel.adaptive_max_pool_valid_grad)
    norm_kw = dict(method=cfg.normalization.method,
                   width=cfg.normalization.width,
                   centering=cfg.normalization.centering,
                   scaling=cfg.normalization.scaling)
    tables = {}

    def pnet_forward(pnet_params, norm, masks):
        pp = cast_for_compute(pnet_params, names_p, cdt)
        return functional_call(pnet, pp, (norm,),
                               {"train": True, "masks": masks})

    def loss_fn(params, batch_stats, batch: TrainBatch, generator,
                labels: LabeledExamples | None = None):
        device = batch.image.device
        if device not in tables:
            tables[device] = AnchorTables.of(gen, device)
        anchors = tables[device]
        bsz = batch.image.shape[0]
        h, w = batch.true_hw[:, 0], batch.true_hw[:, 1]
        rank, world = (0, 1) if shard is None else shard[:2]

        def mine(draws):
            """This process's rows of draws made for the whole batch."""
            if world == 1:
                return draws
            return [None if d is None else d[rank * bsz:(rank + 1) * bsz]
                    for d in draws]

        # 3. labeling (first: its noise is the generator's first draw)
        if labels is None:
            shape = (bsz * world, gen.num_anchors)
            noise_neg, noise_near = mine([M.gumbel(shape, generator, device),
                                          M.gumbel(shape, generator, device)])
            labels = label_batch(cfg, gen, anchors, batch, noise_neg,
                                 noise_near)
        # then the dropout masks, drawn before the forwards
        pnet_masks = mine(pnet.dropout_masks(bsz * world, generator, device))
        cnet_masks = mine(cnet.dropout_masks((bsz * world, R), generator,
                                             device))

        # 1-2. normalization, pnet
        image = unwire_uint8(batch.image, cfg.color_space)
        norm = normalize_image(image.float(), h, w, **norm_kw)
        if cfg.remat:
            # nothing in the region draws: no RNG state to keep
            anchor_maps, fm = checkpoint(
                pnet_forward, _sub(params, "pnet."), norm, pnet_masks,
                use_reentrant=False, preserve_rng_state=False)
        else:
            anchor_maps, fm = pnet_forward(_sub(params, "pnet."), norm,
                                           pnet_masks)
        if "fm" in bwd_cut:
            fm = fm.detach()
        if "maps" in bwd_cut:
            anchor_maps = [m.detach() for m in anchor_maps]
        pred = flatten_anchor_maps(gen, anchor_maps)           # [B, A, 6]

        # 4. proposal losses
        pos_pred = take_rows(pred, labels.pos_anchor)          # [B, P, 6]
        neg_pred = take_rows(pred, labels.neg_anchor)          # [B, N+NB, 6]
        pos_a_boxes = anchors.boxes[labels.pos_anchor]         # [B, P, 4]
        neg_a_boxes = anchors.boxes[labels.neg_anchor]
        pos_gt_boxes = take_rows(batch.gt_boxes, labels.pos_gt)  # [B, P, 4]
        pos_gt_cls = take_rows(batch.gt_classes, labels.pos_gt)  # [B, P]
        pv = labels.pos_valid.to(torch.float32)
        nv = labels.neg_valid.to(torch.float32)
        pvb = labels.pos_valid[..., None]
        zero = torch.zeros((), device=device)

        pcls_sum = ((cross_entropy_fg_bg(pos_pred[..., 0:2], True) * pv).sum()
                    + (cross_entropy_fg_bg(neg_pred[..., 0:2], False)
                       * nv).sum())
        reg_target = torch.where(pvb, B.encode(pos_a_boxes, pos_gt_boxes),
                                 zero)
        preg_sum = (smooth_l1(pos_pred[..., 2:6], reg_target).sum(-1)
                    * pv).sum()
        cls_count = pv.sum() + nv.sum()
        reg_count = pv.sum()

        # 5. ROI pooling: positives pool the gt rect, negatives the anchor
        roi_rects = torch.cat([pos_gt_boxes, neg_a_boxes], dim=1)
        roi_valid = torch.cat([labels.pos_valid, labels.neg_valid], dim=1)
        fw, fh = fm_loc.feature_map_size_t(w, h)
        rects = roi_plain.roi_pool_feature_rects(
            fm_loc, roi_rects, fw[:, None].float(), fh[:, None].float())
        pooled = pool(fm.contiguous(), rects, roi_valid, kh, kw)
        pooled = pooled.reshape(bsz, R, kh * kw * fm.shape[-1])

        # 6. cnet + detection losses
        cp = cast_for_compute(_sub(params, "cnet."), names_c, cdt)
        creg, clogp, new_stats = functional_call(
            cnet, {**cp, **_sub(batch_stats, "cnet.")}, (pooled, roi_valid),
            {"train": True, "masks": cnet_masks})
        # the frozen deltas clamped at +-20 and the encode base floored at
        # 1 px keep the targets finite for an untrained head (see the JAX
        # objective, objective.py:284-301)
        frozen = torch.clamp(pos_pred[..., 2:6].detach(), -20.0, 20.0)
        prop = B.decode(pos_a_boxes, frozen)
        prop = B.from_xywh(prop[..., 0], prop[..., 1],
                           torch.clamp(B.width(prop), min=1.0),
                           torch.clamp(B.height(prop), min=1.0))
        dreg_target = torch.where(pvb, B.encode(prop, pos_gt_boxes), zero)
        dreg_sum = (smooth_l1(creg[:, :s.max_positives], dreg_target).sum(-1)
                    * pv).sum()

        # classification: positives -> their class, negatives -> background
        targets = torch.cat([pos_gt_cls.long(),
                             torch.full_like(labels.neg_anchor,
                                             cfg.class_count)], dim=1)
        rv = roi_valid.to(torch.float32)
        nll = nll_loss(clogp, targets) * rv
        dcls_sum = (nll.sum(1) / torch.clamp(rv.sum(1), min=1.0)).sum()

        sums = torch.stack([pcls_sum, preg_sum, dreg_sum, dcls_sum,
                            cls_count, reg_count]).detach()
        new_bs = {f"cnet.{k}": v for k, v in new_stats.items()}
        if shard is not None:
            # one collective: the whole batch's sums and counts, and the
            # new statistics' sum over the processes
            keys = list(new_bs)
            flat = shard.all_reduce(torch.cat(
                [sums, *[new_bs[k].reshape(-1) for k in keys]]))
            sums, rest = flat[:6], flat[6:]
            for k in keys:
                n = new_bs[k].numel()
                new_bs[k] = rest[:n].reshape(new_bs[k].shape) / world
                rest = rest[n:]
        pcls_all, preg_all, dreg_all, dcls_all, cls_all, reg_all = sums

        denom = torch.clamp(cls_all, min=1.0)
        # this process's share of the whole batch's objective: the sum over
        # the processes is the objective (and its gradient)
        total = (pcls_sum + 10.0 * preg_sum + 10.0 * dreg_sum
                 + dcls_sum) / denom
        reg_den = torch.clamp(reg_all, min=1.0)
        metrics = {
            "pcls": pcls_all / denom,
            "preg": 10.0 * preg_all / reg_den,
            "dcls": dcls_all / (bsz * world),
            "dreg": 10.0 * dreg_all / reg_den,
            "loss": pcls_all / denom + 10.0 * preg_all / reg_den,
            "cls_count": cls_all,
            "reg_count": reg_all,
        }
        return total, (new_bs, metrics)

    return loss_fn


def value_and_grad(loss_fn, params, batch_stats, batch, generator,
                   labels=None):
    """``(total, (new_batch_stats, metrics), grads)`` of ``loss_fn`` at
    ``params``; ``grads`` has the keys of ``params`` (zeros for a
    parameter the step does not reach)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        total, aux = loss_fn(leaves, batch_stats, batch, generator, labels)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return total.detach(), aux, grads
