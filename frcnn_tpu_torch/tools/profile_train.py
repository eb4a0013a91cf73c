"""Training-step timing on the card (the counterpart of
``scripts/profile_train.py``).

    python -m frcnn_tpu_torch.tools.profile_train [images_per_step]
        [loop_iters] [stage...] [--hw HxW] [--device cuda|cpu]

Stages (default: step): ``loss`` (the objective's forward alone), ``grad``
(forward and backward, no update), ``step`` (``grad`` and the RMSprop
update), ``objparts`` (the forward's parts, cumulative: norm, norm+pnet,
labeling, norm+pnet+label+pool), ``labelparts`` (the labeling's parts:
IoU matrix, positives, random negatives, nearby negatives), ``bwdparts``
(the backward by truncation: the objective's ``bwd_cut`` ("fm", "maps"),
("fm",) and none; ``grad[sg fm+maps]`` is the forward with the cnet and
loss backward, ``grad[sg fm]`` minus it the pnet backward, ``grad[full]``
minus that the ROI-pool backward). ``loss`` against ``grad`` isolates the
backward, ``grad`` against ``step`` the update. Switches: ``pallas`` (the
kernels: ROI-pool forward and backward, the pools' backward), ``remat``
(pnet recomputed in the backward).

vgg_small with the duplo config at ``--hw`` (default 450x800), the
seeded ``Trainer`` (seed 0) and ``scripts/profile_train.py``'s seeded
batch: four gt boxes per image, ``normal(0.3, 0.2)`` images. Timing is
``utils/metrics.py::loop_time`` (CUDA events, two loop lengths
differenced). The JAX script perturbs the gt boxes and the parameters in
its loop so that XLA cannot hoist work out of it; eager PyTorch hoists
nothing, and the step and grad bodies draw new labeling noise and dropout
masks from the trainer's generator at every call, as training does.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from frcnn_tpu_torch.cli import require_device

from frcnn_tpu_torch.tools.profile_detect import parse_hw
from frcnn_tpu_torch.utils.metrics import loop_time

STAGES = ("step", "objparts", "labelparts", "bwdparts", "loss", "grad")
SWITCHES = ("pallas", "remat")
BWD_CUTS = (("sg fm+maps", ("fm", "maps")), ("sg fm", ("fm",)),
            ("full", ()))


class Setup(NamedTuple):
    cfg: object
    trainer: object
    batch: object          # TrainBatch on the device
    device: torch.device


def profile_batch(cfg, seed: int = 0):
    """``scripts/profile_train.py:76-99``'s seeded batch (numpy): four gt
    boxes per image of 40-130 px sides (capped at half the bucket), class
    0, no background slot, then ``normal(0.3, 0.2)`` images."""
    from frcnn_tpu_torch.train.objective import TrainBatch

    B = cfg.shapes.images_per_step
    H, W = cfg.shapes.image_hw
    G = cfg.shapes.max_gt
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, G, 4), np.float32)
    gt_m = np.zeros((B, G), bool)
    box_hi = min(130, H // 2, W // 2)
    box_lo = min(40, box_hi - 1)
    for b in range(B):
        for g in range(4):
            x0 = rng.uniform(5, W - box_hi - 10)
            y0 = rng.uniform(5, H - box_hi - 10)
            gt[b, g] = [x0, y0, x0 + rng.uniform(box_lo, box_hi),
                        y0 + rng.uniform(box_lo, box_hi)]
            gt_m[b, g] = True
    return TrainBatch(
        image=rng.normal(0.3, 0.2, (B, H, W, 3)).astype(np.float32),
        true_hw=np.tile(np.array([[H, W]], np.int32), (B, 1)),
        gt_boxes=gt,
        gt_classes=np.zeros((B, G), np.int32),
        gt_mask=gt_m,
        is_background=np.zeros((B,), bool),
    )


def setup(B: int, hw=(450, 800), pallas: bool = False, remat: bool = False,
          device="cuda") -> Setup:
    from frcnn_tpu_torch.config import duplo_config
    from frcnn_tpu_torch.train.trainer import Trainer

    cfg = duplo_config()
    cfg = cfg.replace(shapes=dataclasses.replace(
        cfg.shapes, image_hw=tuple(hw), images_per_step=B))
    if pallas:
        cfg = cfg.replace(pallas_mode="on")
    if remat:
        cfg = cfg.replace(remat=True)
    device = torch.device(device)
    tr = Trainer(cfg, device=device, seed=0)
    return Setup(cfg, tr, profile_batch(cfg).to(device), device)


def stage_bodies(S: Setup, stages):
    """``[(label, body)]`` in the JAX script's order; each body takes no
    argument and returns its output (``step`` also updates the trainer)."""
    from frcnn_tpu_torch.geometry import boxes as GB
    from frcnn_tpu_torch.geometry import matching as GM
    from frcnn_tpu_torch.train.objective import build_objective, \
        value_and_grad

    bad = set(stages) - set(STAGES)
    if bad:
        raise ValueError(f"unknown stages {sorted(bad)}; stages: {STAGES}")
    cfg, tr, batch = S.cfg, S.trainer, S.batch
    hw = batch.image.shape[1:3]
    gen = _generator_of(cfg, hw)
    s = cfg.shapes
    out = []

    if "objparts" in stages:
        out += _objparts(S, gen)

    if "labelparts" in stages:
        from frcnn_tpu_torch.train.objective import AnchorTables

        a = AnchorTables.of(gen, S.device)
        bsz = batch.image.shape[0]
        h, w = batch.true_hw[:, 0], batch.true_hw[:, 1]

        def masks():
            fm = gen.fm_valid_mask(h, w, fy=a.fy, fx=a.fx)
            return fm, fm & gen.inside_image_mask(h, w, boxes=a.boxes)

        def positives():
            _, cand = masks()
            pos = GM.match_positives(a.boxes, cand, batch.gt_boxes,
                                     batch.gt_mask, cfg.positive_threshold,
                                     cfg.negative_threshold, cfg.best_match)
            return GM.select_positive_pairs(pos, s.max_positives)

        def negatives():
            _, cand = masks()
            bg = batch.is_background
            noise = GM.gumbel((bsz, gen.num_anchors), tr.generator,
                              S.device)
            return GM.sample_negatives(
                noise, a.boxes, cand, a.range_id, 3 * len(cfg.scales),
                batch.gt_boxes, batch.gt_mask,
                torch.where(bg, 0.0, cfg.negative_threshold).to(
                    torch.float32),
                s.max_negatives,
                torch.where(bg, int(0.05 * cfg.batch_size), 16))

        def nearby():
            fm, _ = masks()
            sel = positives()
            noise = GM.gumbel((bsz, gen.num_anchors), tr.generator,
                              S.device)
            return GM.nearby_negatives(
                noise, a.boxes, a.bin_x, a.bin_y, fm, sel.anchor_idx,
                sel.valid, cfg.negative_threshold, s.max_nearby, sel.count)

        out += [("iou[GxA]", lambda: GB.iou_matrix(batch.gt_boxes, a.boxes)),
                ("pos(match+select)", positives),
                ("neg(sample)", negatives),
                ("near(pos+nearby)", nearby)]

    if "bwdparts" in stages:
        for label, cut in BWD_CUTS:
            fn = build_objective(cfg, gen, tr.pnet, tr.cnet, bwd_cut=cut)
            out.append((f"grad[{label}]",
                        lambda fn=fn: value_and_grad(
                            fn, tr.params, tr.batch_stats, batch,
                            tr.generator)))

    if "loss" in stages:
        def loss():
            with torch.no_grad():
                return tr.objective(hw)(tr.params, tr.batch_stats, batch,
                                        tr.generator)
        out.append(("objective fwd", loss))

    if "grad" in stages:
        out.append(("fwd+bwd", lambda: tr.compute_gradients(batch)))

    if "step" in stages:
        def step():
            _, (new_bs, metrics), grads = tr.compute_gradients(batch)
            tr.apply_gradients(grads, new_bs)
            return metrics
        out.append(("train step", step))
    return out


def _generator_of(cfg, hw):
    from frcnn_tpu_torch.geometry.anchors import AnchorGenerator

    return AnchorGenerator(cfg, image_hw=tuple(int(x) for x in hw))


def _objparts(S: Setup, gen):
    """The objective's forward, cumulative (``scripts/profile_train.py:
    136-232``): normalize; + pnet (train mode, dropout); labeling alone;
    normalize + pnet + labeling + the ROI pool of the labeled rois."""
    from torch.func import functional_call

    from frcnn_tpu_torch.detect.detector import take_rows
    from frcnn_tpu_torch.geometry import matching as GM
    from frcnn_tpu_torch.models.factory import (
        cast_for_compute,
        compute_dtype,
        compute_param_names,
    )
    from frcnn_tpu_torch.ops import roi_pool as roi_plain
    from frcnn_tpu_torch.ops import roi_pool_kernel
    from frcnn_tpu_torch.ops.normalization import normalize_image
    from frcnn_tpu_torch.train.objective import AnchorTables, label_batch

    cfg, tr, batch = S.cfg, S.trainer, S.batch
    a = AnchorTables.of(gen, S.device)
    n = cfg.normalization
    h, w = batch.true_hw[:, 0], batch.true_hw[:, 1]
    bsz = batch.image.shape[0]
    names = compute_param_names(tr.pnet)
    pparams = {k[5:]: v for k, v in tr.params.items()
               if k.startswith("pnet.")}
    kh, kw = cfg.roi_pooling.kh, cfg.roi_pooling.kw
    pool = (roi_plain.adaptive_max_pool if cfg.pallas_mode == "off"
            else roi_pool_kernel.adaptive_max_pool_valid)

    def norm():
        return normalize_image(batch.image, h, w, method=n.method,
                               width=n.width, centering=n.centering,
                               scaling=n.scaling)

    def pnet():
        masks = tr.pnet.dropout_masks(bsz, tr.generator, S.device)
        return functional_call(
            tr.pnet, cast_for_compute(pparams, names, compute_dtype(cfg)),
            (norm(),), {"train": True, "masks": masks})

    def labels():
        shape = (bsz, gen.num_anchors)
        return label_batch(cfg, gen, a, batch,
                           GM.gumbel(shape, tr.generator, S.device),
                           GM.gumbel(shape, tr.generator, S.device))

    def upto_pool():
        _, fm = pnet()
        lab = labels()
        rects = torch.cat([take_rows(batch.gt_boxes, lab.pos_gt),
                           a.boxes[lab.neg_anchor]], dim=1)
        valid = torch.cat([lab.pos_valid, lab.neg_valid], dim=1)
        loc = gen.fm_localizer
        fw, fh = loc.feature_map_size_t(w, h)
        pr = roi_plain.roi_pool_feature_rects(loc, rects, fw[:, None].float(),
                                              fh[:, None].float())
        return pool(fm.contiguous(), pr, valid, kh, kw)

    return [("norm", norm), ("norm+pnet", pnet), ("label", labels),
            ("norm+pnet+label+pool", upto_pool)]


def run(S: Setup, stages, n: int, out=print) -> dict:
    """Times every stage body; one line each with ms, steps/s and img/s.
    Returns {label: seconds per call}."""
    B = S.batch.image.shape[0]
    times = {}
    for label, body in stage_bodies(S, stages):
        per = loop_time(body, n, label, S.device, out=lambda _: None)
        times[label] = per
        out(f"{label} ({B} img): {per * 1e3:.1f} ms -> {1 / per:.2f}/s, "
            f"{B / per:.1f} img/s")
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("n", nargs="?", type=int, default=20)
    ap.add_argument("stages", nargs="*",
                    help=f"stages {STAGES} and switches {SWITCHES}")
    ap.add_argument("--hw", type=parse_hw, default=(450, 800))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    stages = set(args.stages)
    S = setup(args.batch, args.hw, "pallas" in stages, "remat" in stages,
              args.device)
    run(S, (stages - set(SWITCHES)) or {"step"}, args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
