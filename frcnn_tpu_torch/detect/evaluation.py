"""Detection evaluation (the JAX package's ``detect/evaluation.py``):
per-class average precision (VOC-style).

The reference never finished its evaluation code (README TODO: "regularly
evaluate net during traning", "eval code rewrite still pending") — its only
check was eyeballing drawn boxes. This provides the missing piece: greedy
score-ordered matching of detections to ground truth at an IoU threshold,
all-points-interpolated AP per class, and mAP.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _ap_from_pr(tp: np.ndarray, fp: np.ndarray, n_gt: int) -> float:
    """All-points interpolated AP from per-detection tp/fp flags sorted by
    descending score."""
    if n_gt == 0:
        return float("nan")
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    # envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)


def _iou(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def compute_map(detections: List[dict], ground_truth: List[dict],
                num_classes: int, iou_threshold: float = 0.5) -> Dict:
    """detections: [{image, class, score, box}], ground_truth:
    [{image, class, box}]. Returns {'mAP', 'per_class': {c: ap}}."""
    aps = {}
    for c in range(num_classes):
        dets = sorted(
            (d for d in detections if d["class"] == c),
            key=lambda d: -d["score"],
        )
        gts = [g for g in ground_truth if g["class"] == c]
        matched = set()
        by_image: Dict = {}
        for gi, g in enumerate(gts):
            by_image.setdefault(g["image"], []).append(gi)
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for di, d in enumerate(dets):
            best, best_gi = 0.0, -1
            for gi in by_image.get(d["image"], []):
                if gi in matched:
                    continue
                v = _iou(d["box"], gts[gi]["box"])
                if v > best:
                    best, best_gi = v, gi
            if best >= iou_threshold and best_gi >= 0:
                tp[di] = 1
                matched.add(best_gi)
            else:
                fp[di] = 1
        ap = _ap_from_pr(tp, fp, len(gts))
        if not np.isnan(ap):
            aps[c] = ap
    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"mAP": mAP, "per_class": aps}


def collect_detections(detector, batch_iterator, max_images: int = 200,
                       batch: int = 8, with_proposals: bool = False):
    """Run the detector over validation images; return the raw
    ``(detections, gts, num_images)`` lists (inputs of :func:`compute_map`).
    Exposed separately so post-hoc analyses can re-score one detector pass
    many ways without running the detector again.

    ``with_proposals=True`` returns a fourth value — ``{image_id: [box]}``
    of ALL stage-1 NMS survivors (``DetectionResult.proposals``), the input
    of :func:`proposal_coverage`."""
    detections, gts = [], []
    proposals: Dict[int, list] = {}
    done = 0
    img_id = 0
    while done < max_images:
        n = min(batch, max_images - done)
        imgs, hws, rois_list = batch_iterator.padded_validation_batch(n)
        if len(rois_list) == 0:
            break
        imgs, hws = torch.as_tensor(imgs), torch.as_tensor(hws)
        # keep the detect batch size FIXED, so that a ragged final batch
        # runs the same program: tile the last image into the pad slots
        # and ignore their outputs
        if imgs.shape[0] < batch:
            pad = batch - imgs.shape[0]
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
            hws = torch.cat([hws, hws[-1:].expand(pad, *hws.shape[1:])])
        out = detector.detect(imgs, hws)
        valid = out.valid.cpu().numpy()
        boxes = out.boxes.cpu().numpy()
        classes = out.classes.cpu().numpy()
        conf = out.confidence.cpu().numpy()
        if with_proposals:
            props = out.proposals.cpu().numpy()
            pvalid = out.proposals_valid.cpu().numpy()
        for b in range(len(rois_list)):
            for roi in rois_list[b]:
                gts.append(
                    {"image": img_id, "class": roi["class_index"],
                     "box": roi["rect"]}
                )
            for k in np.nonzero(valid[b])[0]:
                detections.append(
                    {"image": img_id, "class": int(classes[b, k]),
                     "score": float(conf[b, k]),
                     "box": boxes[b, k].tolist()}
                )
            if with_proposals:
                proposals[img_id] = [
                    props[b, k].tolist() for k in np.nonzero(pvalid[b])[0]
                ]
            img_id += 1
        done += len(rois_list)
    if with_proposals:
        return detections, gts, img_id, proposals
    return detections, gts, img_id


def matched_recall(detections: List[dict], ground_truth: List[dict],
                   iou_threshold: float = 0.5) -> float:
    """Fraction of GT boxes matched (greedy, score-ordered, class-aware) by
    any detection at the IoU threshold — the recall component the
    reference's conf>0.2 gate (``Detector.lua:115``) trades off."""
    if not ground_truth:
        return float("nan")
    matched = set()
    by_image: Dict = {}
    for gi, g in enumerate(ground_truth):
        by_image.setdefault((g["image"], g["class"]), []).append(gi)
    for d in sorted(detections, key=lambda d: -d["score"]):
        best, best_gi = 0.0, -1
        for gi in by_image.get((d["image"], d["class"]), []):
            if gi in matched:
                continue
            v = _iou(d["box"], ground_truth[gi]["box"])
            if v > best:
                best, best_gi = v, gi
        if best >= iou_threshold and best_gi >= 0:
            matched.add(best_gi)
    return len(matched) / len(ground_truth)


def proposal_coverage(proposals: Dict[int, list], ground_truth: List[dict],
                      iou_threshold: float = 0.5) -> Dict:
    """Stage-1 recall attribution: for each GT box, is it covered (IoU >=
    threshold, class-agnostic — stage 1 has no class) by ANY stage-1 NMS
    survivor? Splits end-to-end recall loss into 'no proposal covered it'
    (stage-1: fg gate / proposal NMS / caps) vs 'a proposal covered it but
    the classifier+conf gate dropped it' (stage-2). The reference never
    measured this (its eval was eyeballing drawn boxes)."""
    if not ground_truth:
        return {"proposal_recall": float("nan"), "num_covered": 0}
    covered = 0
    for g in ground_truth:
        if any(_iou(p, g["box"]) >= iou_threshold
               for p in proposals.get(g["image"], [])):
            covered += 1
    return {
        "proposal_recall": covered / len(ground_truth),
        "num_covered": covered,
    }


def evaluate_map(cfg, detector, batch_iterator, max_images: int = 200,
                 iou_threshold: float = 0.5, batch: int = 8,
                 with_proposal_recall: bool = False) -> Dict:
    """Run the detector over validation images and compute mAP.

    ``with_proposal_recall=True`` adds stage-attribution fields:
    ``proposal_recall`` (GT covered by any stage-1 survivor),
    ``detection_recall`` (GT matched by a final detection, class-aware) —
    their gap is the classifier+confidence-gate loss."""
    if with_proposal_recall:
        detections, gts, img_id, proposals = collect_detections(
            detector, batch_iterator, max_images, batch, with_proposals=True
        )
    else:
        detections, gts, img_id = collect_detections(
            detector, batch_iterator, max_images, batch
        )
    result = compute_map(detections, gts, cfg.class_count, iou_threshold)
    result["num_images"] = img_id
    result["num_detections"] = len(detections)
    result["num_gt"] = len(gts)
    if with_proposal_recall:
        result.update(proposal_coverage(proposals, gts, iou_threshold))
        result["detection_recall"] = matched_recall(detections, gts,
                                                    iou_threshold)
    return result
