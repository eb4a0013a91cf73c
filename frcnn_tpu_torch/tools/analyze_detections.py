"""Detection quality on the card: confusion matrix, IoU statistics, recall
and false positives (the counterpart of ``scripts/analyze_detections.py``).

    python -m frcnn_tpu_torch.tools.analyze_detections --ckpt CKPT \
        --manifest MANIFEST [--count 30] [--split validation|training] \
        [--iou 0.5] [--device cuda|cpu]

The config is the checkpoint's own (``config_json``), its
``examples_base_path`` where the manifest's files are. Each ground-truth
box is matched one-to-one to the unclaimed detection of highest IoU in
its image; at IoU >= ``--iou`` it counts under the detection's class,
else as missed. Prints the counts, the matched IoU's mean and 10th/90th
percentiles, the confusion matrix (rows: ground-truth class; last column:
missed) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _iou(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


class Tally:
    """The confusion matrix and counts over images
    (``scripts/analyze_detections.py:71-113``)."""

    def __init__(self, class_count: int, iou: float = 0.5):
        self.C = class_count
        self.iou = iou
        self.conf = np.zeros((class_count, class_count + 1), np.int64)
        self.ious, self.fp, self.n_det, self.n_gt = [], 0, 0, 0

    def add(self, dets, rois) -> None:
        """One image: ``dets`` [(box, class)], ``rois`` [{rect,
        class_index}]."""
        C = self.C
        self.n_det += len(dets)
        matched = set()
        for r in rois:
            self.n_gt += 1
            best, bc, bi = 0.0, C, -1
            # one-to-one: a detection claimed by an earlier ground truth
            # cannot match again (as evaluation.py::compute_map)
            for di, (bx, c) in enumerate(dets):
                if di in matched:
                    continue
                v = _iou(bx, r["rect"])
                if v > best:
                    best, bc, bi = v, c, di
            if best >= self.iou and bi >= 0:
                self.conf[r["class_index"], bc] += 1
                matched.add(bi)
                self.ious.append(best)
            else:
                self.conf[r["class_index"], C] += 1
        self.fp += sum(1 for di in range(len(dets)) if di not in matched)

    def summary(self) -> dict:
        matched_n = int(self.conf[:, :self.C].sum())
        correct = int(np.trace(self.conf[:, :self.C]))
        return {
            "recall": matched_n / max(self.n_gt, 1),
            "class_acc_matched": correct / max(matched_n, 1),
            "false_positives": self.fp,
            "mean_matched_iou": (float(np.mean(self.ious)) if self.ious
                                 else 0.0),
        }


def main(argv=None) -> int:
    from frcnn_tpu_torch.config import Config
    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.utils.serialization import load_checkpoint
    from frcnn_tpu_torch.utils.weights import from_jax_params

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--count", type=int, default=30)
    ap.add_argument("--split", choices=["validation", "training"],
                    default="validation")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iou", type=float, default=0.5)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    ckpt = load_checkpoint(args.ckpt)
    cfg = Config.from_json(ckpt["config_json"])
    det = Detector(cfg, *models_from_state_dicts(cfg, from_jax_params(
        ckpt["params"], ckpt["batch_stats"], cfg)), device=device)
    it = BatchIterator(cfg, args.manifest, seed=1234)
    if args.split == "training":
        it.validation = it.training   # reuse the padded-batch machinery

    tally = Tally(cfg.class_count, args.iou)
    done = 0
    while done < args.count:
        imgs, hws, rois = it.padded_validation_batch(
            min(8, args.count - done))
        if imgs.shape[0] == 0:
            break
        out = det.detect(imgs, hws)
        valid = out.valid.cpu().numpy()
        boxes = out.boxes.cpu().numpy()
        cls = out.classes.cpu().numpy()
        for b in range(imgs.shape[0]):
            tally.add([(boxes[b, k], int(cls[b, k]))
                       for k in np.nonzero(valid[b])[0]], rois[b])
        done += imgs.shape[0]

    s = tally.summary()
    C = cfg.class_count
    matched_n = int(tally.conf[:, :C].sum())
    print(f"images: {done}  gt: {tally.n_gt}  detections: {tally.n_det}")
    print(f"recall@IoU{args.iou}: {matched_n}/{tally.n_gt}"
          f"  class-correct among matched: "
          f"{int(np.trace(tally.conf[:, :C]))}/{matched_n}"
          f"  unmatched detections (FP): {tally.fp}")
    if tally.ious:
        print(f"matched IoU: mean {np.mean(tally.ious):.3f}  "
              f"p10 {np.percentile(tally.ious, 10):.3f}  "
              f"p90 {np.percentile(tally.ious, 90):.3f}")
    print("confusion (rows gt class; last col = missed):")
    print(tally.conf)
    print(json.dumps(s), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
