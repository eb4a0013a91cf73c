"""Sensitivity sweep of the final confidence gate (``Detector.lua:115``:
``exp(confidence) > 0.2``) on the card (the counterpart of
``scripts/sweep_conf_gate.py``).

    python -m frcnn_tpu_torch.tools.sweep_conf_gate --run RUN \
        --scale tiny [--eval-count 240] [--floor 0.02] [--device cuda|cpu]

One detector pass with the gate lowered to ``--floor``, then the
collected detections re-scored in numpy at each threshold. That is exact
for every t >= floor: greedy per-class NMS keeps a box iff no
higher-scored kept box overlaps it, and raising the gate only removes
boxes below t, whose suppressors (scores at least theirs) survive too, so
{kept at gate t} == {kept at gate floor, score > t}. The one
approximation: the ``max_detections`` output cap can truncate the
floor-gate list where a higher gate would not. Writes RUN/gate_sweep.json:
mAP, recall and detections per threshold.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

THRESHOLDS = (0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.7)


def rescore(detections, gts, class_count: int, floor: float,
            thresholds=THRESHOLDS) -> list:
    """One row per threshold t >= ``floor``: mAP, recall and the count of
    the detections scored above t."""
    from frcnn_tpu_torch.detect.evaluation import compute_map, matched_recall

    rows = []
    for t in thresholds:
        if t < floor:
            continue
        sub = [d for d in detections if d["score"] > t]
        rows.append({"threshold": t,
                     "mAP": compute_map(sub, gts, class_count)["mAP"],
                     "recall": matched_recall(sub, gts),
                     "num_detections": len(sub)})
    return rows


def main(argv=None) -> int:
    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.detect.evaluation import collect_detections
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.tools.train_synthetic_eval import (
        models_of,
        run_config,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--scale", default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-count", type=int, default=240)
    ap.add_argument("--ckpt", default="final.ckpt")
    ap.add_argument("--floor", type=float, default=0.02)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    cfg = run_config(args.run, args.scale, detect_confidence=args.floor)
    manifest = os.path.join(args.run, "dataset", "manifest.json")
    pnet, cnet, _ = models_of(cfg, os.path.join(args.run, args.ckpt))
    det = Detector(cfg, pnet, cnet, device=device)
    detections, gts, n_img = collect_detections(
        det, BatchIterator(cfg, manifest, seed=7),
        max_images=args.eval_count)
    print(f"collected {len(detections)} detections over {n_img} images "
          f"({len(gts)} gt) at gate {args.floor}", flush=True)
    rows = rescore(detections, gts, cfg.class_count, args.floor)
    for r in rows:
        print(f"gate>{r['threshold']:<5} mAP={r['mAP']:.4f} "
              f"recall={r['recall']:.4f} det={r['num_detections']}",
              flush=True)
    out = os.path.join(args.run, "gate_sweep.json")
    with open(out, "w") as f:
        json.dump({"ckpt": args.ckpt, "num_images": n_img,
                   "num_gt": len(gts), "sweep": rows}, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
