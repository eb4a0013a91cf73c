"""Attribute end-to-end recall loss to stage 1 (fg gate, proposal NMS,
caps) or stage 2 (classifier, confidence gate) on the card (the
counterpart of ``scripts/recall_attribution.py``).

    python -m frcnn_tpu_torch.tools.recall_attribution --run RUN \
        --scale tiny [--eval-count 240] [--fg 0.5,0.8,0.9,0.95] \
        [--device cuda|cpu]

For each stage-1 gate P(fg) > fg (``Detector.lua:54``: 0.95), ONE
detector pass with the final gate lowered to ``--floor`` collects the
final detections and every stage-1 NMS survivor
(``DetectionResult.proposals``), and reports ``proposal_recall`` (ground
truth covered by any survivor at IoU 0.5, class-agnostic) against the
detection recall and mAP at the confidence gates (re-scored in numpy,
exact for gates >= floor: see ``sweep_conf_gate``), and the distribution
of survivors per image against the ``max_detections`` cap. Writes
RUN/recall_attribution.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

CONF_GATES = (0.05, 0.1, 0.2)


def attribution_row(fg: float, detections, gts, n_img: int, proposals,
                    cap: int, class_count: int, floor: float) -> dict:
    """One fg gate's row (``scripts/recall_attribution.py:92-120``)."""
    from frcnn_tpu_torch.detect.evaluation import (
        compute_map,
        matched_recall,
        proposal_coverage,
    )

    cov = proposal_coverage(proposals, gts)
    counts = np.array([len(v) for v in proposals.values()])
    row = {
        "fg_threshold": fg,
        "num_images": n_img,
        "num_gt": len(gts),
        "proposal_recall": cov["proposal_recall"],
        "gt_covered_by_proposals": cov["num_covered"],
        "proposals_per_image": {
            "mean": float(counts.mean()) if len(counts) else 0.0,
            "max": int(counts.max()) if len(counts) else 0,
            "cap": int(cap),
            "at_cap": int((counts >= cap).sum()),
        },
        "by_conf_gate": {},
    }
    for t in CONF_GATES:
        if t < floor:
            continue
        sub = [d for d in detections if d["score"] > t]
        row["by_conf_gate"][str(t)] = {
            "mAP": compute_map(sub, gts, class_count)["mAP"],
            "detection_recall": matched_recall(sub, gts),
            "num_detections": len(sub),
        }
    return row


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
    ap.add_argument("--fg", default="0.5,0.8,0.9,0.95",
                    help="comma list of stage-1 P(fg) gates (0.95 = the "
                    "reference's)")
    ap.add_argument("--out", default="recall_attribution.json")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    base = run_config(args.run, args.scale, detect_confidence=args.floor)
    manifest = os.path.join(args.run, "dataset", "manifest.json")
    pnet, cnet, _ = models_of(base, os.path.join(args.run, args.ckpt))
    rows = []
    for fg in (float(t) for t in args.fg.split(",")):
        cfg = base.replace(detect_fg_threshold=fg)
        det = Detector(cfg, pnet, cnet, device=device)
        detections, gts, n_img, proposals = collect_detections(
            det, BatchIterator(cfg, manifest, seed=7),
            max_images=args.eval_count, with_proposals=True)
        row = attribution_row(fg, detections, gts, n_img, proposals,
                              cfg.shapes.max_detections, cfg.class_count,
                              args.floor)
        rows.append(row)
        ref = row["by_conf_gate"].get("0.2", {})
        pp = row["proposals_per_image"]
        print(f"fg>{fg:<5} proposal_recall={row['proposal_recall']:.4f} "
              f"(covered {row['gt_covered_by_proposals']}/{len(gts)}; "
              f"mean {pp['mean']:.1f} props/img, {pp['at_cap']} imgs at "
              f"cap) | @conf0.2 recall="
              f"{ref.get('detection_recall', float('nan')):.4f} "
              f"mAP={ref.get('mAP', float('nan')):.4f}", flush=True)
    out = os.path.join(args.run, args.out)
    with open(out, "w") as f:
        json.dump({"ckpt": args.ckpt, "floor": args.floor, "rows": rows},
                  f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
