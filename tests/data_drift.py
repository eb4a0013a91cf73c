"""How far the float32 detect through the kernels and through the plain
versions lie apart as ``chip_smoke.py``'s ``[data]`` trainer takes its
steps: the same seeded 1280x720 frames, the same bf16 Trainer from
files, and after each step the trainer's weights in two float32 serving
Detectors (kernels, ``pallas_mode="off"``) on the same 16 validation
images. On one CUDA card:

    python -m tests.data_drift [--steps 6]

Prints one line per step: stage-1 proposals and detections, whether the
valid sets are equal, the largest absolute and relative (over the
coordinate's magnitude, at least 1 px) difference of matched boxes, the
box that carries the largest absolute one, and the largest confidence
difference; then the steps' numbers as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _gap(a, b, valid):
    """(largest |a - b|, largest |a - b| / max(|a|, 1), the entry of ``a``
    at the first) over the rows of ``valid``."""
    x, y = a[valid].double(), b[valid].double()
    if x.numel() == 0:
        return 0.0, 0.0, None
    d = (x - y).abs()
    rel = d / x.abs().clamp(min=1.0)
    k = int(d.reshape(d.shape[0], -1).amax(1).argmax())
    return float(d.max()), float(rel.max()), x[k].tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from frcnn_tpu_torch.config import serving_config
    from frcnn_tpu_torch.data.pipeline import (
        BatchIterator,
        PrefetchingIterator,
    )
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.train.trainer import Trainer

    S.phase_build()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        manifest = S._write_dataset(root)
        cfg = S._train_config("bfloat16").replace(
            examples_base_path=str(root),
            background_base_path=str(root / "bg"))
        serve = serving_config(cfg).replace(detect_fg_threshold=0.5,
                                            compute_dtype="float32")
        it = BatchIterator(serve, str(manifest), seed=0)
        batches = [it.padded_validation_batch(8) for _ in range(2)]
        trainer = Trainer(cfg, device="cuda", seed=0)
        pre = PrefetchingIterator(BatchIterator(cfg, str(manifest), seed=2))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for step in range(1, args.steps + 1):
                trainer.run_step(pre.next_training_batch())
                pnet, cnet = models_from_state_dicts(serve,
                                                     trainer.state_dicts())
                dets = [Detector(c, pnet, cnet, device="cuda") for c in (
                    serve, serve.replace(pallas_mode="off"))]
                row = {"step": step, "proposals": 0, "detections": 0,
                       "valid_equal": True, "box_abs": 0.0, "box_rel": 0.0,
                       "worst_box": None, "confidence": 0.0}
                for imgs, hws, _ in batches:
                    k, p = (d.detect(torch.as_tensor(imgs),
                                     torch.as_tensor(hws)) for d in dets)
                    pv = k.proposals_valid & p.proposals_valid
                    dv = k.valid & p.valid
                    row["valid_equal"] &= bool(
                        torch.equal(k.proposals_valid, p.proposals_valid)
                        and torch.equal(k.valid, p.valid)
                        and torch.equal(k.classes[dv], p.classes[dv]))
                    row["proposals"] += int(k.proposals_valid.sum())
                    row["detections"] += int(k.valid.sum())
                    for a, b, v in ((k.proposals, p.proposals, pv),
                                    (k.boxes, p.boxes, dv)):
                        ab, rel, box = _gap(a, b, v)
                        if ab > row["box_abs"]:
                            row["box_abs"], row["worst_box"] = ab, box
                        row["box_rel"] = max(row["box_rel"], rel)
                    row["confidence"] = max(row["confidence"], _gap(
                        k.confidence, p.confidence, dv)[0])
                rows.append(row)
                print(f"[drift] step {step}: {row['proposals']} proposals, "
                      f"{row['detections']} detections, valid sets "
                      f"{'equal' if row['valid_equal'] else 'DIFFER'}; "
                      f"boxes {row['box_abs']:.3g} px apart at most "
                      f"({row['box_rel']:.3g} of the coordinate; worst "
                      f"box {row['worst_box']}), confidence "
                      f"{row['confidence']:.3g}", flush=True)
        finally:
            pre.close()
    print(json.dumps({"drift": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
