"""Serving-mode accuracy parity on the card: one trained checkpoint under
each serving configuration, mAP and detections compared (the counterpart
of ``scripts/eval_quant_parity.py``).

    python -m frcnn_tpu_torch.tools.eval_quant_parity --run RUN \
        --scale tiny [--eval-count 24] [--modes ...] [--device cuda|cpu]

RUN is a ``train_synthetic_eval`` output directory (``dataset/`` and the
checkpoint, ``--ckpt``: a file name inside RUN or a path). The four
headline modes are ``bf16``, ``int8_dynamic``, ``int8_static`` and
``int8_static_s2d``; the bisection modes flip one change at a time:
``bf16_pallas`` (the NMS and ROI-pool kernels), ``bf16_pallas_s2d`` (+ the
space-to-depth block0 kernel), ``int8_static_pallas`` and
``int8_static_s2d_s8p`` (the s8-pooled chain with block0's int8 output).
Static scales are calibrated on ``--calib-count`` normalized validation
images. Writes RUN/quant_parity.json (``--out``): each mode's mAP,
detections, ground-truth count, and its mAP less bf16's, and for every
mode but bf16 the share of bf16's detections it matches and of its own
that bf16 matches (same image and class, IoU >= 0.5). ``--detections
FILE`` also writes each mode's detections per image (``record``), which
``match_detections`` holds against another reading of the same scenes
(``python -m tests.photo_reading --compare``: the JAX package's).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

HEADLINE = ("bf16", "int8_dynamic", "int8_static", "int8_static_s2d")


def mode_table(cfg, calib) -> dict:
    """{mode: (config, Detector keyword arguments)}
    (``scripts/eval_quant_parity.py:95-118``). The kernels are on in the
    ``pallas`` and ``s2d`` modes (``pallas_mode="on"``; their plain
    versions on CPU tensors)."""
    pcfg = cfg.replace(pallas_mode="on")
    scfg = pcfg.replace(input_layout="s2d")
    static = dict(quantized=True, quant_calibration=calib)
    return {
        "bf16": (cfg, {}),
        "bf16_pallas": (pcfg, {}),
        "bf16_pallas_s2d": (scfg, {}),
        "int8_dynamic": (cfg, dict(quantized=True)),
        "int8_static": (cfg, static),
        "int8_static_pallas": (pcfg, static),
        "int8_static_s2d": (scfg, static),
        "int8_static_s2d_s8p": (scfg.replace(quant_pool_s8=True), static),
    }


def calibration_batch(cfg, manifest: str, count: int, device):
    """``count`` NORMALIZED validation images (the detect program
    normalizes before the backbone) on ``device``, in the config's color
    space as the detect program takes them. Under ``uint8_wire`` the JAX
    script normalizes the wire's RGB bytes themselves
    (``scripts/eval_quant_parity.py:78-85``), so its static scales belong
    to other inputs than the program's; this does not copy that."""
    import torch

    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.ops.color import unwire_uint8
    from frcnn_tpu_torch.ops.normalization import normalize_image

    imgs, hws, _ = BatchIterator(cfg, manifest, seed=123
                                 ).padded_validation_batch(count)
    n = cfg.normalization
    x = unwire_uint8(imgs.to(device), cfg.color_space).float()
    hws = hws.to(device)
    with torch.no_grad():
        return normalize_image(x, hws[:, 0], hws[:, 1], method=n.method,
                               width=n.width, centering=n.centering,
                               scaling=n.scaling)


class Recorder:
    """A detector that keeps each ``detect`` call's outputs and the
    digests of its host frames, so that one ``evaluate_map`` pass also
    gives the detections per image."""

    def __init__(self, det):
        self.det, self.batches = det, []

    def detect(self, images, true_hw):
        out = self.det.detect(images, true_hw)
        self.batches.append(([digest(x) for x in np.asarray(images)], out))
        return out


def record(recorder: Recorder, num_images: int, batch: int = 8) -> list:
    """Per image of an ``evaluate_map`` pass through ``recorder`` (which
    pads a short last batch): the SHA-1 of its pixels (first 16 hex
    digits; the same scene decoded by both packages gives the same digest)
    and its detections as [class, confidence, fg_score, x0, y0, x1, y1]."""
    def host(x):      # a tensor, or any array (the JAX package's outputs)
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else x
        return np.asarray(x, np.float64)

    images = []
    for digests, out in recorder.batches:
        valid = host(out.valid) > 0
        cols = [host(out.classes), host(out.confidence), host(out.fg_score)]
        boxes = host(out.boxes)
        for b in range(min(batch, num_images - len(images))):
            k = np.nonzero(valid[b])[0]
            rows = np.concatenate([np.stack([c[b, k] for c in cols], -1),
                                   boxes[b, k]], -1)
            images.append({"digest": digests[b], "dets": rows.tolist()})
    return images


def digest(image) -> str:
    """The first 16 hex digits of the SHA-1 of an image's bytes."""
    return hashlib.sha1(np.ascontiguousarray(image).tobytes()
                        ).hexdigest()[:16]


def iou(a, b):
    """IoU of numpy boxes [N, 4] x [M, 4] (``geometry/boxes.py::
    iou_matrix``)."""
    import torch

    from frcnn_tpu_torch.geometry.boxes import iou_matrix

    return iou_matrix(torch.from_numpy(np.asarray(a, np.float64)),
                      torch.from_numpy(np.asarray(b, np.float64))).numpy()


def match_detections(a: list, b: list, iou_min: float = 0.5) -> dict:
    """Detections of two runs over the same images (``record``'s lists)
    matched per image by class at IoU >= ``iou_min``, in both directions:
    {"a": hits of a's in b, "b": ..., "n_a", "n_b", "misses": [(side,
    image, class, confidence, fg_score, best same-class IoU, best
    any-class IoU)]}. Images must carry the same digests."""
    hits = {"a": 0, "b": 0}
    n = {"a": 0, "b": 0}
    misses = []
    if [x["digest"] for x in a] != [x["digest"] for x in b]:
        raise ValueError("the two runs scored different images")
    for i, (ia, ib) in enumerate(zip(a, b)):
        da = np.asarray(ia["dets"], np.float64).reshape(-1, 7)
        db = np.asarray(ib["dets"], np.float64).reshape(-1, 7)
        for side, x, y in (("a", da, db), ("b", db, da)):
            n[side] += len(x)
            if not len(x):
                continue
            ious = (iou(x[:, 3:], y[:, 3:]) if len(y)
                    else np.zeros((len(x), 0)))
            same = x[:, None, 0] == y[None, :, 0] if len(y) else ious > 0
            ok = ((ious >= iou_min) & same).any(1)
            hits[side] += int(ok.sum())
            for k in np.nonzero(~ok)[0]:
                misses.append((side, i, int(x[k, 0]), float(x[k, 1]),
                               float(x[k, 2]),
                               float((ious[k] * same[k]).max(initial=0)),
                               float(ious[k].max(initial=0))))
    return {"a": hits["a"], "b": hits["b"], "n_a": n["a"], "n_b": n["b"],
            "misses": misses}


def share_text(m: dict) -> str:
    """``match_detections``' shares as text."""
    sa = m["a"] / m["n_a"] if m["n_a"] else 1.0
    sb = m["b"] / m["n_b"] if m["n_b"] else 1.0
    return (f"{m['a']}/{m['n_a']} = {sa:.4f} and {m['b']}/{m['n_b']} = "
            f"{sb:.4f}")


def main(argv=None) -> int:
    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.detect.evaluation import evaluate_map
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.tools.train_synthetic_eval import (
        models_of,
        run_config,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True,
                    help="output directory of train_synthetic_eval")
    ap.add_argument("--scale", default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-count", type=int, default=24)
    ap.add_argument("--calib-count", type=int, default=8)
    ap.add_argument("--modes", default=None,
                    help="comma list; default: the four headline modes")
    ap.add_argument("--ckpt", default="final.ckpt")
    ap.add_argument("--out", default="quant_parity.json")
    ap.add_argument("--detections", default=None,
                    help="also write each mode's detections per image here")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    cfg = run_config(args.run, args.scale)
    manifest = os.path.join(args.run, "dataset", "manifest.json")
    calib = calibration_batch(cfg, manifest, args.calib_count, device)
    modes = mode_table(cfg, calib)
    selected = args.modes.split(",") if args.modes else list(HEADLINE)
    bad = [m for m in selected if m not in modes]
    if bad:
        raise SystemExit(f"unknown modes {bad}; modes: {sorted(modes)}")

    results, per_image = {}, {}
    pnet, cnet, ckpt = models_of(cfg, os.path.join(args.run, args.ckpt))
    for name in selected:
        mcfg, kw = modes[name]
        det = Recorder(Detector(mcfg, pnet, cnet, device=device, **kw))
        it = BatchIterator(cfg, manifest, seed=7)
        r = evaluate_map(cfg, det, it, max_images=args.eval_count)
        results[name] = {"mAP": r["mAP"],
                         "num_detections": r["num_detections"],
                         "num_gt": r["num_gt"]}
        per_image[name] = record(det, r["num_images"])
        print(f"{name:16s} mAP={r['mAP']:.4f} "
              f"det={r['num_detections']}/{r['num_gt']}", flush=True)
    if "bf16" in results:
        base = results["bf16"]["mAP"]
        for name, r in results.items():
            r["mAP_delta_vs_bf16"] = r["mAP"] - base
            if name != "bf16":
                m = match_detections(per_image["bf16"], per_image[name])
                r["matched_bf16"] = [m["a"], m["n_a"]]
                r["matched_by_bf16"] = [m["b"], m["n_b"]]
                print(f"{name:16s} matches bf16's detections: "
                      f"{share_text(m)}", flush=True)
    results["_ckpt"] = args.ckpt
    if "step" in ckpt:
        results["_step"] = int(ckpt["step"])
    out = os.path.join(args.run, args.out)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}", flush=True)
    if args.detections:
        with open(args.detections, "w") as f:
            json.dump({k: {**results[k], "images": v}
                       for k, v in per_image.items()}, f)
        print(f"wrote {args.detections}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
