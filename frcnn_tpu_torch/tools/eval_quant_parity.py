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
detections, ground-truth count, and its mAP less bf16's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    normalizes before the backbone) on ``device``."""
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

    results = {}
    pnet, cnet, ckpt = models_of(cfg, os.path.join(args.run, args.ckpt))
    for name in selected:
        mcfg, kw = modes[name]
        det = Detector(mcfg, pnet, cnet, device=device, **kw)
        it = BatchIterator(cfg, manifest, seed=7)
        r = evaluate_map(cfg, det, it, max_images=args.eval_count)
        results[name] = {"mAP": r["mAP"],
                         "num_detections": r["num_detections"],
                         "num_gt": r["num_gt"]}
        print(f"{name:16s} mAP={r['mAP']:.4f} "
              f"det={r['num_detections']}/{r['num_gt']}", flush=True)
    if "bf16" in results:
        base = results["bf16"]["mAP"]
        for r in results.values():
            r["mAP_delta_vs_bf16"] = r["mAP"] - base
    results["_ckpt"] = args.ckpt
    if "step" in ckpt:
        results["_step"] = int(ckpt["step"])
    out = os.path.join(args.run, args.out)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
