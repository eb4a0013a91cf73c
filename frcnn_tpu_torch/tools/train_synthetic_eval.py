"""Accuracy evidence on the card: train on a synthetic duplo-like dataset,
then report mAP and write demo images with drawn boxes (the counterpart
of ``scripts/train_synthetic_eval.py``).

    python -m frcnn_tpu_torch.tools.train_synthetic_eval --scale tiny \\
        --steps 400 --out RUN [--device cuda|cpu]
    python -m frcnn_tpu_torch.tools.train_synthetic_eval --scale duplo \\
        --steps 1500 --out RUN        # vgg_small at 800x450

Outputs in RUN (the JAX script's layout, which ``eval_quant_parity``,
``sweep_conf_gate`` and ``recall_attribution`` read): ``dataset/`` (PNG
scenes, ``boxes.csv``, ``manifest.json``), ``metrics.jsonl``,
``partial.ckpt`` and ``final.ckpt`` (the JAX checkpoint format),
``result.json`` (``evaluate_map`` on the validation split),
``loss_curve.csv`` and ``demo{i}.png`` (detections green over the ground
truth in gray). Scenes are PNG written by ``data/codec.py::write_png``:
the same pixels and CSV rows as the JAX script's PIL-written files.
Training and the final evaluation run the scale's config with the kernels
on (``pallas_mode="on"``: the ROI-pool forward and backward, the pools'
backward, NMS; their plain versions on the CPU), where the JAX script's
XLA path needs none: on the card the plain ROI-pool backward alone takes
about a second per step.

Only the ``tiny`` and ``duplo`` scales are ported. ``photo``,
``imagenet`` and ``imagenet_smoke`` composite photographs taken from the
sample data of matplotlib, scikit-learn or pygame and encode JPEG
(``make_photo_dataset``); the port has neither those photographs nor a
JPEG encoder, so those scales raise ``ValueError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

CLASS_COLORS = [
    (220, 40, 40), (40, 220, 40), (60, 60, 230),
    (230, 230, 40), (230, 40, 230), (40, 230, 230),
]
CLASS_NAMES = ["Red", "Green", "Blue", "Yellow", "Magenta", "Cyan"]
NOT_PORTED = ("photo", "imagenet", "imagenet_smoke")


def _skip_if_generated(out_dir: str, meta: dict):
    """The CSV path when a completed generation with the same arguments is
    on disk (its marker, ``gen_meta.json``, is written after the last file,
    and the last image the CSV names still exists), else None."""
    marker = os.path.join(out_dir, "gen_meta.json")
    csv = os.path.join(out_dir, "boxes.csv")
    if os.path.exists(marker) and os.path.exists(csv):
        try:
            with open(marker) as f:
                if json.load(f) != meta:
                    return None
            with open(csv) as f:
                last = [ln for ln in f if ln.strip()][-1]
            img_name = last.split(",", 1)[0].strip().strip('"')
            if os.path.exists(os.path.join(out_dir, img_name)):
                return csv
        except (ValueError, OSError, IndexError):
            pass
    return None


def make_dataset(out_dir: str, n_images: int, img_w: int, img_h: int,
                 n_classes: int, box_lo: int, box_hi: int, seed: int = 0,
                 max_boxes: int = 3):
    """Duplo-like scenes (``scripts/train_synthetic_eval.py:73-123``):
    1..max_boxes solid colored rectangles (color = class) on a dark noisy
    background, as PNG; CSV rows in the reference importer's schema
    (``create-duplo-traindata.lua:7-46``). Returns the CSV path."""
    from frcnn_tpu_torch.data.codec import write_png

    meta = dict(kind="duplo", n_images=n_images, img_w=img_w, img_h=img_h,
                n_classes=n_classes, box_lo=box_lo, box_hi=box_hi,
                seed=seed, max_boxes=max_boxes)
    done = _skip_if_generated(out_dir, meta)
    if done:
        return done
    rng = np.random.default_rng(seed)
    rows = []
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_images):
        img = rng.integers(18, 42, size=(img_h, img_w, 3)).astype(np.uint8)
        placed = []
        for _ in range(int(rng.integers(1, max_boxes + 1))):
            ci = int(rng.integers(0, n_classes))
            bw = int(rng.integers(box_lo, box_hi))
            bh = int(rng.integers(box_lo, box_hi))
            for _try in range(20):
                x0 = int(rng.integers(0, img_w - bw))
                y0 = int(rng.integers(0, img_h - bh))
                cand = (x0, y0, x0 + bw, y0 + bh)
                if all(cand[2] <= p[0] or cand[0] >= p[2]
                       or cand[3] <= p[1] or cand[1] >= p[3]
                       for p in placed):
                    break
            else:
                continue
            placed.append(cand)
            col = np.asarray(CLASS_COLORS[ci], np.uint8)
            img[y0:y0 + bh, x0:x0 + bw] = col + rng.integers(
                -12, 13, size=(bh, bw, 3)
            ).astype(np.int16).clip(-int(col.min()),
                                    255 - int(col.max())).astype(np.uint8)
            rows.append(
                f'"img{i:04d}.png", {x0}, {y0}, {x0 + bw}, {y0 + bh}, '
                f'"{CLASS_NAMES[ci]}", {ci}, "M", 0'
            )
        write_png(os.path.join(out_dir, f"img{i:04d}.png"), img)
    csv = os.path.join(out_dir, "boxes.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows))
    with open(os.path.join(out_dir, "gen_meta.json"), "w") as f:
        json.dump(meta, f)
    return csv


def tiny_cfg(n_classes: int):
    """``scripts/train_synthetic_eval.py::tiny_cfg``."""
    from frcnn_tpu_torch.config import (
        AnchorNetSpec,
        AugmentationConfig,
        ClassLayerSpec,
        Config,
        LayerSpec,
        ModelConfig,
        StaticShapeConfig,
    )

    model = ModelConfig(
        name="tiny",
        layers=(
            LayerSpec(filters=8, conv_steps=1),
            LayerSpec(filters=16, dropout=0.4, conv_steps=1),
            LayerSpec(filters=24, dropout=0.4, conv_steps=1),
            LayerSpec(filters=32, dropout=0.4, conv_steps=1),
        ),
        anchor_nets=(
            AnchorNetSpec(kW=3, n=32, input=3),
            AnchorNetSpec(kW=3, n=32, input=4),
            AnchorNetSpec(kW=5, n=32, input=4),
            AnchorNetSpec(kW=7, n=32, input=4),
        ),
        class_layers=(
            ClassLayerSpec(n=128, dropout=0.25, batch_norm=True),
            ClassLayerSpec(n=64, dropout=0.25),
        ),
    )
    return Config(
        class_count=n_classes,
        target_smaller_side=128,
        scales=(16, 32, 64, 96),
        max_pixel_size=192,
        augmentation=AugmentationConfig(hflip=0.5, vflip=0.5),
        batch_size=64,
        model=model,
        shapes=StaticShapeConfig(
            image_hw=(128, 160), images_per_step=4, max_gt=4,
            max_positives=32, max_negatives=16, max_nearby=32,
            max_proposals=128, max_detections=32,
        ),
        compute_dtype="float32",
        learning_rate=2e-3,
    )


def duplo_scale_cfg(n_classes: int):
    """``scripts/train_synthetic_eval.py::duplo_scale_cfg``: the duplo
    config at the scenes' exact 800x450, uint8 on the wire."""
    from frcnn_tpu_torch.config import duplo_config

    cfg = duplo_config(class_count=n_classes, learning_rate=1e-4)
    return cfg.replace(
        shapes=dataclasses.replace(cfg.shapes, image_hw=(450, 800)),
        uint8_wire=True,
    )


SCALES = {
    # (img_w, img_h, box_lo, box_hi, n_classes, cfg builder, scene maker)
    "tiny": (200, 160, 48, 80, 3, tiny_cfg, make_dataset),
    "duplo": (800, 450, 48, 220, 6, duplo_scale_cfg, make_dataset),
}


def scale_spec(name: str):
    """(img_w, img_h, box_lo, box_hi, n_classes, cfg_fn, maker) of a
    scale; the scales that are not ported raise ``ValueError``."""
    if name in NOT_PORTED:
        raise ValueError(
            f"scale {name!r} is not ported: it composites photographs from "
            f"the sample data of matplotlib, scikit-learn or pygame and "
            f"encodes JPEG (make_photo_dataset); the port has neither the "
            f"photographs nor a JPEG encoder. Ported: {sorted(SCALES)}")
    if name not in SCALES:
        raise ValueError(f"unknown scale {name!r}; ported: {sorted(SCALES)}")
    return SCALES[name]


def run_config(run: str, scale: str, **overrides):
    """The config of a run directory's scale, reading its dataset."""
    *_, n_classes, cfg_fn, _maker = scale_spec(scale)
    return cfg_fn(n_classes).replace(
        examples_base_path=os.path.join(run, "dataset"), **overrides)


def models_of(cfg, ckpt_path: str):
    """(pnet, cnet, checkpoint): float32 modules of ``cfg`` with the
    weights of a checkpoint in the JAX format, for ``Detector``s."""
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.utils.serialization import load_checkpoint
    from frcnn_tpu_torch.utils.weights import from_jax_params

    ckpt = load_checkpoint(ckpt_path)
    pnet, cnet = models_from_state_dicts(cfg, from_jax_params(
        ckpt["params"], ckpt["batch_stats"], cfg))
    return pnet, cnet, ckpt


def _train(args, cfg, manifest_path, device):
    from frcnn_tpu_torch.data.pipeline import (
        BatchIterator,
        PrefetchingIterator,
    )
    from frcnn_tpu_torch.train.trainer import Trainer

    it = BatchIterator(cfg, manifest_path, seed=args.seed)
    pre = PrefetchingIterator(it, depth=max(2, args.chunk + 2))
    tr = Trainer(cfg, device=device,
                 metrics_path=os.path.join(args.out, "metrics.jsonl"))
    partial = os.path.join(args.out, "partial.ckpt")
    if os.path.exists(partial):
        tr.restore_snapshot(partial)
        print(f"resumed from {partial} at step {tr.step}", flush=True)
    start_step = tr.step
    t0 = time.time()
    last_snap = tr.step
    queues: dict = {}
    try:
        while tr.step < args.steps:
            b = pre.next_training_batch()
            q = queues.setdefault(tuple(b.image.shape[1:3]), [])
            q.append(b)
            full = len(q) >= args.chunk
            tail = args.steps - tr.step < 2 * args.chunk
            if not (full or tail):
                continue
            k = min(len(q), args.steps - tr.step)
            if full and k == args.chunk and args.chunk > 1:
                metrics = tr.run_chunk(q[:k])
            else:
                metrics = [tr.run_step(x) for x in q[:k]]
            del q[:k]
            m = metrics[-1]
            if tr.step % 25 < k or tr.step == k:
                print(f"{tr.step}: loss {m['loss']:.4f} pcls "
                      f"{m['pcls']:.4f} preg {m['preg']:.4f} dcls "
                      f"{m['dcls']:.4f} dreg {m['dreg']:.4f} skip "
                      f"{m['skipped']:.0f} ({time.time() - t0:.0f}s)",
                      flush=True)
            if tr.step - last_snap >= args.snapshot_every:
                tr.save_snapshot(partial)
                last_snap = tr.step
            every = args.named_snapshot_every
            if every and tr.step % every < k:
                named = os.path.join(
                    args.out, f"step_{tr.step - tr.step % every:06d}.ckpt")
                if not os.path.exists(named):
                    tr.save_snapshot(named)
    finally:
        pre.close()
        tr.metrics_logger.close()
    if args.steps >= start_step:
        tr.save_snapshot(os.path.join(args.out, "final.ckpt"))
    else:
        print(f"finalize-only run (step {tr.step} > requested "
              f"{args.steps}); not writing final.ckpt", flush=True)
    return tr


def main(argv=None) -> int:
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.data.importers import create_duplo_manifest
    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.detect.evaluation import evaluate_map
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.ops.color import yuv2rgb
    from frcnn_tpu_torch.utils.drawing import draw_rectangle, save_image

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=[*SCALES, *NOT_PORTED],
                    default="tiny")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--images", type=int, default=60)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-count", type=int, default=24)
    ap.add_argument("--demo-count", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16,
                    help="train steps per metrics copy (run_chunk)")
    ap.add_argument("--snapshot-every", type=int, default=160,
                    help="steps between partial snapshots (resume)")
    ap.add_argument("--named-snapshot-every", type=int, default=0,
                    help="if >0, keep a step-named copy of the snapshot "
                    "every N steps (step_NNNNNN.ckpt)")
    args = ap.parse_args(argv)
    img_w, img_h, box_lo, box_hi, n_classes, cfg_fn, maker = \
        scale_spec(args.scale)
    device = require_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    data_dir = os.path.join(args.out, "dataset")
    csv = maker(data_dir, args.images, img_w, img_h, n_classes, box_lo,
                box_hi, seed=args.seed)
    manifest_path = os.path.join(data_dir, "manifest.json")
    create_duplo_manifest(f"synthetic-{args.scale}", csv, None,
                          manifest_path, validation_size=0.25,
                          seed=args.seed)
    cfg = cfg_fn(n_classes).replace(examples_base_path=data_dir,
                                    seed=args.seed, pallas_mode="on")
    tr = _train(args, cfg, manifest_path, device)

    # the reference's "loss" series is pcls + preg (objective.lua:216)
    st = tr.stats
    losses = [p + r for p, r in zip(st.pcls, st.preg)]
    with open(os.path.join(args.out, "loss_curve.csv"), "w") as f:
        f.write("step,pcls,preg,dcls,dreg,loss\n")
        for i, row in enumerate(zip(st.pcls, st.preg, st.dcls, st.dreg,
                                    losses)):
            f.write(f"{i + 1}," + ",".join(f"{v:.6g}" for v in row) + "\n")

    pnet, cnet = models_from_state_dicts(cfg, tr.state_dicts())
    det = Detector(cfg, pnet, cnet, device=device)
    eval_it = BatchIterator(cfg, manifest_path, seed=args.seed + 1)
    result = evaluate_map(cfg, det, eval_it, max_images=args.eval_count)
    result["scale"] = args.scale
    result["steps"] = tr.step
    result["requested_steps"] = args.steps
    result["final_loss_mean_last25"] = (
        float(np.mean(losses[-25:])) if losses else None)
    result["first_loss_mean_25"] = (
        float(np.mean(losses[:25])) if losses else None)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "per_class"}),
          flush=True)

    # demo images: detections green, ground truth gray (main.lua:183-216)
    demo_it = BatchIterator(cfg, manifest_path, seed=args.seed + 2)
    for i in range(args.demo_count):
        imgs, hws, rois = demo_it.padded_validation_batch(1)
        if imgs.shape[0] == 0:
            break
        out = det.detect(imgs, hws)
        h, w = int(hws[0][0]), int(hws[0][1])
        img = np.asarray(imgs[0][:h, :w]).copy()
        if img.dtype == np.uint8:      # uint8 wire: already RGB
            img = img.astype(np.float32) / 255.0
        elif cfg.color_space == "yuv":
            img = yuv2rgb(img)
        for roi in rois[0]:
            draw_rectangle(img, roi["rect"], (0.45, 0.45, 0.45))
        valid = out.valid[0].cpu().numpy()
        for b in out.boxes[0].cpu().numpy()[valid]:
            draw_rectangle(img, b, (0.0, 1.0, 0.0))
        save_image(img, os.path.join(args.out, f"demo{i + 1}.png"))
    print(f"wrote {args.out}/result.json and demo images", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
