"""Accuracy evidence on the card: train on a synthetic duplo-like dataset,
then report mAP and write demo images with drawn boxes (the counterpart
of ``scripts/train_synthetic_eval.py``).

    python -m frcnn_tpu_torch.tools.train_synthetic_eval --scale tiny \\
        --steps 400 --out RUN [--device cuda|cpu]
    python -m frcnn_tpu_torch.tools.train_synthetic_eval --scale duplo \\
        --steps 1500 --out RUN        # vgg_small at 800x450
    python -m frcnn_tpu_torch.tools.train_synthetic_eval --scale photo \\
        --out RUN     # photo backgrounds; also imagenet (vgg_large, both
                      # buckets) and imagenet_smoke (the same cut 3x)

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

The ``photo``, ``imagenet`` and ``imagenet_smoke`` scales composite
shaded bricks over crops of real photographs (``make_photo_dataset``):
the three of ``tools/photos/`` (``SOURCES.md``: matplotlib's and
scikit-learn's sample photographs, in the JAX script's order; the JAX
script also finds pygame's where pygame is installed). The numpy draws are
the JAX function's, in its order, so boxes and CSV rows are equal; PIL's
steps are numpy ones, each bitwise PIL's: the crop's resize is Pillow's
8-bit bilinear (``data/pipeline.py::resize_uint8``), the blur its
box-blur Gaussian (``gaussian_blur``), and the JPEG save and load
``data/codec.py::jpeg_roundtrip`` in memory (libjpeg's color conversion,
4:2:0 sampling, quantization tables and integer DCTs), after which the
scene is written as a lossless PNG. So the files are ``img{i}.png`` where
the JAX script writes ``.jpg``, with the same pixels as PIL reads from
those, compression artefacts included.
The first ``n_corrupt`` files hold the JAX script's corrupt bytes.

Training spreads over every local card, as the JAX script's ``Trainer``
spreads over every local device: over the largest count, up to
``--devices``, that divides ``images_per_step``, one process each
(``parallel/mesh.py::launch``; or one rank each under ``torchrun``).
Rank 0 alone writes the dataset, prints, writes the snapshots and
evaluates.
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
PHOTO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "photos")
# sorted by their source paths (matplotlib's, then scikit-learn's)
PHOTOS = ("grace_hopper.png", "china.png", "flower.png")
CORRUPT_BYTES = b"\xff\xd8\xffnot-actually-a-jpeg"


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


def _bundled_photos():
    """The background photographs of ``tools/photos/`` as RGB uint8
    arrays, in the JAX ``_bundled_photos``'s order."""
    from frcnn_tpu_torch.data.codec import read_rgb

    return [read_rgb(os.path.join(PHOTO_DIR, n), use_native=False)
            for n in PHOTOS]


def _draw_brick(img, rng, x0, y0, bw, bh, color):
    """Composite one shaded toy-brick onto ``img`` in place: drop shadow,
    directional-gradient body, lighter top face, studs, sensor noise
    (``scripts/train_synthetic_eval.py::_draw_brick``, the same draws)."""
    h, w = img.shape[:2]
    sx0, sy0 = min(x0 + 6, w), min(y0 + 7, h)
    sx1, sy1 = min(x0 + bw + 9, w), min(y0 + bh + 10, h)
    if sx1 > sx0 and sy1 > sy0:
        sh = img[sy0:sy1, sx0:sx1].astype(np.float32)
        img[sy0:sy1, sx0:sx1] = (sh * 0.62).astype(np.uint8)
    body = np.broadcast_to(
        np.asarray(color, np.float32), (bh, bw, 3)).copy()
    yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    g = (np.cos(ang) * xx / max(bw, 1) + np.sin(ang) * yy / max(bh, 1))
    g = (g - g.min()) / max(g.max() - g.min(), 1e-6)
    body *= (0.62 + 0.43 * g)[:, :, None]
    top_h = max(2, int(bh * rng.uniform(0.12, 0.22)))
    body[:top_h] = np.minimum(body[:top_h] * 1.45 + 18, 255)
    n_studs = max(1, bw // 44)
    r = max(2, int(min(bw, bh) * 0.10))
    cy = top_h // 2
    for k in range(n_studs):
        cx = int((k + 0.5) * bw / n_studs)
        y_lo, y_hi = max(cy - r, 0), min(cy + r, bh)
        x_lo, x_hi = max(cx - r, 0), min(cx + r, bw)
        if y_hi > y_lo and x_hi > x_lo:
            dy = np.arange(y_lo, y_hi)[:, None] - cy
            dx = np.arange(x_lo, x_hi)[None, :] - cx
            disk = (dy * dy + dx * dx) <= r * r
            patch = body[y_lo:y_hi, x_lo:x_hi]
            patch[disk] = np.minimum(patch[disk] * 1.25 + 25, 255)
    body[0], body[-1] = body[0] * 0.55, body[-1] * 0.55
    body[:, 0], body[:, -1] = body[:, 0] * 0.55, body[:, -1] * 0.55
    body += rng.normal(0, 6, body.shape)
    img[y0:y0 + bh, x0:x0 + bw] = body.clip(0, 255).astype(np.uint8)


def make_photo_dataset(out_dir: str, n_images: int, img_w: int, img_h: int,
                       n_classes: int, box_lo: int, box_hi: int,
                       seed: int = 0, max_boxes: int = 4,
                       n_corrupt: int = 2, mixed_orientation: bool = False):
    """Photo-composited scenes (``scripts/train_synthetic_eval.py::
    make_photo_dataset``): shaded bricks (color = class, partial
    occlusion up to IoU 0.25) over crops of real photographs, degraded as
    a camera would (blur, sensor noise, a JPEG round trip at a random
    quality 55-94), written as PNG; the first ``n_corrupt`` files are
    corrupt and stay in the CSV (the batch iterator skips and logs them).
    ``mixed_orientation`` swaps width and height for about half the scenes
    (both imagenet buckets). Without photographs (:func:`_bundled_photos`
    empty) the backgrounds are the JAX function's textured fallback.
    Returns the CSV path."""
    from frcnn_tpu_torch.data.codec import jpeg_roundtrip, write_png
    from frcnn_tpu_torch.data.pipeline import gaussian_blur, resize_uint8

    meta = dict(kind="photo", n_images=n_images, img_w=img_w, img_h=img_h,
                n_classes=n_classes, box_lo=box_lo, box_hi=box_hi,
                seed=seed, max_boxes=max_boxes, n_corrupt=n_corrupt,
                mixed_orientation=mixed_orientation)
    done = _skip_if_generated(out_dir, meta)
    if done:
        return done
    backgrounds = _bundled_photos()
    rng = np.random.default_rng(seed)
    rows = []
    os.makedirs(out_dir, exist_ok=True)
    base_wh = (img_w, img_h)
    for i in range(n_images):
        if mixed_orientation:
            img_w, img_h = base_wh if rng.random() < 0.5 else base_wh[::-1]
        if backgrounds:
            bg = backgrounds[int(rng.integers(0, len(backgrounds)))]
            bh0, bw0 = bg.shape[:2]
            # random crop with the target aspect, then resize
            frac = rng.uniform(0.5, 1.0)
            cw = max(int(bw0 * frac), 64)
            ch = max(min(int(cw * img_h / img_w), bh0), 48)
            cw = min(int(ch * img_w / img_h), bw0)
            cx = int(rng.integers(0, bw0 - cw + 1))
            cy = int(rng.integers(0, bh0 - ch + 1))
            img = resize_uint8(bg[cy:cy + ch, cx:cx + cw], img_w,
                               img_h).astype(np.float32)
            if rng.random() < 0.5:
                img = img[:, ::-1]
            img *= rng.uniform(0.55, 1.05)        # global illumination
            img += rng.normal(0, 10, 3)           # color cast
            img = img.clip(0, 255).astype(np.uint8)
        else:       # no photographs: the textured fallback
            base = rng.integers(30, 120, size=(img_h // 8, img_w // 8, 3))
            img = resize_uint8(base.astype(np.uint8), img_w, img_h)
        placed = []
        for _ in range(int(rng.integers(1, max_boxes + 1))):
            ci = int(rng.integers(0, n_classes))
            bw = int(rng.integers(box_lo, box_hi))
            bh = int(rng.integers(box_lo, box_hi))
            for _try in range(20):
                x0 = int(rng.integers(0, img_w - bw))
                y0 = int(rng.integers(0, img_h - bh))
                cand = (x0, y0, x0 + bw, y0 + bh)
                # partial occlusion allowed: reject only IoU >= 0.25
                ok = True
                for p in placed:
                    ix = max(0, min(cand[2], p[2]) - max(cand[0], p[0]))
                    iy = max(0, min(cand[3], p[3]) - max(cand[1], p[1]))
                    inter = ix * iy
                    union = bw * bh + (p[2] - p[0]) * (p[3] - p[1]) - inter
                    if inter / union >= 0.25:
                        ok = False
                        break
                if ok:
                    break
            else:
                continue
            placed.append(cand)
            _draw_brick(img, rng, x0, y0, bw, bh, CLASS_COLORS[ci])
            rows.append(
                f'"img{i:04d}.png", {x0}, {y0}, {x0 + bw}, {y0 + bh}, '
                f'"{CLASS_NAMES[ci]}", {ci}, "M", 0'
            )
        # camera-pipeline degradation
        blur = rng.uniform(0.0, 1.0)
        if blur > 0.25:
            img = gaussian_blur(img, blur)
        img = img.astype(np.float32)
        img += rng.normal(0, rng.uniform(1.0, 5.0), img.shape)
        write_png(os.path.join(out_dir, f"img{i:04d}.png"), jpeg_roundtrip(
            img.clip(0, 255).astype(np.uint8), int(rng.integers(55, 95))))
    for i in range(min(n_corrupt, n_images)):
        with open(os.path.join(out_dir, f"img{i:04d}.png"), "wb") as f:
            f.write(CORRUPT_BYTES)
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


def imagenet_scale_cfg(n_classes: int):
    """``scripts/train_synthetic_eval.py::imagenet_scale_cfg``: the
    reference imagenet experiment's envelope (vgg_large, 480 px smaller
    side, the 480x1000 and 1000x480 buckets, thresholds 0.6/0.25), the
    class count the synthetic dataset's."""
    from frcnn_tpu_torch.config import imagenet_config

    return imagenet_config(
        class_count=n_classes, learning_rate=1e-4, uint8_wire=True)


def _make_imagenet_dataset(out_dir, n_images, img_w, img_h, n_classes,
                           box_lo, box_hi, seed=0):
    return make_photo_dataset(out_dir, n_images, img_w, img_h, n_classes,
                              box_lo, box_hi, seed=seed,
                              mixed_orientation=True)


def imagenet_smoke_cfg(n_classes: int):
    """``scripts/train_synthetic_eval.py::imagenet_smoke_cfg``: the
    imagenet scale's model family, dual buckets and thresholds, with the
    envelope cut 3x (160x320 and 320x160, 2 images a step)."""
    from frcnn_tpu_torch.config import imagenet_config

    cfg = imagenet_config(
        class_count=n_classes, learning_rate=1e-4, uint8_wire=True,
        target_smaller_side=160, max_pixel_size=320,
        scales=(24, 48, 96, 192),
    )
    return cfg.replace(shapes=dataclasses.replace(
        cfg.shapes, image_hw=(160, 320), portrait_hw=(320, 160),
        images_per_step=2))


SCALES = {
    # (img_w, img_h, box_lo, box_hi, n_classes, cfg builder, scene maker)
    "tiny": (200, 160, 48, 80, 3, tiny_cfg, make_dataset),
    "duplo": (800, 450, 48, 220, 6, duplo_scale_cfg, make_dataset),
    # photo backgrounds + shaded bricks + JPEG degradation, duplo's scale
    "photo": (800, 450, 48, 220, 6, duplo_scale_cfg, make_photo_dataset),
    # vgg_large at the imagenet envelope, portrait and landscape mixed
    "imagenet": (1000, 480, 60, 380, 6, imagenet_scale_cfg,
                 _make_imagenet_dataset),
    # the imagenet scale cut 3x
    "imagenet_smoke": (320, 160, 24, 100, 3, imagenet_smoke_cfg,
                       _make_imagenet_dataset),
}


def scale_spec(name: str):
    """(img_w, img_h, box_lo, box_hi, n_classes, cfg_fn, maker) of a
    scale; an unknown name raises ``ValueError``."""
    if name not in SCALES:
        raise ValueError(f"unknown scale {name!r}; known: {sorted(SCALES)}")
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


def _train(args, cfg, manifest_path, device, threads: int = 0,
           shard=None):
    """Trains ``cfg`` to ``args.steps``, resuming from ``partial.ckpt``;
    data-parallel, this process's ``shard`` of every whole batch, and only
    rank 0 prints and writes."""
    from frcnn_tpu_torch.data.pipeline import (
        BatchIterator,
        PrefetchingIterator,
    )
    from frcnn_tpu_torch.train.trainer import Trainer

    lead = shard is None or shard.rank == 0
    it = BatchIterator(cfg, manifest_path, seed=args.seed,
                       num_threads=threads)
    pre = PrefetchingIterator(it, depth=max(2, args.chunk + 2))
    tr = Trainer(cfg, device=device, shard=shard,
                 metrics_path=os.path.join(args.out, "metrics.jsonl")
                 if lead else None)
    partial = os.path.join(args.out, "partial.ckpt")
    if os.path.exists(partial):
        tr.restore_snapshot(partial)
        if lead:
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
            if lead and (tr.step % 25 < k or tr.step == k):
                print(f"{tr.step}: loss {m['loss']:.4f} pcls "
                      f"{m['pcls']:.4f} preg {m['preg']:.4f} dcls "
                      f"{m['dcls']:.4f} dreg {m['dreg']:.4f} skip "
                      f"{m['skipped']:.0f} ({time.time() - t0:.0f}s)",
                      flush=True)
            if tr.step - last_snap >= args.snapshot_every:
                if lead:
                    tr.save_snapshot(partial)
                last_snap = tr.step
            every = args.named_snapshot_every
            if lead and every and tr.step % every < k:
                named = os.path.join(
                    args.out, f"step_{tr.step - tr.step % every:06d}.ckpt")
                if not os.path.exists(named):
                    tr.save_snapshot(named)
    finally:
        pre.close()
        tr.metrics_logger.close()
    if not lead:
        return tr
    if args.steps >= start_step:
        tr.save_snapshot(os.path.join(args.out, "final.ckpt"))
    else:
        print(f"finalize-only run (step {tr.step} > requested "
              f"{args.steps}); not writing final.ckpt", flush=True)
    return tr


def _make_data(args) -> None:
    """The scale's scenes, CSV and manifest under ``RUN/dataset``."""
    from frcnn_tpu_torch.data.importers import create_duplo_manifest

    img_w, img_h, box_lo, box_hi, n_classes, _cfg_fn, maker = \
        scale_spec(args.scale)
    os.makedirs(args.out, exist_ok=True)
    data_dir = os.path.join(args.out, "dataset")
    csv = maker(data_dir, args.images, img_w, img_h, n_classes, box_lo,
                box_hi, seed=args.seed)
    create_duplo_manifest(f"synthetic-{args.scale}", csv, None,
                          os.path.join(data_dir, "manifest.json"),
                          validation_size=0.25, seed=args.seed)


def _run_rank(args, device_type: str) -> int:
    """One rank of a data-parallel run (``torchrun`` or
    ``parallel/mesh.py::launch``): rank 0 writes the dataset while the
    others wait, every rank trains its rows, rank 0 evaluates."""
    import torch.distributed as dist

    from frcnn_tpu_torch.parallel import mesh

    with mesh.rank_group(device_type) as device:
        shard = mesh.batch_shard()
        if shard.rank == 0:
            _make_data(args)
        dist.barrier()
        return _run(args, device, mesh.host_threads(), shard)


def main(argv=None) -> int:
    from frcnn_tpu_torch.cli import device_count, in_rank, require_device
    from frcnn_tpu_torch.parallel.mesh import data_parallel_size, launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=list(SCALES), default="tiny")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--images", type=int, default=60)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="at most this many local devices, one process "
                    "each (default: every visible card; 1 on the CPU)")
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
    *_, n_classes, cfg_fn, _maker = scale_spec(args.scale)
    device = require_device(args.device)
    if in_rank():
        return _run_rank(args, device.type)
    world = data_parallel_size(device_count(device, args.devices),
                               cfg_fn(n_classes).shapes.images_per_step)
    if world > 1:
        launch(_run_rank, world, device.type, args, device.type)
        return 0
    _make_data(args)
    return _run(args, device)


def _run(args, device, threads: int = 0, shard=None) -> int:
    """Trains, then (rank 0 alone) evaluates and writes the loss curve,
    ``result.json`` and the demo images."""
    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.detect.evaluation import evaluate_map
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.ops.color import yuv2rgb
    from frcnn_tpu_torch.utils.drawing import draw_rectangle, save_image

    *_, n_classes, cfg_fn, _maker = scale_spec(args.scale)
    data_dir = os.path.join(args.out, "dataset")
    manifest_path = os.path.join(data_dir, "manifest.json")
    cfg = cfg_fn(n_classes).replace(examples_base_path=data_dir,
                                    seed=args.seed, pallas_mode="on")
    tr = _train(args, cfg, manifest_path, device, threads, shard)
    if shard is not None and shard.rank != 0:
        return 0

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
