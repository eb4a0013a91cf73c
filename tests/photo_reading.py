"""The JAX package's reading of a photo-scale run directory of the port
(``frcnn_tpu_torch.tools.train_synthetic_eval --scale photo``), for the
comparison with the port's reading on the card
(``frcnn_tpu_torch.tools.eval_quant_parity --detections``):

    JAX_PLATFORMS=cpu python -m tests.photo_reading RUN --ckpt partial.ckpt \\
        --modes bf16 --eval-count 240 --out JAX.json
    python -m tests.photo_reading --compare JAX.json PORT.json

The first form scores RUN's validation scenes with the JAX ``Detector``
in the serving modes of ``scripts/eval_quant_parity.py`` (its mode table,
its calibration batch taken into the program's color space as the port's
tool takes it, its iterator seeds; Pallas in interpret mode on the CPU) and merges into ``--out`` each mode's mAP beside its detections
per image (``eval_quant_parity.record``, with each image's file name);
``--eval-count N`` scores the first N images. ``--merge A.json ...
--out C.json`` merges earlier readings of RUN into C. The second form
prints, per mode both files hold, both mAPs and the share of each side's
detections the other matches (same image and class, IoU >= 0.5), with
every miss.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def jax_modes(cfg, calib) -> dict:
    """``scripts/eval_quant_parity.py:95-118``, Pallas in interpret mode."""
    pcfg = cfg.replace(pallas_mode="interpret")
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


def read(run: str, ckpt: str, modes, eval_count: int,
         calib_count: int = 8, scale: str = "photo") -> dict:
    import jax
    import jax.numpy as jnp

    from frcnn_tpu.data.pipeline import BatchIterator
    from frcnn_tpu.detect.detector import Detector
    from frcnn_tpu.detect.evaluation import evaluate_map
    from frcnn_tpu.ops.color import unwire_uint8
    from frcnn_tpu.ops.normalization import normalize_image
    from frcnn_tpu.utils.serialization import load_checkpoint
    from frcnn_tpu_torch.tools.eval_quant_parity import Recorder, record
    from scripts.train_synthetic_eval import SCALES

    *_, n_classes, cfg_fn, _maker = SCALES[scale]
    data = os.path.join(run, "dataset")
    manifest = os.path.join(data, "manifest.json")
    cfg = cfg_fn(n_classes).replace(examples_base_path=data)
    payload = load_checkpoint(os.path.join(run, ckpt))
    params, stats = payload["params"], payload["batch_stats"]
    imgs, hws, _ = BatchIterator(cfg, manifest, seed=123
                                 ).padded_validation_batch(calib_count)
    # in the detect program's color space, as the port's
    # ``eval_quant_parity.calibration_batch`` takes it (the JAX script
    # normalizes the wire's RGB bytes under ``uint8_wire``)
    imgs = unwire_uint8(jnp.asarray(imgs), cfg.color_space)
    n = cfg.normalization
    calib = jax.vmap(lambda im, hw: normalize_image(
        im, hw[0], hw[1], method=n.method, width=n.width,
        centering=n.centering, scaling=n.scaling))(jnp.asarray(imgs),
                                                   jnp.asarray(hws))
    table = jax_modes(cfg, calib)
    out = {"_ckpt": ckpt, "_step": int(payload.get("step", 0))}
    for name in modes:
        mcfg, kw = table[name]
        det = Recorder(Detector(mcfg, params, stats, **kw))
        r = evaluate_map(cfg, det, BatchIterator(cfg, manifest, seed=7),
                         max_images=eval_count)
        out[name] = {"mAP": r["mAP"], "num_detections": r["num_detections"],
                     "num_gt": r["num_gt"], "num_images": r["num_images"],
                     "images": record(det, r["num_images"])}
        print(f"{name:20s} mAP={r['mAP']:.4f} "
              f"det={r['num_detections']}/{r['num_gt']} over "
              f"{r['num_images']} images", flush=True)
    return out


def name_images(run: str, reading: dict) -> dict:
    """``reading`` with each image record's file name (``"name"``), found
    by the digest of the file as the port decodes it (the photo scenes
    fill their bucket, so the frame is the file's pixels)."""
    from frcnn_tpu_torch.data.codec import read_rgb
    from frcnn_tpu_torch.tools.eval_quant_parity import digest

    data = os.path.join(run, "dataset")
    with open(os.path.join(data, "manifest.json")) as f:
        names = {}
        for n in json.load(f)["validation_set"]:
            try:
                names[digest(read_rgb(os.path.join(data, n),
                                      use_native=False))] = n
            except ValueError:      # the corrupt files
                pass
    for name, r in reading.items():
        if not name.startswith("_"):
            for x in r["images"]:
                x["name"] = names[x["digest"]]
    return reading


def merge(path: str, reading: dict) -> dict:
    """The modes of ``reading`` written over those of the JSON at
    ``path`` (if any), the rest kept."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out.update(reading)
    with open(path, "w") as f:
        json.dump(out, f)
    return out


def compare(a: dict, b: dict) -> dict:
    """Per mode in both readings: mAPs, matched shares and misses, over
    the images both scored (the shorter reading's first images)."""
    from frcnn_tpu_torch.tools.eval_quant_parity import match_detections

    rows = {}
    for name in sorted(set(a) & set(b)):
        if name.startswith("_"):
            continue
        k = min(len(a[name]["images"]), len(b[name]["images"]))
        m = match_detections(a[name]["images"][:k], b[name]["images"][:k])
        rows[name] = {"images": k,
                      "mAP": [(r[name]["mAP"], len(r[name]["images"]))
                              for r in (a, b)], **m}
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", nargs="?")
    ap.add_argument("--ckpt", default="final.ckpt")
    ap.add_argument("--modes", default="bf16")
    ap.add_argument("--eval-count", type=int, default=240)
    ap.add_argument("--calib-count", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="merge this reading's modes into this JSON")
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--merge", nargs="+", default=None,
                    help="readings of RUN to merge into --out, named")
    args = ap.parse_args(argv)
    if args.merge:
        for path in args.merge:
            with open(path) as f:
                merge(args.out, name_images(args.run, json.load(f)))
        print(f"wrote {args.out}", flush=True)
        return 0
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        for name, r in compare(a, b).items():
            (ma, na), (mb, nb) = r["mAP"]
            print(f"{name}: the first {r['images']} images; mAP {ma:.4f} "
                  f"over {na} | {mb:.4f} over {nb}; matched "
                  f"{r['a']}/{r['n_a']} of the first's, {r['b']}/{r['n_b']} "
                  f"of the second's")
            for miss in r["misses"]:
                print("   miss", miss)
        return 0
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = read(args.run, args.ckpt, args.modes.split(","), args.eval_count,
               args.calib_count)
    if args.out:
        merge(args.out, name_images(args.run, out))
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
