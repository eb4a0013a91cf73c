"""Rows 1, 2, 3, 4 and 6 of one checkout at the published serving and
training shapes on the card, for comparing two trees in one call (parent,
change, change, parent; each a fresh process):

    python3 frcnn_tpu_torch/tools/bench_rows.py ROOT [READINGS] [--shapes]

builds ROOT's kernels, then takes READINGS (default 3) readings of the
device time per path call (torch.profiler, mean per launch times the
launches per call, over 10 calls) of:

* vgg_small bf16 serving, 450x800, B=8, this repo's
  ``artifacts/ckpt/photo_partial.ckpt``: row 1 (both NMS launches), row 2
  and row 3 per detect; the same Detector quantized (static scales
  calibrated on one normalized batch): row 3's int8 mode per detect;
* vgg_small bf16 training, 450x800, B=8 (``chip_smoke._train_config``):
  rows 2 and 4 per step;
* vgg_large bf16 serving, 480x1000, B=8, seeded weights: row 6 per detect,
  float and, quantized, int8.

``--shapes`` reads instead the device time per call of the same rows on
the paths of ``chip_smoke.py``'s ``[shapes]`` (needs a tree that has
them): (a) vgg_small with a 9x9 ROI pool, per detect and per train step;
(b) a train step on 3008x480 frames, B=2; (c) vgg_small with a first
layer of 32 filters, float and int8, and the tiny config's 8; (d)
vgg_large with a first block of 32 filters, float and int8 (480x1000).

Prints one line per reading and last one JSON object {row: [ms, ...]}. It
needs a CUDA card; it imports ROOT's ``chip_smoke`` and
``frcnn_tpu_torch``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else ".")
    shapes = "--shapes" in argv
    argv = [a for a in argv if a != "--shapes"]
    readings = int(argv[1]) if len(argv) > 1 else 3
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_rows: needs a CUDA card")
    import chip_smoke as S
    from frcnn_tpu_torch.config import imagenet_config, serving_config
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops import cuda_lib
    from frcnn_tpu_torch.train.trainer import Trainer

    # this repo's checkpoint, whichever tree runs
    S.ROOT = Path(__file__).resolve().parents[2]
    S.CKPT = S.ROOT / "artifacts" / "ckpt" / "photo_partial.ckpt"
    S.BUDGET_S = float("inf")
    t = time.perf_counter()
    cuda_lib.build()
    cuda_lib.library()
    print(f"== {root}: built in {time.perf_counter() - t:.1f} s", flush=True)
    out = {}

    def read(name, fn, frags, what):
        for _ in range(readings):
            dev = S.device_ms_per_call(fn, frags, 10)
            for k, v in dev.items():
                out.setdefault(k, []).append(v)
            print(f"{what}: {dev}", flush=True)

    if shapes:
        shape_paths(S, read)
        print(json.dumps({"root": root, "ms": out}), flush=True)
        return 0

    # vgg_small serving, float and int8
    cfg, pnet, cnet = S._load_models("bench_rows")
    batches, calib = S._int8_batches(cfg, 5, [S.IMAGE_HW])
    planes, true_hw = batches[S.IMAGE_HW]
    det = Detector(cfg, pnet, cnet, device="cuda")
    read("small", lambda: det.detect(planes, true_hw), {
        "row1_nms_detect": ("nms_keep_kernel", 2),
        "row2_roi_pool_detect": ("roi_pool_kernel", 1),
        "row3_block0_detect": ("block0_kernel<__nv_bfloat16, __nv_bfloat16",
                               1)}, "vgg_small bf16 detect")
    qdet = Detector(cfg, pnet, cnet, device="cuda", quantized=True,
                    quant_calibration=calib)
    read("small int8", lambda: qdet.detect(planes, true_hw), {
        "row3_block0_s8out_detect": ("block0_kernel<__nv_bfloat16, signed "
                                     "char", 1)}, "vgg_small int8 detect")
    del det, qdet
    torch.cuda.empty_cache()

    # vgg_small training
    tcfg = S._train_config("bfloat16")
    batch = S._train_batch(tcfg, 2)
    trainer = Trainer(tcfg, device="cuda", seed=0, pool_vjp="kernel")
    for _ in range(2):
        trainer.run_step(batch)
    read("train", lambda: trainer.run_step(batch), {
        "row2_roi_pool_step": ("roi_pool_kernel", 1),
        "row4_roi_pool_bwd_step": ("roi_pool_bwd", 2)},
        "vgg_small bf16 train step")
    del trainer
    torch.cuda.empty_cache()

    # vgg_large serving, float and int8
    lcfg = serving_config(imagenet_config()).replace(detect_fg_threshold=0.5)
    lp, lc = S._seeded_models(lcfg, cls_spread=500.0)
    hw = S.LARGE_HW[0]
    lb, lcal = S._int8_batches(lcfg, 7, [hw])
    lplanes, lhw = lb[hw]
    det = Detector(lcfg, lp, lc, device="cuda")
    read("large", lambda: det.detect(lplanes, lhw), {
        "row6_2conv_detect": ("block0_2conv_kernel<__nv_bfloat16, false",
                              1)}, "vgg_large bf16 detect")
    qdet = Detector(lcfg, lp, lc, device="cuda", quantized=True,
                    quant_calibration=lcal)
    read("large int8", lambda: qdet.detect(lplanes, lhw), {
        "row6_2conv_int8_detect": ("block0_2conv_kernel<__nv_bfloat16, true",
                                   1)}, "vgg_large int8 detect")
    print(json.dumps({"root": root, "ms": out}), flush=True)
    return 0


# the detect's kernels: (name-fragment, launches per call); "roi_pool" is
# either forward instance (a detect launches no backward)
DETECT = {"nms": ("nms_keep_kernel", 2), "roi_pool": ("roi_pool", 1)}
BLOCK0 = "block0_kernel<__nv_bfloat16, __nv_bfloat16"
BLOCK0_S8 = "block0_kernel<__nv_bfloat16, signed char"
TWO_CONV = "block0_2conv_kernel<__nv_bfloat16, false"
TWO_CONV_S8 = "block0_2conv_kernel<__nv_bfloat16, true"


def shape_paths(S, read) -> None:
    """The [shapes] paths' device ms per call (see the module note)."""
    import dataclasses

    import torch

    from frcnn_tpu_torch.config import (
        RoiPoolingConfig,
        imagenet_config,
        serving_config,
    )
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.parallel.dryrun import tiny_config
    from frcnn_tpu_torch.train.trainer import Trainer

    def detect(what, cfg, frags, quantized=False, spread=20.0):
        pnet, cnet = S._seeded_models(cfg, cls_spread=spread)
        hw = tuple(cfg.shapes.image_hw)
        batches, calib = S._int8_batches(cfg, 11, [hw])
        planes, true_hw = batches[hw]
        kw = ({"quantized": True, "quant_calibration": calib}
              if quantized else {})
        det = Detector(cfg, pnet, cnet, device="cuda", **kw)
        read(what, lambda: det.detect(planes, true_hw), frags, what)
        del det
        torch.cuda.empty_cache()

    def train(what, cfg, batch, forward):
        trainer = Trainer(cfg, device="cuda", seed=0, pool_vjp="kernel")
        for _ in range(2):
            trainer.run_step(batch)
        read(what, lambda: trainer.run_step(batch), {
            f"{what} roi_pool": (forward, 1),
            f"{what} roi_pool_bwd": ("roi_pool_bwd", 2)}, what)
        del trainer
        torch.cuda.empty_cache()

    def frags(what, **extra):
        return {f"{what} {k}": v for k, v in {**DETECT, **extra}.items()}

    pool9 = RoiPoolingConfig(kh=9, kw=9)
    cfg = S._duplo_serving(roi_pooling=pool9)
    detect("a", cfg, frags("(a) detect", block0=(BLOCK0, 1)))
    tcfg = S._train_config("bfloat16").replace(roi_pooling=pool9)
    train("(a) step", tcfg, S._train_batch(tcfg, 21), "roi_pool_any_kernel")
    base = S._train_config("bfloat16")
    tall = (3008, 480)
    tcfg = base.replace(max_pixel_size=tall[0], shapes=dataclasses.replace(
        base.shapes, image_hw=tall, images_per_step=2))
    train("(b) step", tcfg, S._train_batch(tcfg, 22, tall, 2),
          "roi_pool_kernel")
    cfg = S._narrow_first(S._duplo_serving(), 32)
    detect("c", cfg, frags("(c) detect", block0=(BLOCK0, 1)))
    detect("c int8", cfg, frags("(c) int8 detect", block0=(BLOCK0_S8, 1)),
           quantized=True)
    cfg = serving_config(tiny_config(S.B)).replace(
        compute_dtype="bfloat16", detect_fg_threshold=0.5)
    detect("tiny", cfg, frags("(c) tiny detect", block0=(BLOCK0, 1)))
    cfg = S._narrow_first(serving_config(imagenet_config()), 32).replace(
        detect_fg_threshold=0.5)
    detect("d", cfg, frags("(d) detect", two_conv=(TWO_CONV, 1)),
           spread=500.0)
    detect("d int8", cfg, frags("(d) int8 detect",
                                two_conv=(TWO_CONV_S8, 1)),
           quantized=True, spread=500.0)


if __name__ == "__main__":
    sys.exit(main())
