"""Row 1 (``csrc/nms.cu``) of one checkout on the card, for comparing two
trees in one call (parent, change, change, parent; each a fresh process):

    python3 frcnn_tpu_torch/tools/bench_nms.py ROOT [--large]

builds ROOT's kernels and prints ptxas's lines for ``nms.cu``; holds the
kernel bitwise against the plain version at the serving shapes (B=8, N=512
and 128, ``chip_smoke._nms_inputs``) with its device time per launch
(torch.profiler, 50 launches); the NMS device time per vgg_small bf16
serving detect at 450x800, B=8 (3 readings of 20 detects; weights from this
repo's ``artifacts/ckpt/photo_partial.ckpt``). ``--large`` adds N past 2048
(2049 to 87552, dense and sparse picks, NaN and infinite coordinates), each
bitwise with its device time, and the ``ValueError`` past the limit. It
needs a CUDA card; it imports ROOT's ``chip_smoke`` and ``frcnn_tpu_torch``.
"""

from __future__ import annotations

import importlib
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else ".")
    large = "--large" in argv
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_nms: needs a CUDA card")
    import chip_smoke as S
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops import block0_kernel, cuda_lib
    from frcnn_tpu_torch.ops import nms_kernel as K
    from frcnn_tpu_torch.ops.color import unwire_uint8

    # this repo's checkpoint, whichever tree runs
    S.ROOT = Path(__file__).resolve().parents[2]
    S.CKPT = S.ROOT / "artifacts" / "ckpt" / "photo_partial.ckpt"
    plain = importlib.import_module("frcnn_tpu_torch.ops.nms")
    t = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    print(f"== {root}: built in {time.perf_counter() - t:.1f} s", flush=True)
    src = None
    for ln in (path.parent / "nvcc.log").read_text().splitlines():
        if ln.startswith("== "):
            src = ln
        elif src and "nms" in src and ("registers" in ln or "spill" in ln
                                       or "warning" in ln.lower()):
            print("  ", ln.strip(), flush=True)
    gen = torch.Generator().manual_seed(0)
    if hasattr(K, "max_boxes"):
        print("max_boxes", K.max_boxes(), "MAX_BOXES", K.MAX_BOXES,
              flush=True)
    for n, thr in ((512, 0.25), (128, 0.1)):
        boxes, valid = S._nms_inputs(gen, n)
        S._nms_equal(K, plain, boxes, valid, thr, 128, f"N={n}")
        got = S.kernel_device_ms(
            lambda: K.nms_keep_slots(boxes, valid, thr, 128),
            ["nms_keep_kernel"], 50)
        print(f"N={n}: equal; device ms per launch {got}", flush=True)
    cfg, pnet, cnet = S._load_models()
    frames, _, _ = S._frames(1, S.B)
    true_hw = np.tile(np.asarray([S.IMAGE_HW], np.int32), (S.B, 1))
    det = Detector(cfg, pnet, cnet, device="cuda")
    planes = tuple(torch.from_numpy(a).cuda() for a in block0_kernel.
                   pack_s2d_np(unwire_uint8(frames, cfg.color_space)))
    hw_dev = torch.from_numpy(true_hw).cuda()
    for _ in range(3):
        dev = S.device_ms_per_call(lambda: det.detect(planes, hw_dev),
                                   {"nms": ("nms_keep_kernel", 2)}, 20)
        print(f"per vgg_small bf16 detect: {dev}", flush=True)
    if not large:
        return 0

    def boxes_of(b, n, span, lo, hi):
        xy = torch.rand((b, n, 2), generator=gen) * span
        wh = torch.randint(lo, hi, (b, n, 2), generator=gen).float()
        return (torch.cat([xy, xy + wh], -1).floor().cuda(),
                (torch.rand((b, n), generator=gen) < 0.9).cuda())

    for n, b, mo, thr, span, lo, hi in (
            (2049, 8, 300, 0.7, 900.0, 8, 160),
            (2049, 2, 2049, 0.25, 3000.0, 8, 40),
            (3000, 3, 3000, 0.5, 4000.0, 8, 40),
            (6000, 8, 300, 0.7, 900.0, 8, 160),
            (6000, 2, 6000, 0.3, 6000.0, 8, 40),
            (35232, 8, 300, 0.7, 900.0, 8, 160),
            (35232, 1, 2000, 0.3, 9000.0, 8, 40),
            (K.MAX_BOXES, 8, 300, 0.7, 900.0, 8, 160)):
        boxes, valid = boxes_of(b, n, span, lo, hi)
        t = time.perf_counter()
        keep, _ = S._nms_equal(K, plain, boxes, valid, thr, mo,
                               f"B={b} N={n} max_out={mo}")
        dev = S.kernel_device_ms(
            lambda: K.nms_keep_slots(boxes, valid, thr, mo),
            ["nms_keep_kernel"], 5)
        print(f"N={n} B={b} max_out={mo} thr={thr}: equal, picks "
              f"{keep.sum(1).tolist()}; device ms {dev}; "
              f"{time.perf_counter() - t:.2f} s", flush=True)
    boxes, valid = boxes_of(3, 3000, 900.0, 8, 160)
    boxes[0, 0, 2] = float("nan")
    boxes[1, 2100::97, 1] = float("nan")
    valid[2, 2500:2502] = False
    boxes[2, 2500, 3] = float("nan")
    boxes[2, 2501, 0] = float("inf")
    keep, _ = S._nms_equal(K, plain, boxes, valid, 0.3, 300, "NaN N=3000")
    print("NaN/inf N=3000: equal, picks", keep.sum(1).tolist(), flush=True)
    try:
        n = K.MAX_BOXES + 1
        K.nms_keep_slots(torch.zeros((1, n, 4), device="cuda"),
                         torch.ones((1, n), dtype=torch.bool, device="cuda"),
                         0.5, 10)
    except ValueError as e:
        print("past the limit:", e, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
