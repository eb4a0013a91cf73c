"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one flushed line with its seconds:

  env      the card (torch and nvidia-smi: name, power limit)
  build    one nvcc call builds every kernel of frcnn_tpu_torch/csrc
  kernels  each kernel against its plain PyTorch version at the serving
           shapes (equal, or within the stated tolerance), with CUDA-event
           times of kernel, plain version and, where one PyTorch call
           computes the same function, that call
  detect   the serving Detector (vgg_small, duplo serving config, 450x800,
           batch 8): float32 through the kernels equals float32 through
           the plain versions; then bf16 serving batches with the launch
           counts of every kernel read around them
  profile  device time of the bf16 serving batch by kernel group
           (torch.profiler), and the device's busy share: that device
           time over the wall time of the same batches run without the
           profiler

then one JSON line of per-kernel numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero without that line; a watchdog ends the run with a
traceback once it has taken BUDGET_S seconds. It needs one CUDA card and
never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

BUDGET_S = 300.0          # the whole run, cold build included
T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "artifacts" / "ckpt" / "photo_partial.ckpt"
B = 8
IMAGE_HW = (450, 800)

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by type
HBM_BPS = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def log(phase: str, msg: str, t_start: float) -> None:
    total = time.perf_counter() - T0
    print(f"[{phase}] {msg} ({time.perf_counter() - t_start:.2f} s, "
          f"{total:.1f} s total)", flush=True)
    if total > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S:.0f} s budget after {phase}")


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, dtype):
    """Least time for the work: the larger of bytes over HBM rate and
    operations over the type's peak. Returns (ms, 'bytes'|'operations')."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_env():
    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {name}; count {torch.cuda.device_count()}; nvidia-smi: "
        f"{smi}", t)
    return name, smi


def phase_build():
    from frcnn_tpu_torch.ops import cuda_lib

    t = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    kernel, spill = "?", ""
    for ln in (path.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            kernel = next((k for k in ("block0_kernel", "nms_keep_kernel",
                                       "roi_pool_kernel") if k in ln), ln)
            kernel += " bf16" if "bfloat16" in ln else ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            print(f"[build] ptxas: {kernel}: {ln.split(':', 1)[-1].strip()}"
                  f"; {spill}", flush=True)
    log("build", f"{len(cuda_lib.sources())} sources -> {path.name}", t)


# -- kernels ------------------------------------------------------------------

def _nms_inputs(gen, n: int):
    """[B, n] boxes in processing order: random integer boxes over the
    image, exact duplicates (score ties resolved by position) and pairs at
    IoU exactly 0.25 and 0.1 under the +1-pixel convention."""
    H, W = IMAGE_HW
    xy = torch.randint(0, W - 40, (B, n, 2), generator=gen).float()
    xy[..., 1] = torch.remainder(xy[..., 1], H - 40)
    wh = torch.randint(8, 160, (B, n, 2), generator=gen).float()
    boxes = torch.cat([xy, xy + wh], dim=-1)
    # duplicates
    boxes[:, 1::17] = boxes[:, 0:-1:17][:, : boxes[:, 1::17].shape[1]]
    # [0,0,9,9] vs [0,0,9,39]: inter 100, union 400 -> IoU 0.25 exactly;
    # vs [0,0,9,99]: inter 100, union 1000 -> IoU 0.1 exactly
    for k, (a, b) in enumerate(((0, 1), (2, 3))):
        off = 100.0 * k
        boxes[:, a] = torch.tensor([off, off, off + 9, off + 9])
        boxes[:, b] = torch.tensor([off, off, off + 9,
                                    off + (39 if k == 0 else 99)])
    valid = torch.ones(B, n, dtype=torch.bool)
    return boxes.cuda(), valid.cuda()


def check_nms(gen):
    from frcnn_tpu_torch.ops import nms as plain
    from frcnn_tpu_torch.ops import nms_kernel as K

    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for n, thr in ((512, 0.25), (128, 0.1)):
        t = time.perf_counter()
        boxes, valid = _nms_inputs(gen, n)
        got = K.nms_keep_mask(boxes, valid, thr, 128)
        torch.cuda.synchronize()
        ref = plain.nms_keep_mask(boxes, valid, thr, 128)
        if not torch.equal(got, ref):
            raise AssertionError(f"nms N={n}: keep masks differ in "
                                 f"{int((got != ref).sum())} places")
        ms = time_ms(lambda: K.nms_keep_mask(boxes, valid, thr, 128))
        pms = time_ms(lambda: plain.nms_keep_mask(boxes, valid, thr, 128),
                      reps=10)
        # work this data needs: one IoU row (13 flops per later box) per pick
        kept = ref.cpu().numpy()
        pos = np.nonzero(kept)[1]
        n_ops = 13.0 * float(np.sum(n - 1 - pos))
        bms, by = bound_ms(B * n * (16 + 1 + 1), n_ops, torch.float32)
        out["ms"] += ms
        out["plain_ms"] += pms
        out["bound_ms"] += bms
        out["bound_by"] = by
        log("kernels", f"nms_keep_mask B={B} N={n} thr={thr}: keep masks "
            f"equal ({int(kept.sum())} kept); kernel {ms:.4f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.5f} ms ({by}); no single PyTorch "
            f"call computes greedy NMS", t)
    out["library_ms"] = None
    return out


def check_roi_pool(gen):
    from frcnn_tpu_torch.ops import roi_pool as plain
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    t = time.perf_counter()
    H, W, C, D, k = 29, 50, 384, 128, 6
    fm = torch.randn(B, H, W, C, generator=gen).to(torch.bfloat16).cuda()
    p0 = torch.rand(B, D, 2, generator=gen) * torch.tensor([W, H])
    ext = torch.rand(B, D, 2, generator=gen) * torch.tensor([W, H]) * 0.8
    raw = torch.cat([p0 - 2, p0 + ext], dim=-1).floor()
    rects = plain.prepare_roi_rects(raw, float(W), float(H)).cuda()
    valid = torch.ones(B, D, dtype=torch.bool, device="cuda")
    got = K.adaptive_max_pool_valid(fm, rects, valid, k, k)
    torch.cuda.synchronize()
    ref = plain.adaptive_max_pool(fm, rects, valid, k, k)
    if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError("roi_pool: kernel and plain outputs differ")
    ms = time_ms(lambda: K.adaptive_max_pool_valid(fm, rects, valid, k, k))
    pms = time_ms(lambda: plain.adaptive_max_pool(fm, rects, valid, k, k),
                  reps=10)
    r = rects.to(torch.int64).cpu()
    ext_x = (r[..., 2] - r[..., 0])[..., None]
    ext_y = (r[..., 3] - r[..., 1])[..., None]
    b = torch.arange(k)
    bins_x = -torch.div(-(b + 1) * ext_x, k, rounding_mode="floor") \
        - torch.div(b * ext_x, k, rounding_mode="floor")
    bins_y = -torch.div(-(b + 1) * ext_y, k, rounding_mode="floor") \
        - torch.div(b * ext_y, k, rounding_mode="floor")
    n_cmp = float((bins_y.sum(-1) * bins_x.sum(-1)).sum()) * C
    n_bytes = fm.numel() * 2 + rects.numel() * 4 + valid.numel() \
        + got.numel() * 2
    bms, by = bound_ms(n_bytes, n_cmp, torch.bfloat16)
    log("kernels", f"roi_pool fm {tuple(fm.shape)} bf16, {D} rects/image: "
        f"bitwise equal; kernel {ms:.4f} ms, plain {pms:.3f} ms, bound "
        f"{bms:.5f} ms ({by}); no single PyTorch call pools a batch of "
        f"rects", t)
    return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": 0.0, "library_ms": None}


def check_block0(gen):
    from frcnn_tpu_torch.ops import block0_kernel as K

    t = time.perf_counter()
    H, W = IMAGE_HW
    Fo = 64
    x = torch.randn(B, H, W, 3, generator=gen).numpy()
    lum4, chroma = (torch.from_numpy(a).cuda() for a in K.pack_s2d_np(x))
    w = (torch.randn(Fo, 3, 3, 3, generator=gen) * 0.3).cuda()
    bias = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    slope = torch.tensor([0.25], device="cuda")
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        w27, b32 = K.block0_weights(w, bias, dt)
        l, c = lum4.to(dt), chroma.to(dt)
        got = K.fused_block0(l, c, w27, b32, slope)
        torch.cuda.synchronize()
        ref = K.block0_plain(l, c, w27, b32, slope)
        err = (got.float() - ref.float()).abs()
        rel = float((err / ref.float().abs().clamp(min=1e-3)).max())
        if dt == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            # both round one float32 sum to bf16 once: one bf16 ulp apart
            torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-2)
        ms = time_ms(lambda: K.fused_block0(l, c, w27, b32, slope))
        pms = time_ms(lambda: K.block0_plain(l, c, w27, b32, slope), reps=10)
        n_ops = 2.0 * B * (H // 2) * (W // 2) * Fo * 4 * 27
        n_bytes = (l.numel() + c.numel() + w27.numel() + got.numel()) \
            * l.element_size() + 4 * (Fo + 1)
        bms, by = bound_ms(n_bytes, n_ops, dt)
        # yardstick the port never calls: conv + prelu + ceil pool in dt
        xi = torch.from_numpy(x).cuda().permute(0, 3, 1, 2).to(dt) \
            .contiguous()
        wd, bd, sd = w.to(dt), bias.to(dt), slope.to(dt)
        lib_ms = time_ms(lambda: F.max_pool2d(
            F.prelu(F.conv2d(xi, wd, bd, padding=1), sd), 2,
            ceil_mode=True))
        res[dt] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                   "bound_by": by, "max_abs_err": float(err.max()),
                   "library_ms": lib_ms}
        log("kernels", f"fused_block0 {str(dt)[6:]} B={B} {H}x{W}: max abs "
            f"err {float(err.max()):.3g}, max rel err {rel:.3g}; kernel "
            f"{ms:.4f} ms, plain {pms:.3f} ms, conv+prelu+pool call "
            f"{lib_ms:.4f} ms, bound {bms:.5f} ms ({by})", t)
    return res[torch.bfloat16]


def phase_kernels():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    return {"nms_keep_mask": check_nms(gen),
            "roi_pool": check_roi_pool(gen),
            "fused_block0": check_block0(gen)}


# -- detect -------------------------------------------------------------------

# the colors of the six brick classes the photo checkpoint was trained on
BRICK_COLORS = ((220, 40, 40), (40, 220, 40), (60, 60, 230),
                (230, 230, 40), (230, 40, 230), (40, 230, 230))


def _frames(seed: int, n: int, hw=IMAGE_HW):
    """Seeded synthetic uint8 RGB frames: smooth noise plus a few filled
    rectangles, shaded like toy bricks (lit gradient, lighter top face,
    dark rim) in the six class colors."""
    H, W = hw
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(40, 215, size=(n, H // 25 + 2, W // 25 + 2, 3))
    t = torch.from_numpy(coarse).permute(0, 3, 1, 2)
    smooth = F.interpolate(t, size=(H, W), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    img = smooth + rng.normal(0, 6, size=(n, H, W, 3))
    for i in range(n):
        for _ in range(6):
            h, w = rng.integers(H // 8, H // 3), rng.integers(W // 10, W // 4)
            y, x = rng.integers(0, H - h), rng.integers(0, W - w)
            color = np.asarray(BRICK_COLORS[rng.integers(0, 6)], np.float64)
            g = np.linspace(0.62, 1.05, w)[None, :, None]
            body = np.broadcast_to(color * g, (h, w, 3)).copy()
            top = max(2, h // 6)
            body[:top] = np.minimum(body[:top] * 1.45 + 18, 255)
            body[[0, -1]] *= 0.55
            body[:, [0, -1]] *= 0.55
            img[i, y:y + h, x:x + w] = body
    return np.clip(img, 0, 255).astype(np.uint8)


def _load_models():
    from frcnn_tpu_torch.config import Config, duplo_config, serving_config
    from frcnn_tpu_torch.models.factory import create_models, init_models
    from frcnn_tpu_torch.utils.serialization import load_checkpoint
    from frcnn_tpu_torch.utils.weights import from_jax_params

    t = time.perf_counter()
    if CKPT.exists():
        payload = load_checkpoint(str(CKPT))
        base = Config.from_json(payload["config_json"])
        cfg = serving_config(base.replace(shapes=dataclasses.replace(
            base.shapes, image_hw=IMAGE_HW)))
        pnet, cnet = create_models(cfg)
        state = from_jax_params(payload["params"], payload["batch_stats"],
                                cfg)
        pnet.load_state_dict(state["pnet"])
        cnet.load_state_dict(state["cnet"])
        src = f"{CKPT.relative_to(ROOT)} (step {payload['step']})"
    else:
        print(f"[detect] {CKPT.relative_to(ROOT)} is absent: seeded "
              f"initialisation at the same widths", flush=True)
        base = duplo_config(class_count=6)
        cfg = serving_config(base.replace(shapes=dataclasses.replace(
            base.shapes, image_hw=IMAGE_HW)))
        pnet, cnet = init_models(cfg, torch.Generator().manual_seed(0))
        with torch.no_grad():
            # random class logits are near uniform, so the 0.2 confidence
            # gate would reject every ROI: spread them so the last stage
            # has work
            cnet.cls_head.weight.mul_(20.0)
            # random box regressions reach thousands of pixels; keep boxes
            # near their anchors, at the coordinates trained weights give
            for ai in range(len(cfg.model.anchor_nets)):
                w = getattr(pnet, f"anchor{ai}_out").weight
                for j in range(3):
                    w[6 * j + 2:6 * j + 6].mul_(0.1)
            cnet.reg_head.weight.mul_(0.1)
        src = "seeded initialisation (torch.Generator seed 0)"
    cfg = cfg.replace(detect_fg_threshold=0.5)
    log("detect", f"weights from {src}; {cfg.model.name}, "
        f"{cfg.class_count} classes, bucket {cfg.shapes.image_hw}", t)
    return cfg, pnet, cnet


def phase_detect(kernels):
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops import block0_kernel, nms_kernel, roi_pool_kernel
    from frcnn_tpu_torch.ops.color import unwire_uint8

    modules = {"nms_keep_mask": nms_kernel, "roi_pool": roi_pool_kernel,
               "fused_block0": block0_kernel}
    cfg, pnet, cnet = _load_models()
    frames = _frames(1, B)
    true_hw = np.tile(np.asarray([IMAGE_HW], np.int32), (B, 1))

    # float32 through the kernels == float32 through the plain versions
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32")
    ker = Detector(cfg32, pnet, cnet, device="cuda").detect(frames, true_hw)
    ref = Detector(cfg32.replace(pallas_mode="off"), pnet, cnet,
                   device="cuda").detect(frames, true_hw)
    torch.cuda.synchronize()
    for f in ("valid", "classes", "proposals_valid"):
        if not torch.equal(getattr(ker, f), getattr(ref, f)):
            raise AssertionError(f"detect f32: {f} differs between kernels "
                                 f"and plain versions")
    torch.testing.assert_close(ker.boxes, ref.boxes, rtol=0, atol=1e-3)
    torch.testing.assert_close(ker.confidence, ref.confidence, rtol=0,
                               atol=1e-4)
    log("detect", f"float32 B={B}: kernels == plain versions "
        f"({int(ref.proposals_valid.sum())} proposals, "
        f"{int(ref.valid.sum())} detections)", t)

    # bf16 serving: the main path, with launch counts read around it
    t = time.perf_counter()
    det = Detector(cfg, pnet, cnet, device="cuda")
    lum4, chroma = (torch.from_numpy(a).cuda() for a in
                    block0_kernel.pack_s2d_np(unwire_uint8(frames,
                                                           cfg.color_space)))
    hw_dev = torch.from_numpy(true_hw).cuda()
    det.detect((lum4, chroma), hw_dev)          # warm-up
    torch.cuda.synchronize()
    for m in modules.values():
        m.KERNEL.launches = 0
    n_calls = 5
    t_run = time.perf_counter()
    outs = [det.detect(frames, true_hw) for _ in range(n_calls)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_run) / n_calls
    launches = {k: m.KERNEL.launches for k, m in modules.items()}
    dev_ms = time_ms(lambda: det.detect((lum4, chroma), hw_dev), reps=10)
    # uint8 frames already on the card are unwired and packed there
    frames_dev = torch.from_numpy(frames).cuda()
    for a, b in zip(block0_kernel.pack_s2d(
            unwire_uint8(frames_dev, cfg.color_space)), (lum4, chroma)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    card_ms = time_ms(lambda: det.detect(frames_dev, hw_dev), reps=10)
    out = outs[-1]
    n_in = int(det.last_counts["proposals_in"].sum())
    n_roi = int(out.proposals_valid.sum())
    n_det = int(out.valid.sum())
    if not (n_in > 0 and n_roi > 0 and n_det > 0):
        raise AssertionError(f"bf16 serving: empty stage (proposals {n_in}, "
                             f"rois {n_roi}, detections {n_det})")
    if not all(torch.isfinite(x).all() for x in
               (out.boxes, out.confidence, out.fg_score, out.proposals)):
        raise AssertionError("bf16 serving: non-finite outputs")
    for k, n in launches.items():
        want = 2 * n_calls if k == "nms_keep_mask" else n_calls
        if n != want:
            raise AssertionError(f"{k}: {n} launches in {n_calls} detect "
                                 f"calls, expected {want}")
    log("detect", f"bf16 serving B={B} {IMAGE_HW[0]}x{IMAGE_HW[1]}: "
        f"{wall * 1e3:.2f} ms/batch from uint8 frames (host pack included), "
        f"{B / wall:.1f} img/s; {card_ms:.2f} ms/batch from uint8 frames on "
        f"the card (packed there), {B / card_ms * 1e3:.1f} img/s; "
        f"{dev_ms:.2f} ms/batch from packed device planes, "
        f"{B / dev_ms * 1e3:.1f} img/s; {n_in} proposals into NMS, "
        f"{n_roi} rois pooled, {n_det} detections; launches {launches} over "
        f"{n_calls} calls", t)
    for k in kernels:
        kernels[k]["launches"] = launches[k]
    phase_profile(det, (lum4, chroma), hw_dev)
    return modules


PROFILE_GROUPS = (  # kernel-name fragment -> group, first match wins
    ("block0_kernel", "block0 kernel"), ("nms_keep_kernel", "nms kernel"),
    ("roi_pool_kernel", "roi_pool kernel"), ("conv", "convolution"),
    ("fprop", "convolution"), ("dgrad", "convolution"),
    ("gemm", "matmul"), ("sort", "sort"), ("Sort", "sort"),
    ("reduce", "reductions"), ("elementwise", "elementwise"),
)


def phase_profile(det, planes, hw_dev, n_calls: int = 3):
    """Device time of the bf16 serving run by kernel group
    (torch.profiler), and the busy share of the device: that device time
    over the wall time of the same batches run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    det.detect(planes, hw_dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for _ in range(n_calls):
        det.detect(planes, hw_dev)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t_run) * 1e6 / n_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_run = time.perf_counter()
        for _ in range(n_calls):
            det.detect(planes, hw_dev)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t_run) * 1e6 / n_calls
    groups, kernels, n_launch = {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us() / n_calls
        n_launch += 1
        g = next((v for k, v in PROFILE_GROUPS if k in e.name), "other")
        groups[g] = groups.get(g, 0.0) + us
        kernels[e.name] = kernels.get(e.name, 0.0) + us
    busy = sum(groups.values())
    if busy == 0:
        log("profile", "torch.profiler recorded no device time: not "
            "measured", t)
        return
    for g, us in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"[profile] {g}: {us / 1e3:.3f} ms/batch "
              f"({100 * us / busy:.1f}% of device time)", flush=True)
    for name, us in sorted(kernels.items(), key=lambda x: -x[1])[:8]:
        print(f"[profile] top kernel {us / 1e3:.3f} ms/batch: {name[:200]}",
              flush=True)
    log("profile", f"bf16 serving B={B}: {busy / 1e3:.3f} ms/batch of device "
        f"kernels; {wall_us / 1e3:.3f} ms/batch wall without the profiler "
        f"(busy share {100 * busy / wall_us:.1f}%), {prof_wall_us / 1e3:.3f} "
        f"ms/batch under it; {n_launch / n_calls:.0f} kernel launches per "
        f"batch", t)


def main() -> int:
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    name, smi = phase_env()
    phase_build()
    kernels = phase_kernels()
    modules = phase_detect(kernels)
    line = []
    for k, m in modules.items():
        r = kernels[k]
        line.append({"name": k, "route": "cuda", "source": m.KERNEL.source,
                     "replaces": m.KERNEL.replaces,
                     "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
