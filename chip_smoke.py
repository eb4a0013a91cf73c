"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one flushed line with its seconds:

  env      the card (torch and nvidia-smi: name, power limit)
  build    one nvcc per source of frcnn_tpu_torch/csrc, all started
           together, then one link, build every kernel; each entry's
           registers and spills, and any ptxas warning
  kernels  each kernel against its plain PyTorch version at the serving
           shapes (equal, or within the stated tolerance), with CUDA-event
           times of kernel, plain version and, where one PyTorch call
           computes the same function, that call; the NMS keep mask and
           slots bitwise also on the kernel's 64-box chunk edges (N and
           max_out), NaN and infinite coordinates, an image with no valid
           box and N = 2048 (the most every block stages whole), with the
           picks per image; past that, where each block of the cluster
           stages its share of the image, at B=8, IoU 0.7 and 300 picks:
           N = 2049, 6000, 35232 (the most anchors of any bucket) and the
           kernel's limit (``max_boxes()`` on the card, equal to
           ``MAX_BOXES``), N = 2049 with 1000 picks, and NaN and infinite
           coordinates at N = 2500; each with its launch, kernel ms and
           bound (plain ms at 6000); the ROI pool bitwise also
           at C=512 on both vgg_large maps, at the train step's 224 slots
           and on small edge cases, float32 and bf16; block0 also on two
           ragged shapes (both slope signs) with the count of bf16 values
           that differ; the 2-conv block0 kernel in both vgg_large buckets
           (timed at 480x1000) and on the same ragged shapes, whose tile
           count is no multiple of the SM count (the persistent grids'
           partial last round)
  api      the package's public API on the card: the nine lazy names of
           ``frcnn_tpu_torch`` resolve; ``frcnn_tpu_torch.ops.nms`` and
           ``per_class_nms`` at the detect's proposal size (B=8, 512 boxes
           per image, 6 classes, the duplo thresholds, 128 picks), and an
           unbatched ``nms`` of one image, each one launch of the NMS
           kernel and no other kernel, indices and validity bitwise those
           of the same call on CPU copies (the plain keep mask); times per
           call; ``nms`` and ``per_class_nms`` at N = 2049, N = 6000 and
           N = MAX_BOXES + 1 (past the staged limit), each one launch,
           bitwise the CPU copies'; N past the kernel's limit
           (``MAX_DIRECT``) raises ValueError naming it, with no launch
  kernels-int8  the int8 modes of the two block0 kernels against their
           plain versions at the int8 path's shapes, float32 and bf16
           planes with a random pad ring: block0's int8 output, the 2-conv
           block0's int8 conv1 (float and int8 output) and its float conv1
           with an int8 output; int8 outputs at most one step apart in
           under 1% of the values (the flip rate is printed), also on the
           ragged shapes (both kernels); times beside the float modes' on
           the same planes, and bounds
  probe    row 7, the int8 matmul probe's kernels (csrc/matmul.cu): the
           TMA/wgmma route (mm) and the mma.sync route (mm_sync).
           tools/probe_int8_dot.py at its default 1024^3 (TMA) and at
           33x70x17 (mma.sync) with the launches of each route counted;
           both routes against the plain version at 1024^3 (s8 bitwise,
           bf16 bitwise on integer values and within 2^-20 sum|a_ik b_kj|
           on normal ones), on each route's edge shapes (ragged tiles,
           every tile width, partial rounds of the persistent grid, K
           tails; the TMA ones with B also K-contiguous) and where int32
           sums wrap; kernel, plain and library (torch._int_mm,
           torch.matmul) times, single-call medians and device time of
           back-to-back calls, TOPS and bounds; then s8 at the int8
           chain's largest GEMM (720000, 1152, 128) in both B layouts:
           bitwise torch._int_mm over the whole product and the plain
           version on its first 8192 rows, the same times beside
           torch._int_mm on the same B; then every GEMM of vgg_small's
           int8 chain at B=8, 450x800 as ops/int8_conv.py builds it (B
           K-contiguous), bitwise torch._int_mm, device times and bounds
  detect   the serving Detector (vgg_small, duplo serving config, 450x800,
           batch 8): float32 through the kernels equals float32 through
           the plain versions; then bf16 serving batches with the launch
           counts of every kernel read around them; the device time per
           detect of NMS (both launches), the ROI pool and block0
           (torch.profiler); the ROI pool bitwise on a detect's own inputs
           (a hook on its wrapper), with their valid count and mean size;
           NMS keep masks and slots bitwise on both calls of a detect
           (a hook on ``nms_kernel.nms_keep_slots``), with each call's
           picks, time and bound
  detect-6000  the same Detector at Faster R-CNN's published test setting,
           6000 boxes into the proposal NMS and 300 out: float32 kernels
           against plain versions (matched by class and box), bf16
           ms/batch, device ms per detect, launches (2 of row 1 per
           detect), and row 1 on both calls of a detect (N = 6000 and the
           per-class N = 300), bitwise, with each call's device ms
  profile  device time of the bf16 serving batch by kernel group
           (torch.profiler), and the device's busy share: that device
           time over the wall time of the same batches run without the
           profiler
  detect-large  the serving Detector of vgg_large (imagenet serving
           config, 201 classes, seeded weights) at 480x1000 and at the
           portrait bucket 1000x480, batch 8: float32 through the kernels
           equals float32 through the plain versions in both buckets; then
           bf16 batches from packed device planes with ms/batch, img/s and
           the launch counts of every kernel read around them (the 2-conv
           block0 kernel's above 0 in both buckets), the NMS kernel's
           device time per detect and its check on both calls of a detect,
           each bucket
  profile-large  the profile phase's breakdown for a vgg_large bf16 batch
  detect-int8  the int8 serving Detector (quantized, static scales
           calibrated on one normalized batch of the smoke's frames, the
           s8-pooled chain) of vgg_small (the detect phase's weights,
           450x800) and of vgg_large (seeded, both buckets), batch 8:
           float32 through the kernels against float32 through the plain
           versions, block 0's output compared at the int8 tolerance and
           then handed to both, detections matched by class and box; the
           share of detections that agree without that hand-over; bf16
           ms/batch and img/s from packed device planes with the launch
           counts (1 of the family's int8 block0 kernel per call, 0 of the
           float block0 modes), and the share of the float path's
           detections the int8 path matches (class, IoU >= 0.5); the
           int8 block0 kernel's and NMS's device time per vgg_small
           detect; NMS checked on both calls of a detect, each bucket
  profile-int8  device time of an int8 bf16 batch of each family by
           kernel group, and each int8 conv layer group (quantize, im2col,
           torch._int_mm, dequantize) timed beside the bf16 cuDNN
           convolutions of the float path at the same shapes
  train-kernels  the two training kernels against their plain versions at
           the train step's shapes (ROI-pool backward within its stated
           tolerance, two launches bitwise equal, also on small edge cases:
           shared rows and bins, ties, map edges, an all-invalid image,
           one-cell-wide rois, bins of more than 8 rows; first-max pool
           backward bitwise, also against the library backward), with
           CUDA-event times and bounds
  train    the Trainer (vgg_small, duplo, 450x800, batch 8): one float32
           step through the kernels against one through the plain versions
           (losses and gradients); then bf16 steps with the library pool
           backward and with the kernel, with the launch counts of every
           kernel read around the kernel run; then the ROI-pool backward on
           the inputs of one more bf16 step (kept by a hook on its wrapper):
           against its plain version, two launches bitwise equal, its time
           and bound; the ROI-pool forward bitwise on one more step's own
           inputs, and its device time per step
  train-profile  device time of a bf16 train step by kernel group and the
           busy share, as the profile phase does for detect
  data     train from image files and evaluate mAP: 40 training, 16
           validation and 4 background seeded 1280x720 frames written as
           PNG, one corrupt PNG listed for training, a duplo CSV, the
           manifest; which decoder reads them (the native host library
           where it builds, else the numpy PNG reader); where the library
           built, 4 batches of its path against 4 of the Python path; the
           host's ms per batch, bare and through PrefetchingIterator, and
           the corrupt file skipped and logged; 6 bf16 Trainer steps from
           the prefetcher (finite losses, none skipped, the ROI-pool
           forward and backward and pool backward kernels launched, ms per
           step beside the train phase's fixed batch), a snapshot; the
           trainer's weights in the serving Detector and evaluate_map over
           the validation files (the result, the block0, NMS and ROI-pool
           launches, the wall time); float32 collect_detections through the
           kernels against the plain versions on the same batches; then
           JPEG without the native library or PIL: every fixture of
           ``tools/jpeg_fixtures`` through ``data/jpeg.py``, its RGB
           bytes' SHA-256 equal to PIL's in the fixtures' SOURCES.md (the
           truncated one refused with ValueError), ms per frame of the
           500x375 q90 4:2:0 one beside the PNG reader's on the same
           pixels; ``import-imagenet`` over the fixtures as an ILSVRC DET
           tree with VOC XML annotations, then vgg_large ``train --steps 2
           --plot 0`` from it (imagenet config, bf16, kernels on, B=2):
           finite losses, the train kernels' launches
  train-large  vgg_large training at full width (imagenet config, 201
           classes, bf16, float32 masters, RMSprop, kernels on), B=8, one
           Trainer taking 480x1000 and 1000x480 batches: a float32 step
           through the kernels against one through the plain versions and
           remat on against off, both buckets, at the [train] tolerances;
           bf16 ms/step, the launches per step of the ROI-pool forward and
           backward and the pool backward (1, 1, 4) and their device time
           per step (torch.profiler), each bucket; the peak memory of a
           step with and without remat (torch.cuda.max_memory_allocated)
  train-large-profile  device time of a vgg_large bf16 step by kernel
           group and the busy share
  shapes   every shape the Pallas kernels of rows 1, 2, 3, 4 and 6 take
           beyond the published configurations, each against its plain
           version with its launches, CUDA-event ms, plain ms and bound:
           the ROI pool forward and backward at 9x9, 14x14 and 3x16 bins
           (C=384) and at C=12 and 20 (float32 and bf16), the backward
           also on a 4 x 32768 map and on 188- and 400-row maps (tie
           masks of 2 and 3 words); block0 at F = 8, 24, 96 and 128 (both
           dtypes, float and int8 output); the 2-conv block0 at F = 8, 32
           and 128 in its three modes; NMS at N = 87553 and 120000 (read
           from device memory); then paths (a)-(d) through Detector.detect
           and Trainer.run_step with the kernels on, float32 kernels
           against plain versions as [detect], [detect-int8] and [train]
           match them, and the launches of the path's kernels: (a)
           vgg_small with a 9x9 ROI pool, served and one train step; (b)
           one train step on 3008x480 frames (a 188-row map); (c)
           vgg_small with a first layer of 32 filters served float and
           int8, and the tiny config (8 filters) served; (d) vgg_large
           with a first block of 32 filters, float and int8
  cli      ``python -m frcnn_tpu_torch --device cuda`` in this process on the
           data phase's PNG files with a config JSON that turns the kernels
           on: import-duplo, train (4 steps, snapshots at 2 and 4, metrics,
           plots where matplotlib is installed), evaluate --serving fast,
           demo --count 2, export-t7-model then import-t7-model (weights
           back bitwise); each subcommand's wall time and the launches of
           every kernel it ran; then train again (2 steps, same files and
           seed) with torchrun's variables set (RANK=0, WORLD_SIZE=1), so
           that the CLI's rank path trains in a one-rank NCCL group:
           metrics and step-2 snapshot against the plain run's (bitwise,
           or within the [train] tolerances, as the line says), its
           launches, no process group left, the world size the device
           rule picks on this machine, its wall beside the card's name and
           power limit
  parallel a world-size-1 NCCL process group: a data-parallel float32 step
           (sums, counts, gradients and the skip vote through NCCL
           all-reduces) against ``Trainer``'s step at the [train]
           tolerances, and a one-replica ShardedDetector against the
           Detector
  entry    ``frcnn_tpu_torch.entry.entry()`` (the flagship detect program,
           B=2 zero frames, bf16: shapes and finite values, as zero frames
           propose nothing); the same program in float32 on brick frames
           with weights that carry load, plain versions (as the config
           runs it) against the kernels, proposals and detections nonzero;
           the real-config stage of ``dryrun_multichip`` (vgg_small
           224x800, kernels, remat) over a world-size-1 NCCL group, with
           its kernel launches
  bench    ``frcnn_tpu_torch.bench``'s JSON record for bf16, pallas+s2d,
           int8s+pallas+s2d+s8p and imagenet+int8s+pallas+s2d at B=8, 2
           iterations, each mode's kernel launches per call checked; the
           float32 pallas+s2d program (weights that carry load + stress
           biases; proposals and detections nonzero) through the kernels
           against the plain versions
  profile-stages  ``tools/profile_detect.py`` (default stages and
           tailparts, pallas+s2d) and ``tools/profile_train.py`` (step,
           grad, bwdparts with the kernels), B=8, 450x800: ms per stage
  micro    tools/bench_block0.py (B=2, every variant, then normparts),
           tools/bench_pool_bwd.py and tools/bench_scan.py at 2
           iterations: their lines, and the block0 and pool backward
           kernels' launches in them
  accuracy 24 duplo-scale synthetic scenes and the detect phase's weights
           as a run directory: eval_quant_parity (the four headline
           modes), sweep_conf_gate, recall_attribution (fg 0.5, 0.95),
           analyze_detections; then train_synthetic_eval --scale tiny; 8
           imagenet_smoke photo scenes (mixed orientation) written and
           read back through a BatchIterator, the corrupt ones skipped and
           logged; train_synthetic_eval --scale imagenet_smoke, 8 steps;
           every mAP printed, no accuracy limit

then one JSON line of per-kernel numbers (with ``device_ms``, the device
time per path call where it was measured, NMS's ``device_ms_large`` per
vgg_large 480x1000 detect, ``launches_data``, the launches of the data
phase's training and evaluation, and for the ROI-pool forward and backward
and the pool backward ``launches_train_large`` and
``device_ms_train_large``, per vgg_large train step and bucket,
``launches_cli`` by subcommand, ``launches_dryrun_real`` and
``launches_bench`` by mode, ``launches_micro``, NMS's ``launches_api``
and ``ms_api`` by public call, its ``large_n`` cases (N past 2048: kernel
ms, launches, bound) and ``published`` (the 6000 -> 300 detect: ms and
device ms per detect, device ms by N), the ROI pool's
``launches_data_jpeg`` (the vgg_large steps from JPEG); rows 1, 2, 3, 4
and 6's ``shapes`` (each [shapes] case: its launches, max abs err, ms,
plain ms and bound); row 7's ``mm`` and
``mm_sync`` with ``library_device_ms``, their ``bf16`` mode and their
``chain`` shape, ``mm``'s ``chain_sweep``), the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero without that line; a watchdog ends the run with a
traceback once it has taken BUDGET_S seconds. It needs one CUDA card and
never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import importlib
import importlib.util
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
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

LARGE_HW = ((480, 1000), (1000, 480))   # the imagenet buckets
# (batch, H, W) whose 4 x 32 pooled tiles (the tiles of both block0
# kernels) are ragged at the image edges and whose tile count (27, 300) is
# no multiple of the card's 132 SMs: the persistent grid's last round is
# partial
RAGGED = ((1, 66, 130), (2, 200, 330))
# the vgg_large feature maps (the pnet's four ceil pools of each bucket)
LARGE_FM = ((30, 63, 512), (63, 30, 512))

# the plain NMS module; ``frcnn_tpu_torch.ops.nms`` is the function that
# the package exports, as the JAX package's ``frcnn_tpu.ops.nms`` is
NMS_MODULE = "frcnn_tpu_torch.ops.nms"
KERNEL_MODULES = ("frcnn_tpu_torch.ops.nms_kernel",
                  "frcnn_tpu_torch.ops.roi_pool_kernel",
                  "frcnn_tpu_torch.ops.block0_kernel",
                  "frcnn_tpu_torch.ops.block0_2conv_kernel",
                  "frcnn_tpu_torch.ops.pool_bwd_kernel",
                  "frcnn_tpu_torch.ops.matmul_kernel")

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by type
HBM_BPS = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.int8: 1979e12}


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
    return bound_ms_of(n_bytes, {dtype: n_ops})


def bound_ms_of(n_bytes: float, ops: dict):
    """:func:`bound_ms` for work of several types: ``ops`` {dtype:
    operations}, each at its own peak."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = sum(n / PEAK_OPS[dt] for dt, n in ops.items()) * 1e3
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


def _entry_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled ``_ZN...`` name: the
    last of its length-prefixed nested names (the whole name where it has
    none)."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


def phase_build():
    from frcnn_tpu_torch.ops import cuda_lib

    for m in KERNEL_MODULES:        # registers every kernel of the port
        importlib.import_module(m)
    t = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    kernel, spill, source = "?", "", "?"
    for ln in (path.parent / "nvcc.log").read_text().splitlines():
        if ln.startswith("== "):
            source = ln[3:]
        elif "Compiling entry function" in ln:
            k = cuda_lib.ptxas_entry(ln)
            kernel = _entry_name(ln.split("'")[1]) if k is None else k.entry
            if k is not None:   # the instance's mangled template arguments
                args = ln.split(k.entry, 1)[1]
                kernel += " " + args.split("EEv")[0] if args[:1] == "I" else ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            print(f"[build] ptxas: {source}: {kernel}: "
                  f"{ln.split(':', 1)[-1].strip()}; {spill}", flush=True)
        elif "ptxas" in ln and "warning" in ln.lower():
            # e.g. C7508: setmaxnreg ignored
            print(f"[build] {source}: {ln.strip()}", flush=True)
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


def _nms_edge_inputs(gen):
    """(name, boxes [b, n, 4], valid [b, n], thr, max_out) on the card, in
    processing order: the kernel's 64-box chunk edges in N and in max_out
    (more survivors than max_out), NaN and infinite coordinates (a pick
    reads them as the Pallas kernel does), an image with no valid box, and
    N = 2048, the most that every block of the cluster stages whole."""
    def clutter(b, n):
        xy = torch.randint(0, 120, (b, n, 2), generator=gen).float()
        wh = torch.randint(4, 50, (b, n, 2), generator=gen).float()
        boxes = torch.cat([xy, xy + wh], -1)
        boxes[:, 5::9] = boxes[:, 4::9][:, : boxes[:, 5::9].shape[1]]
        return boxes, torch.rand((b, n), generator=gen) > 0.15

    def sparse(b, n):
        k = torch.arange(n)
        xy = torch.stack([(k % 16) * 40, (k // 16) * 40], -1).float()
        xy = xy + torch.randint(0, 4, (b, n, 2), generator=gen)
        xy[:, 1::3] = xy[:, 0:-1:3][:, : xy[:, 1::3].shape[1]] + 3
        wh = torch.randint(20, 34, (b, n, 2), generator=gen).float()
        return torch.cat([xy, xy + wh], -1), torch.ones(b, n, dtype=torch.bool)

    cases = []
    for n in (1, 63, 64, 65, 200):
        cases.append((f"N={n}", *clutter(3, n), 0.25, 128))
    for m in (1, 63, 64, 65):
        cases.append((f"N=200 max_out={m}", *sparse(2, 200), 0.25, m))
    boxes, valid = clutter(3, 96)
    boxes[0, 0, 2] = float("nan")          # the first pick is NaN
    valid[0, 0] = True
    boxes[1, 10::13, 1] = float("nan")     # later boxes NaN
    valid[2, 3:5] = False                  # invalid boxes, NaN and inf
    boxes[2, 3, 3] = float("nan")
    boxes[2, 4, 0] = float("inf")
    cases.append(("NaN and inf", boxes, valid, 0.1, 64))
    boxes, valid = clutter(3, 96)
    valid[1] = False
    cases.append(("an image with no valid box", boxes, valid, 0.1, 64))
    cases.append(("N=2048", *_scattered(gen, B, 2048), 0.25, 128))
    return [(nm, b.cuda(), v.cuda(), t, m) for nm, b, v, t, m in cases]


def _scattered(gen, b: int, n: int, span=(800.0, 450.0), lo=8, hi=60):
    """[b, n] floored boxes scattered over ``span``, 10% invalid (CPU)."""
    xy = torch.rand((b, n, 2), generator=gen) * torch.tensor(
        [span[0] - hi, span[1] - hi])
    wh = torch.randint(lo, hi, (b, n, 2), generator=gen).float()
    return (torch.cat([xy, xy + wh], -1).floor(),
            torch.rand((b, n), generator=gen) > 0.1)


def _nms_large_inputs(gen):
    """(name, boxes, valid, thr, max_out) on the card past 2048 boxes,
    where each block stages only its share of the image: the published
    proposal NMS (IoU 0.7, 300 picks) at N = 2049, 6000, 35232 (the most
    anchors of any bucket) and the kernel's limit, B = 8; many picks over
    many chunks (N = 2049, 1000 picks); and NaN and infinite coordinates
    at N = 2500."""
    from frcnn_tpu_torch.ops.nms_kernel import MAX_BOXES

    cases = [(f"N={n}", *_scattered(gen, B, n, (1000.0, 1000.0), 8, 160),
              0.7, 300) for n in (2049, 6000, 35232, MAX_BOXES)]
    cases.append(("N=2049 1000 picks", *_scattered(
        gen, 2, 2049, (3000.0, 3000.0), 8, 40), 0.25, 1000))
    boxes, valid = _scattered(gen, 3, 2500, (1000.0, 1000.0), 8, 160)
    boxes[1, 2100::97, 1] = float("nan")    # later boxes NaN
    valid[2, 2300:2302] = False             # invalid boxes, NaN and inf
    boxes[2, 2300, 3] = float("nan")
    boxes[2, 2301, 0] = float("inf")
    cases.append(("N=2500 NaN and inf", boxes, valid, 0.5, 300))
    return [(nm, b.cuda(), v.cuda(), t, m) for nm, b, v, t, m in cases]


def _nms_equal(K, plain, boxes, valid, thr: float, max_out: int, what: str):
    """The kernel's keep mask and slots equal the plain version's bitwise;
    returns the plain (keep, slots)."""
    keep, slots = K.nms_keep_slots(boxes, valid, thr, max_out)
    torch.cuda.synchronize()
    ref_keep, ref_slots = plain.nms_keep_slots(boxes, valid, thr, max_out)
    if not torch.equal(keep, ref_keep):
        raise AssertionError(f"nms {what}: keep masks differ in "
                             f"{int((keep != ref_keep).sum())} places")
    if not torch.equal(slots, ref_slots):
        raise AssertionError(f"nms {what}: slots differ in "
                             f"{int((slots != ref_slots).sum())} places")
    return ref_keep, ref_slots


def _nms_ious(boxes, valid, keep, thr: float) -> int:
    """The IoUs greedy NMS needs on these (finite) inputs: one for each
    kept box against each later valid box still alive when it is kept.
    Per image, over the kept rows only (in chunks), carrying the count of
    earlier picks that suppress each box: memory O(rows x N)."""
    total = 0
    n = boxes.shape[1]
    later = torch.arange(n, device=boxes.device)
    for b in range(boxes.shape[0]):
        x0, y0, x1, y1 = boxes[b].unbind(-1)
        area = (x1 - x0 + 1.0) * (y1 - y0 + 1.0)
        kept = keep[b].nonzero()[:, 0]
        before = torch.zeros(n, dtype=torch.int32, device=boxes.device)
        step = max(1, (1 << 24) // n)
        for k in kept.split(step):
            iw = (torch.minimum(x1[None, :], x1[k, None])
                  - torch.maximum(x0[None, :], x0[k, None]) + 1.0).clamp(
                      min=0)
            ih = (torch.minimum(y1[None, :], y1[k, None])
                  - torch.maximum(y0[None, :], y0[k, None]) + 1.0).clamp(
                      min=0)
            inter = iw * ih
            sup = (~(inter / (area[None, :] + area[k, None] - inter)
                     <= thr)).int()
            prior = before[None, :] + sup.cumsum(0) - sup   # picks before
            need = valid[b][None, :] & (prior == 0) & (later[None, :]
                                                       > k[:, None])
            total += int(need.sum())
            before += sup.sum(0, dtype=torch.int32)
    return total


def _nms_stats(keep, boxes, valid, thr: float, max_out: int):
    """(picks per image as text, the work's bound in ms, its 'by')."""
    picks = keep.sum(1).cpu()
    b, n = valid.shape
    n_bytes = b * n * (16 + 1 + 1) + b * max_out * 4
    bms, by = bound_ms(n_bytes, 13.0 * _nms_ious(boxes, valid, keep, thr),
                       torch.float32)
    text = (f"picks per image {int(picks.min())}-{int(picks.max())} (mean "
            f"{float(picks.float().mean()):.1f}), {int(picks.sum())} per "
            f"launch")
    return text, bms, by


def check_nms(gen):
    plain = importlib.import_module(NMS_MODULE)
    from frcnn_tpu_torch.ops import nms_kernel as K

    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for n, thr in ((512, 0.25), (128, 0.1)):
        t = time.perf_counter()
        boxes, valid = _nms_inputs(gen, n)
        keep, _ = _nms_equal(K, plain, boxes, valid, thr, 128,
                             f"B={B} N={n}")
        ms = time_ms(lambda: K.nms_keep_slots(boxes, valid, thr, 128))
        pms = time_ms(lambda: plain.nms_keep_slots(boxes, valid, thr, 128),
                      reps=10)
        picks, bms, by = _nms_stats(keep, boxes, valid, thr, 128)
        out["ms"] += ms
        out["plain_ms"] += pms
        out["bound_ms"] += bms
        out["bound_by"] = by
        log("kernels", f"nms_keep_mask B={B} N={n} thr={thr}: keep masks "
            f"and slots equal; {picks}; kernel {ms:.4f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.6f} ms ({by}); no single PyTorch "
            f"call computes greedy NMS", t)
    t = time.perf_counter()
    for name, boxes, valid, thr, m in _nms_edge_inputs(gen):
        keep, _ = _nms_equal(K, plain, boxes, valid, thr, m, name)
        picks = keep.sum(1).tolist()
        text = f"{picks}" if len(picks) <= 3 else \
            f"{min(picks)}-{max(picks)} per image"
        if valid.shape[1] == 2048:
            ms = time_ms(lambda: K.nms_keep_slots(boxes, valid, thr, m))
            text += f", kernel {ms:.4f} ms"
        print(f"[kernels] nms {name}: keep masks and slots equal; picks "
              f"{text}", flush=True)
    log("kernels", "nms edge cases: keep masks and slots equal", t)
    t = time.perf_counter()
    if K.max_boxes() != K.MAX_BOXES:
        raise AssertionError(f"nms: the kernel takes {K.max_boxes()} boxes "
                             f"on this card, the wrapper {K.MAX_BOXES}")
    out["large_n"] = {}
    for name, boxes, valid, thr, m in _nms_large_inputs(gen):
        before = K.KERNEL.launches
        keep, _ = _nms_equal(K, plain, boxes, valid, thr, m, name)
        launches = K.KERNEL.launches - before
        ms = time_ms(lambda: K.nms_keep_slots(boxes, valid, thr, m), reps=5,
                     warmup=1)
        picks, bms, by = _nms_stats(keep, boxes, valid, thr, m)
        r = {"B": valid.shape[0], "N": valid.shape[1], "max_out": m,
             "ms": ms, "launches": launches, "bound_ms": bms,
             "bound_by": by}
        if name == "N=6000":
            r["plain_ms"] = time_ms(
                lambda: plain.nms_keep_slots(boxes, valid, thr, m), reps=3,
                warmup=0)
        out["large_n"][name] = r
        extra = f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else ""
        print(f"[kernels] nms_keep_mask B={r['B']} {name} thr={thr} "
              f"max_out={m}: keep masks and slots bitwise the plain "
              f"version's, {launches} launch; {picks}; kernel {ms:.4f} ms"
              f"{extra}, bound {bms:.6f} ms ({by})", flush=True)
    log("kernels", f"nms past 2048 boxes (each block stages its share): "
        f"equal up to the limit, N = {K.MAX_BOXES} = max_boxes() on this "
        f"card", t)
    out["library_ms"] = None
    return out


def _kept_nms(fn):
    """Run ``fn()`` with a hook on the NMS kernel's entry; returns the
    inputs (cloned) of every call. ``cuda_nms`` looks the entry up at each
    call, so the hook sees the calls of any Detector."""
    from frcnn_tpu_torch.ops import nms_kernel as K

    kept = []
    real = K.nms_keep_slots

    def keep(boxes, valid, thr, max_out):
        kept.append((boxes.clone(), valid.clone(), thr, max_out))
        return real(boxes, valid, thr, max_out)

    K.nms_keep_slots = keep
    try:
        fn()
    finally:
        K.nms_keep_slots = real
    torch.cuda.synchronize()
    return kept


def check_nms_detect(phase: str, what: str, fn, device: bool = False):
    """NMS on the inputs of one detect (``fn()``, both calls): the kernel's
    keep mask and slots bitwise its plain version's, each call's picks,
    kernel time (CUDA events, through the wrapper) and bound; with
    ``device``, each call's device time (torch.profiler, 10 launches),
    returned by N."""
    plain = importlib.import_module(NMS_MODULE)
    from frcnn_tpu_torch.ops import nms_kernel as K

    t = time.perf_counter()
    calls = _kept_nms(fn)
    if len(calls) != 2:
        raise AssertionError(f"{phase} {what}: {len(calls)} NMS calls in "
                             f"one detect, expected 2")
    parts, dev = [], {}
    for k, (boxes, valid, thr, m) in enumerate(calls):
        keep, _ = _nms_equal(K, plain, boxes, valid, thr, m,
                             f"{phase} {what} call {k + 1}")
        ms = time_ms(lambda: K.nms_keep_slots(boxes, valid, thr, m))
        picks, bms, by = _nms_stats(keep, boxes, valid, thr, m)
        text = ""
        if device:
            got = kernel_device_ms(
                lambda: K.nms_keep_slots(boxes, valid, thr, m),
                ["nms_keep_kernel"])
            dev[valid.shape[1]] = None if got is None else \
                got["nms_keep_kernel"][0]
            text = ", device " + ("not measured" if got is None else
                                  f"{dev[valid.shape[1]]:.4f} ms")
        parts.append(f"call {k + 1} (N={valid.shape[1]}, thr {thr}, "
                     f"{int(valid.sum())} valid): {picks}; kernel "
                     f"{ms:.4f} ms{text}, bound {bms:.6f} ms ({by})")
    log(phase, f"nms on a {what} detect's own inputs: keep masks and slots "
        f"bitwise equal; " + "; ".join(parts), t)
    return dev


def _roi_inputs(gen, shape, D, span: float, n_valid=None, dtype=None):
    """[B, H, W, C] map on the card and D prepared rects per image of up
    to ``span`` of the map; all valid, or ``n_valid`` of D on average."""
    from frcnn_tpu_torch.ops import roi_pool as plain

    H, W, C = shape
    fm = torch.randn(B, H, W, C, generator=gen).to(
        dtype or torch.bfloat16).cuda()
    p0 = torch.rand(B, D, 2, generator=gen) * torch.tensor([W, H])
    ext = torch.rand(B, D, 2, generator=gen) * torch.tensor([W, H]) * span
    raw = torch.cat([p0 - 2, p0 + ext], dim=-1).floor()
    rects = plain.prepare_roi_rects(raw, float(W), float(H)).cuda()
    if n_valid is None:
        valid = torch.ones(B, D, dtype=torch.bool)
    else:
        valid = torch.rand(B, D, generator=gen) < n_valid / D
    return fm, rects, valid.cuda()


def _roi_equal(K, plain, fm, rects, valid, what: str, k: int = 6):
    """The ROI-pool kernel bitwise equal to its plain version (max is
    order-free, so nothing may differ); returns the kernel's output."""
    got = K.adaptive_max_pool_valid(fm, rects, valid, k, k)
    torch.cuda.synchronize()
    ref = plain.adaptive_max_pool(fm, rects, valid, k, k)
    bits = torch.int16 if fm.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(bits), ref.view(bits)):
        n = int((got.view(bits) != ref.view(bits)).sum())
        raise AssertionError(f"roi_pool {what}: kernel and plain outputs "
                             f"differ in {n} values")
    return got


def check_roi_pool(gen):
    from frcnn_tpu_torch.ops import roi_pool as plain
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    t = time.perf_counter()
    for name, fm32, rects, valid, _ in _roi_edge_cases(gen):
        for dt in (torch.float32, torch.bfloat16):
            _roi_equal(K, plain, fm32.to(dt), rects, valid,
                       f"{name} {str(dt)[6:]}")
    log("kernels", "roi_pool on the backward's edge cases (rects smaller "
        "than the grid sharing rows and bins, ties across rows and columns, "
        "map edges, an all-invalid image, one-cell-wide rects, tall bins), "
        "float32 and bf16: bitwise equal", t)
    k = 6
    for shape, D, n_valid in ((LARGE_FM[0], 128, None),
                              (LARGE_FM[1], 128, None),
                              (FM_HWC, TRAIN_ROIS, 96)):
        t = time.perf_counter()
        fm, rects, valid = _roi_inputs(gen, shape, D, 0.8, n_valid)
        for dt in (torch.bfloat16, torch.float32):
            _roi_equal(K, plain, fm.to(dt), rects, valid,
                       f"fm {(B, *shape)} {str(dt)[6:]} D={D}")
        ms = time_ms(lambda: K.adaptive_max_pool_valid(fm, rects, valid, k,
                                                       k))
        log("kernels", f"roi_pool fm {(B, *shape)}, {D} rects/image "
            f"({int(valid.sum())} valid): bitwise equal in bf16 and float32; "
            f"bf16 kernel {ms:.4f} ms", t)
    t = time.perf_counter()
    D = 128
    fm, rects, valid = _roi_inputs(gen, FM_HWC, D, 0.8)
    _roi_equal(K, plain, fm.float(), rects, valid, "serving shape float32")
    got = _roi_equal(K, plain, fm, rects, valid, "serving shape bf16")
    ms = time_ms(lambda: K.adaptive_max_pool_valid(fm, rects, valid, k, k))
    pms = time_ms(lambda: plain.adaptive_max_pool(fm, rects, valid, k, k),
                  reps=10)
    bms, by = _roi_bound(fm, rects, valid, got, k)
    log("kernels", f"roi_pool fm {tuple(fm.shape)} bf16, {D} rects/image: "
        f"bitwise equal (and in float32); kernel {ms:.4f} ms, plain "
        f"{pms:.3f} ms, bound {bms:.5f} ms ({by}); no single PyTorch call "
        f"pools a batch of rects", t)
    return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": 0.0, "library_ms": None}


def _roi_bound(fm, rects, valid, out, k: int, kw=None):
    """Least time of the ROI-pool forward on these inputs: the map, rects,
    valid flags and output moved once; one compare per window cell of
    each valid roi's bins (k x k bins, or k x kw)."""
    C = fm.shape[-1]
    kw = k if kw is None else kw
    r = rects.to(torch.int64)[valid].cpu()
    ext_x = (r[:, 2] - r[:, 0])[:, None]
    ext_y = (r[:, 3] - r[:, 1])[:, None]
    bx, by_ = torch.arange(kw), torch.arange(k)
    bins_x = -torch.div(-(bx + 1) * ext_x, kw, rounding_mode="floor") \
        - torch.div(bx * ext_x, kw, rounding_mode="floor")
    bins_y = -torch.div(-(by_ + 1) * ext_y, k, rounding_mode="floor") \
        - torch.div(by_ * ext_y, k, rounding_mode="floor")
    n_cmp = float((bins_y.sum(-1) * bins_x.sum(-1)).sum()) * C
    n_bytes = (fm.numel() + out.numel()) * fm.element_size() \
        + rects.numel() * 4 + valid.numel()
    return bound_ms(n_bytes, n_cmp, fm.dtype)


def _block0_values(K, l, c, w27, b32, slope):
    """block0 against its plain version on the planes (l, c): float32
    rtol/atol 1e-4 (the same float32 sums in another order, no TF32);
    bf16 rtol/atol 1e-2 (both round one float32 sum to bf16 once: one bf16
    ulp apart). Returns (kernel output, max abs err, max rel err, values
    that differ)."""
    got = K.fused_block0(l, c, w27, b32, slope)
    torch.cuda.synchronize()
    ref = K.block0_plain(l, c, w27, b32, slope)
    err = (got.float() - ref.float()).abs()
    rel = float((err / ref.float().abs().clamp(min=1e-3)).max())
    tol = 1e-4 if l.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)
    return got, float(err.max()), rel, int((err > 0).sum())


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
    # ragged tiles, a random pad ring, and a negative slope (PReLU is then
    # not monotone: the kernel's other epilogue)
    ragged = [K.pack_padded(torch.randn(n, h + 2, w_ + 2, 3, generator=gen)
                            .cuda()) for n, h, w_ in RAGGED]
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        w27, b32 = K.block0_weights(w, bias, dt)
        for (n, h, w_), planes in zip(RAGGED, ragged):
            for a in (0.25, -0.5):
                l, c = (p.to(dt) for p in planes)
                _, err, rel, n_mis = _block0_values(
                    K, l, c, w27, b32, torch.tensor([a], device="cuda"))
                log("kernels", f"fused_block0 {str(dt)[6:]} B={n} {h}x{w_} "
                    f"(ragged tiles, random pad ring, slope {a}): max abs "
                    f"err {err:.3g}, max rel err {rel:.3g}, {n_mis} values "
                    f"differ", t)
        l, c = lum4.to(dt), chroma.to(dt)
        got, err, rel, n_mis = _block0_values(K, l, c, w27, b32, slope)
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
                   "bound_by": by, "max_abs_err": err,
                   "library_ms": lib_ms}
        log("kernels", f"fused_block0 {str(dt)[6:]} B={B} {H}x{W}: max abs "
            f"err {err:.3g}, max rel err {rel:.3g}, {n_mis} of "
            f"{got.numel()} values differ; kernel {ms:.4f} ms, plain "
            f"{pms:.3f} ms, conv+prelu+pool call {lib_ms:.4f} ms, bound "
            f"{bms:.5f} ms ({by})", t)
    return res[torch.bfloat16]


def _bf16_ulp(m: float) -> float:
    """One bf16 unit in the last place at magnitude ``m``."""
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _check_2conv_values(K, l, c, p):
    """The 2-conv kernel against its plain version on the planes (l, c);
    returns (kernel output, max abs error, tolerance text, values that
    differ)."""
    got = K.fused_block0_2conv(l, c, *p)
    torch.cuda.synchronize()
    ref = K.block0_2conv_plain(l, c, *p)
    err = (got.float() - ref.float()).abs()
    peak = float(ref.float().abs().max())
    if l.dtype == torch.float32:
        # the same float32 sums in another order, no TF32
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        tol = "rtol/atol 1e-4"
    else:
        # y0 is rounded to bf16 in both from float32 sums taken in another
        # order (a value may round the other way), and the output is
        # rounded once: within 2 ulps of the largest output
        lim = 2 * _bf16_ulp(peak)
        if float(err.max()) > lim:
            raise AssertionError(f"block0_2conv bf16 {tuple(got.shape)}: max "
                                 f"abs err {float(err.max()):.3g} > {lim:.3g}")
        tol = f"2 bf16 ulps of {peak:.3g} = {lim:.3g}"
    return got, float(err.max()), tol, int((err > 0).sum())


def check_block0_2conv(gen):
    from frcnn_tpu_torch.ops import block0_2conv_kernel as K
    from frcnn_tpu_torch.ops.block0_kernel import pack_padded

    t = time.perf_counter()
    Fo = 64
    # random pad rings: the kernel must mask y0 outside the image itself
    P = {hw: torch.randn(B, hw[0] + 2, hw[1] + 2, 3, generator=gen).cuda()
         for hw in LARGE_HW}
    std = (2.0 / (9 * Fo)) ** 0.5          # the seeded init's MSRA fan-out
    w0 = (torch.randn(Fo, 3, 3, 3, generator=gen) * std).cuda()
    w1 = (torch.randn(Fo, Fo, 3, 3, generator=gen) * std).cuda()
    b0 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    b1 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    s0, s1 = 0.25, 0.1
    ragged = [pack_padded(torch.randn(n, h + 2, w + 2, 3, generator=gen)
                          .cuda()) for n, h, w in RAGGED]
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        p = K.block0_2conv_weights(w0, b0, w1, b1, s0, s1, dt)
        for (n, h, w), planes in zip(RAGGED, ragged):
            l, c = (x.to(dt) for x in planes)
            _, err, tol, n_mis = _check_2conv_values(K, l, c, p)
            log("kernels", f"fused_block0_2conv {str(dt)[6:]} B={n} {h}x{w} "
                f"(ragged tiles, random pad ring): max abs err {err:.3g} "
                f"({tol}; {n_mis} values differ)", t)
        # the portrait bucket's shape: values only (partial column tiles)
        H, W = LARGE_HW[1]
        l, c = (x.to(dt) for x in pack_padded(P[LARGE_HW[1]]))
        _, err, tol, n_mis = _check_2conv_values(K, l, c, p)
        log("kernels", f"fused_block0_2conv {str(dt)[6:]} B={B} {H}x{W} "
            f"(random pad ring): max abs err {err:.3g} ({tol}; {n_mis} "
            f"values differ)", t)
        H, W = LARGE_HW[0]
        l, c = (x.to(dt) for x in pack_padded(P[LARGE_HW[0]]))
        got, max_err, tol, n_mis = _check_2conv_values(K, l, c, p)
        ms = time_ms(lambda: K.fused_block0_2conv(l, c, *p))
        pms = time_ms(lambda: K.block0_2conv_plain(l, c, *p), reps=5,
                      warmup=1)
        n_ops = 2.0 * B * H * W * Fo * (27 + 9 * Fo)
        n_bytes = (l.numel() + c.numel() + p.w0.numel() + p.w1.numel()
                   + got.numel()) * l.element_size() + 4 * (2 * Fo + 2)
        bms, by = bound_ms(n_bytes, n_ops, dt)
        # yardstick the port never calls: conv + prelu + conv + prelu +
        # pool through cuDNN in dt, channels_last
        xi = P[LARGE_HW[0]][:, 1:-1, 1:-1].permute(0, 3, 1, 2).to(dt) \
            .contiguous(memory_format=torch.channels_last)
        w0d, w1d = (w.to(dt).contiguous(memory_format=torch.channels_last)
                    for w in (w0, w1))
        b0d, b1d = b0.to(dt), b1.to(dt)
        a0 = torch.tensor([s0], device="cuda", dtype=dt)
        a1 = torch.tensor([s1], device="cuda", dtype=dt)
        lib_ms = time_ms(lambda: F.max_pool2d(F.prelu(F.conv2d(F.prelu(
            F.conv2d(xi, w0d, b0d, padding=1), a0), w1d, b1d, padding=1),
            a1), 2, ceil_mode=True), reps=10)
        res[dt] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                   "bound_by": by, "max_abs_err": max_err,
                   "library_ms": lib_ms}
        log("kernels", f"fused_block0_2conv {str(dt)[6:]} B={B} {H}x{W} "
            f"(random pad ring): max abs err {max_err:.3g} ({tol}; {n_mis} "
            f"of {got.numel()} values differ); kernel {ms:.4f} ms, plain "
            f"{pms:.3f} ms, conv+prelu+conv+prelu+pool calls {lib_ms:.4f} "
            f"ms, bound {bms:.5f} ms ({by})", t)
        del got, xi
        torch.cuda.empty_cache()
    return res


API_N = 512          # the detect's proposals per image (duplo max_proposals)
API_CLASSES = 6
API_MAX_OUT = 128    # duplo max_detections


def phase_api(kernels, smi: str):
    """The package's public API on the card (see the module docstring);
    adds ``launches_api`` and ``ms_api`` by call to the NMS kernel's
    entry."""
    import frcnn_tpu_torch
    from frcnn_tpu_torch import ops
    from frcnn_tpu_torch.detect.detector import CLASS_NMS_IOU, PROPOSAL_NMS_IOU
    from frcnn_tpu_torch.ops import nms_kernel as K

    t = time.perf_counter()
    names = [getattr(frcnn_tpu_torch, n).__name__
             for n in frcnn_tpu_torch.__all__]
    if names != frcnn_tpu_torch.__all__:
        raise AssertionError(f"api: top-level names resolve to {names}")
    gen = torch.Generator().manual_seed(17)

    def inputs(n: int):
        boxes, _ = _nms_inputs(gen, n)
        scores = torch.rand((B, n), generator=gen)
        scores[:, 1::17] = scores[:, 0:-1:17][:, : scores[:, 1::17].shape[1]]
        valid = torch.rand((B, n), generator=gen) > 0.1
        classes = torch.randint(0, API_CLASSES, (B, n), generator=gen)
        return boxes, scores.cuda(), classes.cuda(), valid.cuda()

    def one_launch(what: str, fn, args):
        """``fn(*args)``: one launch of row 1 and no other kernel, indices
        and validity bitwise the same call's on CPU copies."""
        _zero_launches()
        idx, ok = fn(*args)
        torch.cuda.synchronize()
        launches = _launches()
        if launches != {K.KERNEL.name: 1}:
            raise AssertionError(f"api {what}: launches {launches}, "
                                 f"expected one of {K.KERNEL.name}")
        ref_idx, ref_ok = fn(*(a.cpu() for a in args))
        if not (torch.equal(idx.cpu(), ref_idx)
                and torch.equal(ok.cpu(), ref_ok)):
            raise AssertionError(
                f"api {what}: indices differ from the CPU copies' in "
                f"{int((idx.cpu() != ref_idx).sum())} places")
        return ok

    args = inputs(API_N)
    calls = {
        "nms": lambda b, s, c, v: ops.nms(b, s, v, PROPOSAL_NMS_IOU,
                                          API_MAX_OUT),
        "per_class_nms": lambda b, s, c, v: ops.per_class_nms(
            b, s, c, v, API_CLASSES, CLASS_NMS_IOU, API_MAX_OUT),
        "nms_unbatched": lambda b, s, c, v: ops.nms(
            b[0], s[0], v[0], PROPOSAL_NMS_IOU, API_MAX_OUT),
    }
    entry = kernels["nms_keep_mask"]
    entry["launches_api"], entry["ms_api"] = {}, {}
    parts = []
    for name, fn in calls.items():
        ok = one_launch(name, fn, args)
        ms = time_ms(lambda: fn(*args))
        entry["launches_api"][name] = 1
        entry["ms_api"][name] = ms
        picks = ok.reshape(-1, API_MAX_OUT).sum(1)
        parts.append(f"{name}: 1 launch, picks per image "
                     f"{int(picks.min())}-{int(picks.max())}, {ms:.4f} ms")
    # past 2048 boxes per image, where each block stages its share
    for n in (2049, 6000):
        big = inputs(n)
        for name in ("nms", "per_class_nms"):
            ok = one_launch(f"{name} N={n}", calls[name], big)
            entry["launches_api"][f"{name}_N{n}"] = 1
            picks = ok.reshape(-1, API_MAX_OUT).sum(1)
            parts.append(f"{name} N={n}: 1 launch, picks per image "
                         f"{int(picks.min())}-{int(picks.max())}")
    # past the largest staged image the blocks read their boxes from
    # device memory; past MAX_DIRECT (the alive bitset fills the shared
    # memory) a ValueError names the limit before any launch
    for n in (K.MAX_BOXES + 1, K.MAX_DIRECT + 1):
        big = (torch.zeros((1, n, 4), device="cuda"),
               torch.zeros((1, n), device="cuda"),
               torch.zeros((1, n), dtype=torch.int64, device="cuda"),
               torch.ones((1, n), dtype=torch.bool, device="cuda"))
        for name in ("nms", "per_class_nms"):
            if n <= K.MAX_DIRECT:
                one_launch(f"{name} N={n}", calls[name], big)
                entry["launches_api"][f"{name}_N{n}"] = 1
                continue
            _zero_launches()
            try:
                calls[name](*big)
            except ValueError as e:
                if str(K.MAX_DIRECT) not in str(e) or _launches():
                    raise AssertionError(f"api {name} N={n}: {e}; launches "
                                         f"{_launches()}") from e
            else:
                raise AssertionError(f"api {name} N={n}: no ValueError")
    log("api", f"nine top-level names resolve; B={B} N={API_N} "
        f"{API_CLASSES} classes thr {PROPOSAL_NMS_IOU}/{CLASS_NMS_IOU} "
        f"max_out {API_MAX_OUT}, indices bitwise the CPU copies': "
        + "; ".join(parts) + f"; N={K.MAX_BOXES + 1} (past the staged "
        f"limit) 1 launch each, bitwise the CPU copies'; N={n} (past the "
        f"kernel's limit) raises ValueError, no launch; {smi}", t)


def phase_kernels():
    """Returns (the kernels' bf16 numbers by name, the 2-conv block0's by
    dtype)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    res = {"nms_keep_mask": check_nms(gen),
           "roi_pool": check_roi_pool(gen),
           "fused_block0": check_block0(gen)}
    two_conv = check_block0_2conv(gen)
    res["fused_block0_2conv"] = two_conv[torch.bfloat16]
    return res, two_conv


# -- kernels-int8 -------------------------------------------------------------

def _inv(s):
    """float32 [1] reciprocal 1/s on the card (a true division)."""
    return torch.ones(1, device="cuda") / s.reshape(1)


def _absmax_scale(x):
    """abs-max / 127 of ``x`` as a float32 0-dim tensor on the card."""
    return x.float().abs().amax() / torch.full((), 127.0, device="cuda")


def _flips(got, ref, what: str):
    """int8 outputs at most one step apart in under 1% of the values: a
    float32 sum taken in another order may move a value across a rounding
    boundary. Returns (largest step, share of values apart)."""
    d = (got.int() - ref.int()).abs()
    step, share = int(d.max()), float((d > 0).float().mean())
    if step > 1 or share >= 0.01:
        raise AssertionError(f"{what}: int8 outputs {step} steps apart in "
                             f"{100 * share:.4f}% of the values")
    return step, share


def check_block0_s8out(gen):
    from frcnn_tpu_torch.ops import block0_kernel as K

    t = time.perf_counter()
    H, W = IMAGE_HW
    Fo = 64
    planes = K.pack_padded(torch.randn(B, H + 2, W + 2, 3,
                                       generator=gen).cuda())
    w = (torch.randn(Fo, 3, 3, 3, generator=gen) * 0.3).cuda()
    bias = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    slope = torch.tensor([0.25], device="cuda")
    ragged = [K.pack_padded(torch.randn(n, h + 2, w_ + 2, 3, generator=gen)
                            .cuda()) for n, h, w_ in RAGGED]
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        w27, b32 = K.block0_weights(w, bias, dt)

        def s8_values(l, c, what):
            inv = _inv(_absmax_scale(K.block0_plain(l, c, w27, b32, slope)))
            got = K.fused_block0(l, c, w27, b32, slope, inv_out=inv)
            torch.cuda.synchronize()
            ref = K.block0_plain(l, c, w27, b32, slope, inv_out=inv)
            return (got, inv) + _flips(got, ref, what)

        for (n, h, w_), rp in zip(RAGGED, ragged):
            what = f"block0_s8out {str(dt)[6:]} B={n} {h}x{w_}"
            got, _, step, share = s8_values(*(x.to(dt) for x in rp), what)
            log("kernels-int8", f"{what} (ragged tiles, random pad ring): "
                f"int8 out {step} step apart in {100 * share:.5f}% of "
                f"{got.numel()} values", t)
        l, c = (x.to(dt) for x in planes)
        got, inv, step, share = s8_values(l, c, f"block0_s8out {str(dt)[6:]}")
        ms = time_ms(lambda: K.fused_block0(l, c, w27, b32, slope,
                                            inv_out=inv))
        fms = time_ms(lambda: K.fused_block0(l, c, w27, b32, slope))
        pms = time_ms(lambda: K.block0_plain(l, c, w27, b32, slope,
                                             inv_out=inv), reps=10)
        n_ops = 2.0 * B * (H // 2) * (W // 2) * Fo * 4 * 27
        n_bytes = (l.numel() + c.numel() + w27.numel()) * l.element_size() \
            + got.numel() + 4 * (Fo + 2)
        bms, by = bound_ms(n_bytes, n_ops, dt)
        res[dt] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                   "bound_by": by, "max_abs_err": float(step),
                   "library_ms": None}
        log("kernels-int8", f"block0_s8out {str(dt)[6:]} B={B} {H}x{W} "
            f"(random pad ring): int8 out {step} step apart in "
            f"{100 * share:.5f}% of {got.numel()} values; kernel {ms:.4f} "
            f"ms (float output mode {fms:.4f} ms), plain {pms:.3f} ms, bound "
            f"{bms:.5f} ms ({by}); no single PyTorch call computes it", t)
    return res[torch.bfloat16]


def _int8_conv1_values(K, l, c, qa, ws, inv_y, s_y, w1, what):
    """The int8-conv1 kernel with a float output against its plain
    version: beyond the float tolerance (float32 1e-4 of the largest
    output, bf16 2 ulps of it) under 1% of the values, each within 9 y0
    steps (9 taps of one flipped y0 value: 9 * s_y * max|w1|)."""
    got = K.fused_block0_2conv(l, c, *qa, w1_scale=ws, inv_y=inv_y)
    torch.cuda.synchronize()
    ref = K.block0_2conv_plain(l, c, *qa, w1_scale=ws, inv_y=inv_y)
    err = (got.float() - ref.float()).abs()
    peak = float(ref.float().abs().max())
    tol = 1e-4 * peak if l.dtype == torch.float32 else 2 * _bf16_ulp(peak)
    share = float((err > tol).float().mean())
    lim = tol + 9 * float(s_y) * float(w1.abs().max())
    if share >= 0.01 or float(err.max()) > lim:
        raise AssertionError(f"{what} float out: {100 * share:.4f}% of the "
                             f"values beyond {tol:.3g}, max abs err "
                             f"{float(err.max()):.3g} (limit {lim:.3g})")
    return ref, float(err.max()), share


def check_block0_2conv_int8(gen, float_res):
    from frcnn_tpu_torch.models.quant import quantize_weight
    from frcnn_tpu_torch.ops import block0_2conv_kernel as K
    from frcnn_tpu_torch.ops.block0_kernel import pack_padded, unpack_s2d

    t = time.perf_counter()
    Fo = 64
    P = {hw: torch.randn(B, hw[0] + 2, hw[1] + 2, 3, generator=gen).cuda()
         for hw in LARGE_HW}
    std = (2.0 / (9 * Fo)) ** 0.5
    w0 = (torch.randn(Fo, 3, 3, 3, generator=gen) * std).cuda()
    w1 = (torch.randn(Fo, Fo, 3, 3, generator=gen) * std).cuda()
    b0 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    b1 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    w1q, s_w = quantize_weight(w1)
    s0, s1 = 0.25, 0.1
    cases = [(n, (h, w), torch.randn(n, h + 2, w + 2, 3, generator=gen)
              .cuda()) for n, h, w in RAGGED]
    cases += [(B, hw, P[hw]) for hw in (LARGE_HW[1], LARGE_HW[0])]
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        p = K.block0_2conv_weights(w0, b0, w1, b1, s0, s1, dt)
        for n, hw, padded in cases:
            t = time.perf_counter()
            H, W = hw
            l, c = (x.to(dt) for x in pack_padded(padded))
            y0 = F.conv2d(unpack_s2d(l, c).float(), p.w0.float().reshape(
                3, 3, 3, Fo).permute(3, 2, 0, 1), p.b0)
            s_y = _absmax_scale(torch.where(y0 >= 0, y0, s0 * y0))
            del y0
            wq9, ws = K.block0_2conv_weights_q(w1q, s_w, s_y)
            qa = (p.w0, p.b0, wq9, p.b1, p.slopes)
            inv_y = _inv(s_y)
            what = f"block0_2conv_int8 {str(dt)[6:]} B={n} {H}x{W}"
            fl, ferr, fshare = _int8_conv1_values(K, l, c, qa, ws, inv_y,
                                                  s_y, w1, what)
            inv_o = _inv(_absmax_scale(fl))
            del fl
            got = K.fused_block0_2conv(l, c, *qa, w1_scale=ws, inv_y=inv_y,
                                       inv_out=inv_o)
            torch.cuda.synchronize()
            step, share = _flips(got, K.block0_2conv_plain(
                l, c, *qa, w1_scale=ws, inv_y=inv_y, inv_out=inv_o), what)
            fo = K.fused_block0_2conv(l, c, *p, inv_out=inv_o)
            torch.cuda.synchronize()
            fstep, fo_share = _flips(fo, K.block0_2conv_plain(
                l, c, *p, inv_out=inv_o), f"{what} float conv1, int8 out")
            msg = (f"{what} (random pad ring): float out {100 * fshare:.4f}% "
                   f"of values beyond the float tolerance, max abs err "
                   f"{ferr:.3g}; int8 out {step} step apart in "
                   f"{100 * share:.5f}% of {got.numel()} values; float conv1 "
                   f"with int8 out {fstep} step apart in "
                   f"{100 * fo_share:.5f}%")
            if n != B or hw != LARGE_HW[0]:
                log("kernels-int8", msg, t)
                continue
            run = lambda: K.fused_block0_2conv(l, c, *qa, w1_scale=ws,
                                               inv_y=inv_y, inv_out=inv_o)
            ms = time_ms(run)
            f_ms = time_ms(lambda: K.fused_block0_2conv(
                l, c, *qa, w1_scale=ws, inv_y=inv_y))
            fo_ms = time_ms(lambda: K.fused_block0_2conv(l, c, *p,
                                                         inv_out=inv_o))
            pms = time_ms(lambda: K.block0_2conv_plain(
                l, c, *qa, w1_scale=ws, inv_y=inv_y, inv_out=inv_o), reps=5,
                warmup=1)
            n_pix = float(B * H * W)
            ops = {dt: 2.0 * n_pix * Fo * 27,
                   torch.int8: 2.0 * n_pix * Fo * 9 * Fo}
            n_bytes = (l.numel() + c.numel() + p.w0.numel()) \
                * l.element_size() + wq9.numel() + got.numel() \
                + 4 * (3 * Fo + 4)
            bms, by = bound_ms_of(n_bytes, ops)
            res[dt] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "max_abs_err": float(step),
                       "library_ms": None}
            log("kernels-int8", f"{msg}; kernel {ms:.4f} ms (int8 conv1 "
                f"with float out {f_ms:.4f} ms; float conv1 with int8 out "
                f"{fo_ms:.4f} ms; float mode "
                f"{float_res[dt]['ms']:.4f} ms in [kernels]), plain "
                f"{pms:.3f} ms, bound {bms:.5f} ms ({by}); no single "
                f"PyTorch call computes it", t)
            del got, fo
            torch.cuda.empty_cache()
    return res[torch.bfloat16]


def phase_kernels_int8(float_2conv):
    gen = torch.Generator().manual_seed(2)
    return {"block0_s8out": check_block0_s8out(gen),
            "block0_2conv_int8": check_block0_2conv_int8(gen, float_2conv)}


# -- detect -------------------------------------------------------------------

# the colors of the six brick classes the photo checkpoint was trained on
BRICK_COLORS = ((220, 40, 40), (40, 220, 40), (60, 60, 230),
                (230, 230, 40), (230, 40, 230), (40, 230, 230))


def _frames(seed: int, n: int, hw=IMAGE_HW):
    """Seeded synthetic uint8 RGB frames: smooth noise plus six filled
    rectangles each, shaded like toy bricks (lit gradient, lighter top
    face, dark rim) in the six class colors. Returns (frames [n, H, W, 3],
    boxes [n, 6, 4] (x0, y0, x1, y1) float32, classes [n, 6] int32)."""
    H, W = hw
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(40, 215, size=(n, H // 25 + 2, W // 25 + 2, 3))
    t = torch.from_numpy(coarse).permute(0, 3, 1, 2)
    smooth = F.interpolate(t, size=(H, W), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    img = smooth + rng.normal(0, 6, size=(n, H, W, 3))
    boxes = np.zeros((n, 6, 4), np.float32)
    classes = np.zeros((n, 6), np.int32)
    for i in range(n):
        for j in range(6):
            h, w = rng.integers(H // 8, H // 3), rng.integers(W // 10, W // 4)
            y, x = rng.integers(0, H - h), rng.integers(0, W - w)
            classes[i, j] = rng.integers(0, 6)
            boxes[i, j] = (x, y, x + w, y + h)
            color = np.asarray(BRICK_COLORS[classes[i, j]], np.float64)
            g = np.linspace(0.62, 1.05, w)[None, :, None]
            body = np.broadcast_to(color * g, (h, w, 3)).copy()
            top = max(2, h // 6)
            body[:top] = np.minimum(body[:top] * 1.45 + 18, 255)
            body[[0, -1]] *= 0.55
            body[:, [0, -1]] *= 0.55
            img[i, y:y + h, x:x + w] = body
    return np.clip(img, 0, 255).astype(np.uint8), boxes, classes


def _seeded_models(cfg, seed: int = 0, cls_spread: float = 20.0):
    """pnet and cnet of ``cfg`` from the seeded initialisation, made to
    carry load: random class logits are near uniform, so the 0.2
    confidence gate would reject every ROI, and random box regressions
    reach thousands of pixels. ``cls_spread`` scales the class head."""
    from frcnn_tpu_torch.models.factory import init_models

    pnet, cnet = init_models(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        # spread the class logits so the last stage has work
        cnet.cls_head.weight.mul_(cls_spread)
        # keep boxes near their anchors, at the coordinates trained
        # weights give
        for ai in range(len(cfg.model.anchor_nets)):
            w = getattr(pnet, f"anchor{ai}_out").weight
            for j in range(3):
                w[6 * j + 2:6 * j + 6].mul_(0.1)
        cnet.reg_head.weight.mul_(0.1)
    return pnet, cnet


def _load_models(phase: str = "detect"):
    from frcnn_tpu_torch.config import Config, duplo_config, serving_config
    from frcnn_tpu_torch.models.factory import create_models
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
        print(f"[{phase}] {CKPT.relative_to(ROOT)} is absent: seeded "
              f"initialisation at the same widths", flush=True)
        base = duplo_config(class_count=6)
        cfg = serving_config(base.replace(shapes=dataclasses.replace(
            base.shapes, image_hw=IMAGE_HW)))
        pnet, cnet = _seeded_models(cfg)
        src = "seeded initialisation (torch.Generator seed 0)"
    cfg = cfg.replace(detect_fg_threshold=0.5)
    log(phase, f"weights from {src}; {cfg.model.name}, "
        f"{cfg.class_count} classes, bucket {cfg.shapes.image_hw}", t)
    return cfg, pnet, cnet


def _check_f32_detect(phase: str, ker, ref, what: str, t: float,
                      ordered: bool = True):
    """float32 detections through the kernels equal those through the
    plain versions: ``valid``, ``classes`` and ``proposals_valid`` equal,
    boxes within 1e-3, confidence within 1e-4. With ``ordered=False`` two
    detections whose confidences lie within that 1e-4 may stand in either
    order: each image's detections are matched by (class, box) instead of
    by slot, and the slots' confidences must still agree."""
    if not torch.equal(ker.proposals_valid, ref.proposals_valid):
        raise AssertionError(f"{phase} f32 {what}: proposals_valid differs "
                             f"between kernels and plain versions")
    if ordered:
        got, want = ker, ref
    else:
        torch.testing.assert_close(ker.confidence, ref.confidence, rtol=0,
                                   atol=1e-4)
        got, want = (_by_class_and_box(r) for r in (ker, ref))
    for f in ("valid", "classes"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{phase} f32 {what}: {f} differs between "
                                 f"kernels and plain versions")
    torch.testing.assert_close(got.boxes, want.boxes, rtol=0, atol=1e-3)
    torch.testing.assert_close(got.confidence, want.confidence, rtol=0,
                               atol=1e-4)
    log(phase, f"float32 B={ref.valid.shape[0]} {what}: kernels == plain "
        f"versions ({int(ref.proposals_valid.sum())} proposals, "
        f"{int(ref.valid.sum())} detections"
        f"{'' if ordered else ', matched by class and box'})", t)


def _by_class_and_box(res):
    """``res`` with each image's slots ordered by (valid first, class, x0,
    y0) instead of by confidence."""
    keys = torch.stack([(~res.valid).double(), res.classes.double(),
                        res.boxes[..., 0].double(),
                        res.boxes[..., 1].double()], -1).cpu().numpy()
    order = torch.from_numpy(np.stack(
        [np.lexsort(k.T[::-1]) for k in keys])).to(res.valid.device)
    take = lambda x: torch.gather(
        x, 1, order.view(*order.shape, *([1] * (x.dim() - 2))).expand_as(x))
    return res._replace(valid=take(res.valid), classes=take(res.classes),
                        boxes=take(res.boxes),
                        confidence=take(res.confidence))


def phase_detect(kernels):
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops import block0_kernel, nms_kernel, roi_pool_kernel
    from frcnn_tpu_torch.ops.color import unwire_uint8

    modules = {"nms_keep_mask": nms_kernel, "roi_pool": roi_pool_kernel,
               "fused_block0": block0_kernel}
    cfg, pnet, cnet = _load_models()
    frames, _, _ = _frames(1, B)
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
    _check_f32_detect("detect", ker, ref, f"{IMAGE_HW[0]}x{IMAGE_HW[1]}", t)

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
    n_calls = 3
    t_run = time.perf_counter()
    outs = [det.detect(frames, true_hw) for _ in range(n_calls)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_run) / n_calls
    launches = {k: m.KERNEL.launches for k, m in modules.items()}
    dev_ms = time_ms(lambda: det.detect((lum4, chroma), hw_dev), reps=5)
    # uint8 frames already on the card are unwired and packed there
    frames_dev = torch.from_numpy(frames).cuda()
    for a, b in zip(block0_kernel.pack_s2d(
            unwire_uint8(frames_dev, cfg.color_space)), (lum4, chroma)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    card_ms = time_ms(lambda: det.detect(frames_dev, hw_dev), reps=5)
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
    for k, n in launches.items():
        kernels[k]["launches"] = n
    t = time.perf_counter()
    dev = device_ms_per_call(lambda: det.detect((lum4, chroma), hw_dev), {
        k: DEVICE_FRAGMENTS[k] for k in modules})
    for k, v in dev.items():
        kernels[k]["device_ms"] = v
    log("detect", f"device time per bf16 detect (torch.profiler, mean per "
        f"launch x launches per call): {_device_text(dev)}", t)
    check_roi_pool_detect(cfg, pnet, cnet, (lum4, chroma), hw_dev)
    check_nms_detect("detect", f"vgg_small bf16 {IMAGE_HW[0]}x{IMAGE_HW[1]}",
                     lambda: Detector(cfg, pnet, cnet, device="cuda").detect(
                         (lum4, chroma), hw_dev))
    phase_profile(det, (lum4, chroma), hw_dev)
    del det
    detect_published(kernels, cfg, pnet, cnet, frames, true_hw,
                     (lum4, chroma), hw_dev)


# Faster R-CNN's published test setting: 6000 boxes into the proposal NMS
# and 300 out (Ren et al., NeurIPS 2015; py-faster-rcnn's
# TEST.RPN_PRE_NMS_TOP_N and TEST.RPN_POST_NMS_TOP_N)
PUBLISHED = (6000, 300)


def detect_published(kernels, cfg, pnet, cnet, frames, true_hw, planes,
                     hw_dev):
    """The vgg_small serving Detector at :data:`PUBLISHED`: float32
    through the kernels against the plain versions (valid sets and classes
    equal, matched by class and box within 1e-3); bf16 ms per detect, its
    launches (2 of row 1 per detect) and device ms; row 1 bitwise on both
    calls of a detect, with its device ms at N = 6000 and N = 300."""
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops import block0_kernel, nms_kernel, roi_pool_kernel

    k, d = PUBLISHED
    c6 = cfg.replace(shapes=dataclasses.replace(
        cfg.shapes, max_proposals=k, max_detections=d))
    what = f"{IMAGE_HW[0]}x{IMAGE_HW[1]} {k} -> {d} proposals"
    t = time.perf_counter()
    f32 = c6.replace(compute_dtype="float32")
    ker = Detector(f32, pnet, cnet, device="cuda").detect(frames, true_hw)
    ref = Detector(f32.replace(pallas_mode="off"), pnet, cnet,
                   device="cuda").detect(frames, true_hw)
    torch.cuda.synchronize()
    _check_f32_detect("detect-6000", ker, ref, what, t, ordered=False)

    t = time.perf_counter()
    modules = {"nms_keep_mask": nms_kernel, "roi_pool": roi_pool_kernel,
               "fused_block0": block0_kernel}
    det = Detector(c6, pnet, cnet, device="cuda")
    det.detect(planes, hw_dev)                  # warm-up
    torch.cuda.synchronize()
    for m in modules.values():
        m.KERNEL.launches = 0
    n_calls = 3
    t_run = time.perf_counter()
    for _ in range(n_calls):
        out = det.detect(planes, hw_dev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_run) / n_calls * 1e3
    launches = {n: m.KERNEL.launches for n, m in modules.items()}
    want = {n: (2 if n == "nms_keep_mask" else 1) * n_calls for n in modules}
    if launches != want:
        raise AssertionError(f"detect-6000: launches {launches} in "
                             f"{n_calls} calls, expected {want}")
    n_in = int(det.last_counts["proposals_in"].sum())
    n_roi, n_det = int(out.proposals_valid.sum()), int(out.valid.sum())
    if not (n_in > 0 and n_roi > 0 and n_det > 0) or not all(
            torch.isfinite(x).all() for x in (out.boxes, out.confidence)):
        raise AssertionError(f"detect-6000: proposals {n_in}, rois {n_roi}, "
                             f"detections {n_det}, or non-finite outputs")
    log("detect-6000", f"bf16 B={B} {what}: {wall:.2f} ms/batch from packed "
        f"device planes; {n_in} proposals into NMS, {n_roi} rois pooled, "
        f"{n_det} detections; launches {launches} over {n_calls} calls", t)
    dev = profile_run("detect-6000", f"bf16 B={B} {what}",
                      lambda: det.detect(planes, hw_dev), "batch")
    del det
    per_n = check_nms_detect(
        "detect-6000", f"vgg_small bf16 {what}",
        lambda: Detector(c6, pnet, cnet, device="cuda").detect(planes,
                                                               hw_dev),
        device=True)
    kernels["nms_keep_mask"]["published"] = {
        "proposals": k, "detections": d, "ms_per_detect": wall,
        "device_ms_per_detect": dev, "launches_per_detect": 2,
        "device_ms_by_n": per_n}


# kernel -> (name fragment of its bf16 mode in a trace, launches per call)
DEVICE_FRAGMENTS = {
    "nms_keep_mask": ("nms_keep_kernel", 2),
    "roi_pool": ("roi_pool_kernel", 1),
    "fused_block0": ("block0_kernel<__nv_bfloat16, __nv_bfloat16", 1),
    "block0_s8out": ("block0_kernel<__nv_bfloat16, signed char", 1),
}


def device_ms_per_call(fn, frags: dict, n_calls: int = 10):
    """Device ms per call of ``fn()`` of each kernel in ``frags`` {name:
    (fragment, launches per call)}: :func:`kernel_device_ms`'s mean per
    launch times the launches per call. None for each where the trace
    recorded no device time."""
    got = kernel_device_ms(fn, [f for f, _ in frags.values()], n_calls)
    if got is None:
        return dict.fromkeys(frags)
    return {k: got[f][0] * n for k, (f, n) in frags.items()}


def _device_text(dev: dict) -> str:
    return ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f} ms'}"
                     for k, v in dev.items())


def _kept_roi_pool(fn):
    """Run ``fn()`` with a hook on the ROI-pool forward's wrapper; returns
    the inputs of its first call (cloned)."""
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    kept = []
    real = K.adaptive_max_pool_valid

    def keep(fm, rects, valid, kh, kw):
        if not kept:
            kept.append((fm.clone(), rects.clone(), valid.clone(), kh))
        return real(fm, rects, valid, kh, kw)

    K.adaptive_max_pool_valid = keep
    try:
        fn()
    finally:
        K.adaptive_max_pool_valid = real
    torch.cuda.synchronize()
    return kept[0]


def _roi_stats(rects, valid) -> str:
    r = rects.to(torch.int64)[valid].cpu()
    ext = (r[:, 2:] - r[:, :2]).float().mean(0)
    return (f"{int(valid.sum())} valid of {valid.numel()} roi slots, mean "
            f"roi {float(ext[0]):.1f} x {float(ext[1]):.1f} cells")


def check_roi_pool_detect(cfg, pnet, cnet, planes, hw_dev):
    """The ROI-pool forward on the inputs of one bf16 detect (a Detector
    built under a hook on the wrapper, which its program binds): bitwise
    its plain version, and the same inputs in float32; its time and
    bound."""
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops import roi_pool as plain
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    t = time.perf_counter()
    fm, rects, valid, k = _kept_roi_pool(lambda: Detector(
        cfg, pnet, cnet, device="cuda").detect(planes, hw_dev))
    got = _roi_equal(K, plain, fm, rects, valid, "detect's inputs", k)
    _roi_equal(K, plain, fm.float(), rects, valid, "detect's inputs float32",
               k)
    ms = time_ms(lambda: K.adaptive_max_pool_valid(fm, rects, valid, k, k))
    bms, by = _roi_bound(fm, rects, valid, got, k)
    log("detect", f"roi_pool on the detect's own inputs: fm "
        f"{tuple(fm.shape)} {str(fm.dtype)[6:]}, {_roi_stats(rects, valid)}"
        f": bitwise equal (and in float32); kernel {ms:.4f} ms, bound "
        f"{bms:.5f} ms ({by})", t)


PROFILE_GROUPS = (  # kernel-name fragment -> group, first match wins
    ("block0_2conv_kernel<__nv_bfloat16, true", "block0_2conv int8 kernel"),
    ("block0_2conv_kernel", "block0_2conv kernel"),
    ("block0_kernel<__nv_bfloat16, signed char", "block0 s8out kernel"),
    ("block0_kernel", "block0 kernel"), ("nms_keep_kernel", "nms kernel"),
    ("roi_pool_bwd", "roi_pool_bwd kernel"),   # both passes
    ("pool_bwd_kernel", "pool_bwd kernel"),
    ("roi_pool_kernel", "roi_pool kernel"), ("max_pool", "max pool"),
    ("conv", "convolution"), ("fprop", "convolution"),
    ("dgrad", "convolution"), ("wgrad", "convolution"),
    ("gemm_s8", "int8 matmul"), ("gemm", "matmul"), ("sort", "sort"),
    ("Sort", "sort"),
    ("foreach", "optimizer (foreach)"), ("index", "index/scatter"),
    ("scatter", "index/scatter"), ("gather", "index/scatter"),
    ("reduce", "reductions"), ("elementwise", "elementwise"),
)


def profile_run(phase: str, what: str, fn, unit: str, n_calls: int = 3):
    """Device time of ``fn()`` by kernel group (torch.profiler), and the
    busy share of the device: that device time over the wall time of the
    same calls run without the profiler. Returns the device ms per call
    (None where the trace held no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for _ in range(n_calls):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t_run) * 1e6 / n_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_run = time.perf_counter()
        for _ in range(n_calls):
            fn()
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
        log(phase, "torch.profiler recorded no device time: not measured", t)
        return None
    for g, us in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"[{phase}] {g}: {us / 1e3:.3f} ms/{unit} "
              f"({100 * us / busy:.1f}% of device time)", flush=True)
    for name, us in sorted(kernels.items(), key=lambda x: -x[1])[:8]:
        print(f"[{phase}] top kernel {us / 1e3:.3f} ms/{unit}: {name[:200]}",
              flush=True)
    log(phase, f"{what}: {busy / 1e3:.3f} ms/{unit} of device kernels; "
        f"{wall_us / 1e3:.3f} ms/{unit} wall without the profiler (busy "
        f"share {100 * busy / wall_us:.1f}%), {prof_wall_us / 1e3:.3f} "
        f"ms/{unit} under it; {n_launch / n_calls:.0f} kernel launches per "
        f"{unit}", t)
    return busy / 1e3


def kernel_device_ms(fn, fragments, n_calls: int = 10):
    """Mean device ms per launch, and the launches seen, of the kernels
    whose names hold each fragment, from torch.profiler over ``n_calls``
    calls of ``fn()``: a mean per launch, so a launch the trace misses
    does not count as zero time. None where a fragment was never seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(fragments, 0.0)
    seen = dict.fromkeys(fragments, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for f in fragments:
            if f in e.name:
                us[f] += e.time_range.elapsed_us()
                seen[f] += 1
    if not all(seen.values()):
        return None
    return {f: (us[f] / seen[f] / 1e3, seen[f]) for f in fragments}


def phase_profile(det, planes, hw_dev):
    profile_run("profile", f"bf16 serving B={B}",
                lambda: det.detect(planes, hw_dev), "batch")


# -- detect-large ---------------------------------------------------------------

LARGE_CALLS = 3


def phase_detect_large(kernels):
    from frcnn_tpu_torch.config import imagenet_config, serving_config
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops import (
        block0_2conv_kernel,
        block0_kernel,
        nms_kernel,
        roi_pool_kernel,
    )
    from frcnn_tpu_torch.ops.color import unwire_uint8

    modules = {"nms_keep_mask": nms_kernel, "roi_pool": roi_pool_kernel,
               "fused_block0": block0_kernel,
               "fused_block0_2conv": block0_2conv_kernel}
    t = time.perf_counter()
    cfg = serving_config(imagenet_config()).replace(detect_fg_threshold=0.5)
    if cfg.input_layout != "s2d" or cfg.model.layers[0].conv_steps != 2:
        raise AssertionError("imagenet serving must take the s2d 2-conv path")
    # 201 classes and vgg_large's pooled features: a spread of 20 leaves the
    # class logits at a standard deviation of ~0.2 (confidence ~1/201), so
    # they get 25 times more, a deviation of ~5
    pnet, cnet = _seeded_models(cfg, cls_spread=500.0)
    widths = "/".join(str(s.filters) for s in cfg.model.layers)
    log("detect-large", f"seeded initialisation (torch.Generator seed 0); "
        f"{cfg.model.name} ({widths}, conv_steps "
        f"{[s.conv_steps for s in cfg.model.layers]}), {cfg.class_count} "
        f"classes, buckets {cfg.shapes.buckets()}", t)

    # float32 through the kernels == float32 through the plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32")
    ker32 = Detector(cfg32, pnet, cnet, device="cuda")
    ref32 = Detector(cfg32.replace(pallas_mode="off"), pnet, cnet,
                     device="cuda")
    planes = {}
    for seed, hw in enumerate(LARGE_HW):
        t = time.perf_counter()
        frames, _, _ = _frames(3 + seed, B, hw)
        true_hw = torch.tensor([hw] * B, dtype=torch.int32, device="cuda")
        lum4, chroma = (torch.from_numpy(a).cuda() for a in
                        block0_kernel.pack_s2d_np(
                            unwire_uint8(frames, cfg.color_space)))
        got = ker32.detect((lum4, chroma), true_hw)
        ref = ref32.detect((lum4, chroma), true_hw)
        torch.cuda.synchronize()
        # the class head's spread of 500 carries the float32 differences
        # of the convolutions into confidences ~1e-5 apart: detections
        # closer than that may swap slots
        _check_f32_detect("detect-large", got, ref, f"{hw[0]}x{hw[1]}", t,
                          ordered=False)
        planes[hw] = ((lum4, chroma), true_hw)
    del ker32, ref32, got, ref
    torch.cuda.empty_cache()

    # bf16 serving from packed device planes, launch counts read around it
    det = Detector(cfg, pnet, cnet, device="cuda")
    total = 0
    for hw in LARGE_HW:
        t = time.perf_counter()
        pl, true_hw = planes[hw]
        det.detect(pl, true_hw)                 # warm-up
        torch.cuda.synchronize()
        for m in modules.values():
            m.KERNEL.launches = 0
        t_run = time.perf_counter()
        outs = [det.detect(pl, true_hw) for _ in range(LARGE_CALLS)]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_run) / LARGE_CALLS
        launches = {k: m.KERNEL.launches for k, m in modules.items()}
        dev_ms = time_ms(lambda: det.detect(pl, true_hw), reps=5)
        out = outs[-1]
        n_in = int(det.last_counts["proposals_in"].sum())
        n_roi = int(out.proposals_valid.sum())
        n_det = int(out.valid.sum())
        if not (n_in > 0 and n_roi > 0 and n_det > 0):
            raise AssertionError(f"vgg_large bf16 {hw}: empty stage "
                                 f"(proposals {n_in}, rois {n_roi}, "
                                 f"detections {n_det})")
        if not all(torch.isfinite(x).all() for x in
                   (out.boxes, out.confidence, out.fg_score, out.proposals)):
            raise AssertionError(f"vgg_large bf16 {hw}: non-finite outputs")
        want = {"nms_keep_mask": 2 * LARGE_CALLS, "roi_pool": LARGE_CALLS,
                "fused_block0": 0, "fused_block0_2conv": LARGE_CALLS}
        if launches != want:
            raise AssertionError(f"vgg_large bf16 {hw}: launches {launches} "
                                 f"in {LARGE_CALLS} calls, expected {want}")
        total += launches["fused_block0_2conv"]
        log("detect-large", f"bf16 serving B={B} {hw[0]}x{hw[1]}: "
            f"{wall * 1e3:.2f} ms/batch from packed device planes "
            f"({B / wall:.1f} img/s) over {LARGE_CALLS} calls, "
            f"{dev_ms:.2f} ms/batch by CUDA events ({B / dev_ms * 1e3:.1f} "
            f"img/s); {n_in} proposals into NMS, {n_roi} rois pooled, "
            f"{n_det} detections; launches {launches}", t)
        t = time.perf_counter()
        dev = device_ms_per_call(lambda: det.detect(pl, true_hw), {
            "nms_keep_mask": DEVICE_FRAGMENTS["nms_keep_mask"]})
        if hw == LARGE_HW[0]:
            kernels["nms_keep_mask"]["device_ms_large"] = dev["nms_keep_mask"]
        log("detect-large", f"device time per vgg_large bf16 detect "
            f"{hw[0]}x{hw[1]} (torch.profiler): {_device_text(dev)}", t)
        check_nms_detect("detect-large", f"vgg_large bf16 {hw[0]}x{hw[1]}",
                         lambda: det.detect(pl, true_hw))
    kernels["fused_block0_2conv"]["launches"] = total
    profile_run("profile-large", f"vgg_large bf16 serving B={B} "
                f"{LARGE_HW[0][0]}x{LARGE_HW[0][1]}",
                lambda: det.detect(*planes[LARGE_HW[0]]), "batch")
    del det, planes
    torch.cuda.empty_cache()


# -- detect-int8 --------------------------------------------------------------

INT8_CALLS = 3


@contextlib.contextmanager
def _block0_hook(fn):
    """Detect calls inside the block get block 0's output from
    ``fn(compute_s2d_block0, *args, **kwargs)``."""
    from frcnn_tpu_torch.detect import detector as D

    real = D.compute_s2d_block0
    D.compute_s2d_block0 = lambda *a, **k: fn(real, *a, **k)
    try:
        yield
    finally:
        D.compute_s2d_block0 = real


def _match_share(ref, got, iou_min: float = 0.5) -> str:
    """Share of ``ref``'s detections that ``got`` has in the same image,
    of the same class, at IoU >= ``iou_min``, as text ("hits/n = share")."""
    from frcnn_tpu_torch.geometry.boxes import iou_matrix

    n = hit = 0
    for i in range(ref.valid.shape[0]):
        rv, gv = ref.valid[i], got.valid[i]
        n += int(rv.sum())
        if not (rv.any() and gv.any()):
            continue
        same = ref.classes[i][rv][:, None] == got.classes[i][gv][None, :]
        iou = iou_matrix(ref.boxes[i][rv].float(), got.boxes[i][gv].float())
        hit += int(((iou >= iou_min) & same).any(dim=1).sum())
    return f"{hit}/{n} = {hit / n:.4f}" if n else "0/0"


def _int8_batches(cfg, seed: int, buckets):
    """Per bucket: (packed device planes, true_hw on the card) of the
    smoke's frames; and one normalized NHWC batch of other frames of the
    first bucket, the calibration batch."""
    from frcnn_tpu_torch.ops import block0_kernel
    from frcnn_tpu_torch.ops.color import unwire_uint8
    from frcnn_tpu_torch.ops.normalization import normalize_image

    out = {}
    for k, hw in enumerate(buckets):
        frames, _, _ = _frames(seed + k, B, hw)
        planes = tuple(torch.from_numpy(a).cuda() for a in
                       block0_kernel.pack_s2d_np(unwire_uint8(
                           frames, cfg.color_space)))
        out[hw] = (planes, torch.tensor([hw] * B, dtype=torch.int32,
                                        device="cuda"))
    frames, _, _ = _frames(seed + 100, B, buckets[0])
    x = unwire_uint8(torch.from_numpy(frames).cuda(), cfg.color_space)
    hw = out[buckets[0]][1]
    n = cfg.normalization
    calib = normalize_image(x.float(), hw[:, 0], hw[:, 1], method=n.method,
                            width=n.width, centering=n.centering,
                            scaling=n.scaling)
    return out, calib


def _check_f32_int8_detect(phase, cfg, pnet, cnet, batches, calib):
    """float32 int8 detect through the kernels against the plain versions,
    the kernel path's static scales in both. Block 0's int8 output of the
    two paths is held at the int8 tolerance (at most one step apart in
    under 1% of the values); since a single step moves every later
    requantization, the plain path then takes the kernel path's block 0
    output and the detections must match by class and box. Without that
    hand-over, the share of detections that agree is printed."""
    from frcnn_tpu_torch.detect.detector import Detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32")
    ker = Detector(cfg32, pnet, cnet, device="cuda", quantized=True,
                   quant_calibration=calib)
    ref = Detector(cfg32.replace(pallas_mode="off"), pnet, cnet,
                   device="cuda", quantized=True)
    ref.pnet.set_act_scales(ker.pnet.act_scales)
    for hw, (planes, true_hw) in batches.items():
        t = time.perf_counter()
        seen = {}

        def record(real, *a, **k):
            seen["kernel"] = real(*a, **k)
            return seen["kernel"]

        def hand_over(real, *a, **k):
            seen["plain"] = real(*a, **k)
            return seen["kernel"]

        with _block0_hook(record):
            got = ker.detect(planes, true_hw)
        with _block0_hook(hand_over):
            want = ref.detect(planes, true_hw)
        alone = ref.detect(planes, true_hw)
        torch.cuda.synchronize()
        (kb, ks), (pb, ps) = seen["kernel"], seen["plain"]
        if not torch.equal(ks, ps):
            raise AssertionError(f"{phase}: block 0 scales differ")
        step, share = _flips(kb, pb, f"{phase} {hw} block 0")
        log(phase, f"float32 B={B} {hw[0]}x{hw[1]}: block 0's int8 output "
            f"through the kernel {step} step from the plain version's in "
            f"{100 * share:.5f}% of {kb.numel()} values; without handing "
            f"it over, {_match_share(got, alone)} of the kernel path's "
            f"detections agree (class, IoU >= 0.5)", t)
        _check_f32_detect(phase, got, want, f"{hw[0]}x{hw[1]}, block 0 "
                          f"handed over", t, ordered=False)
    del ker, ref
    torch.cuda.empty_cache()


def _int8_family(phase, cfg, pnet, cnet, seed, block0_kernel_name):
    """One model family's int8 serving: the float32 check, then bf16
    batches from packed device planes with launch counts, each bucket.
    Returns (bf16 Detector, batches, launches of the int8 block0 kernel)."""
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY

    buckets = [tuple(b) for b in cfg.shapes.buckets()]
    batches, calib = _int8_batches(cfg, seed, buckets)
    _check_f32_int8_detect(phase, cfg, pnet, cnet, batches, calib)

    t = time.perf_counter()
    det = Detector(cfg, pnet, cnet, device="cuda", quantized=True,
                   quant_calibration=calib)
    fdet = Detector(cfg, pnet, cnet, device="cuda")
    log(phase, f"bf16 Detector calibrated: {len(det.pnet.act_scales)} "
        f"static scales, pool_s8 {det.pnet.pool_s8}", t)
    counted = ("nms_keep_mask", "roi_pool", "fused_block0", "block0_s8out",
               "fused_block0_2conv", "block0_2conv_int8")
    total = 0
    for hw, (planes, true_hw) in batches.items():
        t = time.perf_counter()
        det.detect(planes, true_hw)             # warm-up
        torch.cuda.synchronize()
        for k in counted:
            REGISTRY[k].launches = 0
        t_run = time.perf_counter()
        outs = [det.detect(planes, true_hw) for _ in range(INT8_CALLS)]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_run) / INT8_CALLS
        launches = {k: REGISTRY[k].launches for k in counted}
        dev_ms = time_ms(lambda: det.detect(planes, true_hw), reps=5)
        out = outs[-1]
        n_in = int(det.last_counts["proposals_in"].sum())
        n_roi = int(out.proposals_valid.sum())
        n_det = int(out.valid.sum())
        if not (n_in > 0 and n_roi > 0 and n_det > 0):
            raise AssertionError(f"{phase} bf16 {hw}: empty stage (proposals "
                                 f"{n_in}, rois {n_roi}, detections {n_det})")
        if not all(torch.isfinite(x).all() for x in
                   (out.boxes, out.confidence, out.fg_score, out.proposals)):
            raise AssertionError(f"{phase} bf16 {hw}: non-finite outputs")
        want = {k: 0 for k in counted}
        want.update({"nms_keep_mask": 2 * INT8_CALLS, "roi_pool": INT8_CALLS,
                     block0_kernel_name: INT8_CALLS})
        if launches != want:
            raise AssertionError(f"{phase} bf16 {hw}: launches {launches} in "
                                 f"{INT8_CALLS} calls, expected {want}")
        total += launches[block0_kernel_name]
        share = _match_share(fdet.detect(planes, true_hw), out)
        log(phase, f"int8 bf16 serving B={B} {hw[0]}x{hw[1]}: "
            f"{wall * 1e3:.2f} ms/batch from packed device planes "
            f"({B / wall:.1f} img/s) over {INT8_CALLS} calls, {dev_ms:.2f} "
            f"ms/batch by CUDA events ({B / dev_ms * 1e3:.1f} img/s); {n_in} "
            f"proposals into NMS, {n_roi} rois pooled, {n_det} detections; "
            f"launches {launches}; the int8 path matches {share} of the "
            f"float path's detections (class, IoU >= 0.5)", t)
        check_nms_detect(phase, f"int8 {cfg.model.name} bf16 {hw[0]}x{hw[1]}",
                         lambda: det.detect(planes, true_hw))
    del fdet
    torch.cuda.empty_cache()
    return det, batches, total


def phase_detect_int8(kernels):
    from frcnn_tpu_torch.config import imagenet_config, serving_config

    cfg, pnet, cnet = _load_models("detect-int8")
    det, batches, n = _int8_family("detect-int8", cfg, pnet, cnet, 5,
                                   "block0_s8out")
    kernels["block0_s8out"]["launches"] = n
    t = time.perf_counter()
    planes, true_hw = batches[IMAGE_HW]
    dev = device_ms_per_call(lambda: det.detect(planes, true_hw), {
        k: DEVICE_FRAGMENTS[k] for k in ("block0_s8out", "nms_keep_mask")})
    kernels["block0_s8out"]["device_ms"] = dev["block0_s8out"]
    log("detect-int8", f"device time per vgg_small int8 bf16 detect "
        f"(torch.profiler): {_device_text(dev)}", t)
    profile_int8("vgg_small", det, batches[IMAGE_HW])
    del det, batches
    torch.cuda.empty_cache()

    t = time.perf_counter()
    cfg = serving_config(imagenet_config()).replace(detect_fg_threshold=0.5)
    pnet, cnet = _seeded_models(cfg, cls_spread=500.0)
    log("detect-int8", f"vgg_large: seeded initialisation (torch.Generator "
        f"seed 0, class head x500), buckets {cfg.shapes.buckets()}", t)
    det, batches, n = _int8_family("detect-int8", cfg, pnet, cnet, 7,
                                   "block0_2conv_int8")
    kernels["block0_2conv_int8"]["launches"] = n
    profile_int8("vgg_large", det, batches[LARGE_HW[0]])
    del det, batches
    torch.cuda.empty_cache()


def _conv_layers(cfg, hw):
    """Every conv after block 0 as (group, name, NHWC input shape, kh,
    kw, padding, outputs) at bucket ``hw``, batch B."""
    m = cfg.model
    sizes, (h, w) = [], hw
    for _ in m.layers:
        h, w = -(-h // 2), -(-w // 2)
        sizes.append((h, w))
    out = []
    for bi, spec in enumerate(m.layers):
        if bi == 0:
            continue
        h, w = sizes[bi - 1]
        for si in range(spec.conv_steps):
            cin = m.layers[bi - 1].filters if si == 0 else spec.filters
            out.append((f"block{bi}", f"block{bi}_conv{si}", (B, h, w, cin),
                        spec.kH, spec.kW, (spec.padH, spec.padW),
                        spec.filters))
    for ai, a in enumerate(m.anchor_nets):
        h, w = sizes[a.input - 1]
        cin = m.layers[a.input - 1].filters
        out.append(("anchors", f"anchor{ai}_conv", (B, h, w, cin), a.kW,
                    a.kW, (0, 0), a.n))
        out.append(("anchors", f"anchor{ai}_out",
                    (B, h - a.kW + 1, w - a.kW + 1, a.n), 1, 1, (0, 0), 18))
    return out


def profile_int8(family: str, det, batch):
    """[profile-int8]: the int8 batch by kernel group, then each layer
    group of int8 convolutions (quantize, im2col, torch._int_mm,
    dequantize: ``models/quant.py::qconv``) against bf16 cuDNN
    convolutions with bias at the same shapes (channels_last)."""
    from frcnn_tpu_torch.models.quant import qconv
    from frcnn_tpu_torch.ops import int8_conv

    planes, true_hw = batch
    profile_run("profile-int8", f"{family} int8 bf16 serving B={B} "
                f"{tuple(true_hw[0].tolist())}",
                lambda: det.detect(planes, true_hw), "batch")
    t = time.perf_counter()
    gen = torch.Generator().manual_seed(3)
    groups = {}
    for group, name, shape, kh, kw, (ph, pw), n in _conv_layers(
            det.cfg, tuple(true_hw[0].tolist())):
        layer = det.pnet.convs[name]
        x = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
        s = _absmax_scale(x)
        pad = ((ph, ph), (pw, pw))
        xq = torch.clamp(torch.round(x.float() / s), -127, 127).to(
            torch.int8)
        cols = int8_conv.im2col(xq, kh, kw, pad)
        t_q = time_ms(lambda: qconv(x, layer, pad, torch.bfloat16, s_x=s),
                      reps=5)
        t_col = time_ms(lambda: int8_conv.im2col(xq, kh, kw, pad), reps=5)
        t_mm = time_ms(lambda: torch._int_mm(cols, layer.wmat.t()), reps=5)
        xb = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wb = layer.w_int8.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = layer.bias.to(torch.bfloat16)
        t_bf = time_ms(lambda: F.conv2d(xb, wb, bb, padding=(ph, pw)),
                       reps=5)
        g = groups.setdefault(group, [0, 0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, t_q, t_col, t_mm, t_bf)):
            g[i] += v
        del x, xq, cols, xb
    torch.cuda.empty_cache()
    for group, (n, t_q, t_col, t_mm, t_bf) in groups.items():
        print(f"[profile-int8] {family} {group} ({n} convs): int8 qconv "
              f"{t_q:.4f} ms (im2col {t_col:.4f}, _int_mm {t_mm:.4f}) vs bf16 "
              f"cuDNN conv+bias {t_bf:.4f} ms", flush=True)
    tot = [sum(g[i] for g in groups.values()) for i in range(5)]
    log("profile-int8", f"{family} convs after block 0: int8 {tot[1]:.4f} "
        f"ms/batch vs bf16 {tot[4]:.4f} ms/batch", t)


# -- train kernels --------------------------------------------------------------

FM_HWC = (29, 50, 384)       # the train step's feature map at 450x800
TRAIN_ROIS = 224             # max_positives + max_negatives + max_nearby
POOL_INPUTS = ((64, 450, 800), (128, 225, 400), (256, 113, 200),
               (384, 57, 100))   # (C, H, W) into the four backbone pools
ODD_W_INPUT = (384, 57, 125)     # block 3 at the 450x1000 bucket


def _ulps(a, b):
    """Largest distance in bf16 units in the last place (same-sign
    values; a sign change counts as far apart)."""
    ai = a.view(torch.int16).to(torch.int32)
    bi = b.view(torch.int16).to(torch.int32)
    return int((ai - bi).abs().max())


def _roi_bwd_check(K, plain, fm, rects, valid, g, k, what):
    """The ROI-pool backward kernel against its plain version on one input:
    float32 within atol 1e-6 (the same sums in the same order: rois, then
    bins), bf16 within one ulp (both round those float32 sums once); and
    two launches bitwise equal (no atomics). Returns (max abs err, the
    tolerance's text)."""
    got = K.adaptive_max_pool_valid_backward(fm, rects, valid, g, k, k)
    again = K.adaptive_max_pool_valid_backward(fm, rects, valid, g, k, k)
    torch.cuda.synchronize()
    ref = plain.adaptive_max_pool_backward(fm, rects, valid, g, k, k)
    if not torch.equal(got.view(torch.uint8), again.view(torch.uint8)):
        raise AssertionError(f"roi_pool_bwd {what}: two launches differ")
    err = float((got.float() - ref.float()).abs().max())
    if fm.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
        return err, "atol 1e-6"
    if _ulps(got, ref) > 1:
        raise AssertionError(f"roi_pool_bwd {what}: {_ulps(got, ref)} ulps "
                             f"apart")
    return err, "one bf16 ulp"


def _roi_bwd_bytes(fm, rects, valid, k):
    """Least traffic of the ROI-pool backward: fm read, the valid rois' g
    read, dfm written, rects and valid read."""
    C = fm.shape[-1]
    return (2 * fm.numel() + int(valid.sum()) * k * k * C) \
        * fm.element_size() + rects.numel() * 4 + valid.numel()


def _roi_edge_cases(gen):
    """Small inputs (on the card) the two-pass design has to get right:
    rois sharing rows and bins, ties across rows and columns of one bin,
    rois on the map's edges, an image with every slot invalid, one-cell
    wide rois, and bins of more than 8 rows (mask bits past the first
    byte)."""
    B_, C, D = 2, 16, 8
    for name in ("shared_rows_bins", "ties_rows_cols", "map_edges",
                 "image_all_invalid", "one_cell_wide", "tall_bins"):
        H, W = (63, 13) if name == "tall_bins" else (11, 13)
        fm = torch.randint(0, 4, (B_, H, W, C), generator=gen).float() / 4
        xy = torch.stack([torch.randint(0, W - 4, (B_, D), generator=gen),
                          torch.randint(0, H - 4, (B_, D), generator=gen)],
                         -1)
        rects = torch.cat([xy, xy + torch.randint(1, 5, (B_, D, 2),
                                                  generator=gen)], -1)
        valid = torch.ones(B_, D, dtype=torch.bool)
        fixed = {"shared_rows_bins": [[1, 2, 10, 9], [1, 2, 10, 9],
                                      [4, 2, 13, 9], [2, 3, 5, 5]],
                 "ties_rows_cols": [[2, 2, 9, 8], [3, 2, 6, 5],
                                    [0, 0, 13, 11]],
                 "map_edges": [[0, 0, W, H], [W - 1, H - 1, W, H],
                               [0, H - 3, W, H], [W - 4, 0, W, 5]],
                 "one_cell_wide": [[4, 0, 5, H], [0, 3, W, 4], [6, 6, 7, 7],
                                   [W - 1, 2, W, 9]],
                 "tall_bins": [[0, 0, W, H], [2, 1, 9, 60]]}.get(name, [])
        if fixed:
            rects[:, :len(fixed)] = torch.tensor(fixed)
        if name == "ties_rows_cols":
            top = torch.rand(B_, 6, 6, C, generator=gen) < 0.5
            fm[:, 2:8, 3:9] = torch.where(top, 1.0, fm[:, 2:8, 3:9])
        if name == "image_all_invalid":
            valid[1] = False
            valid[0, ::3] = False
        g = torch.randn(B_, D, 6, 6, C, generator=gen)
        yield name, fm.cuda(), rects.float().cuda(), valid.cuda(), g.cuda()


ROI_PASSES = ("roi_pool_bwd_ties_kernel", "roi_pool_bwd_kernel")


def _roi_pass_split(run, n_calls: int = 10):
    """The ROI-pool backward's two passes' device time, as text."""
    split = kernel_device_ms(run, ROI_PASSES, n_calls)
    if split is None:
        return "pass split not measured (no device time in the profile)"
    (ms1, n1), (ms2, n2) = (split[f] for f in ROI_PASSES)
    return (f"device time per launch: pass 1 (tie masks) {ms1:.4f} ms + "
            f"pass 2 (scatter) {ms2:.4f} ms = {ms1 + ms2:.4f} ms, "
            f"torch.profiler, {n1} and {n2} of {n_calls} launches seen")


def check_roi_pool_bwd(gen):
    from frcnn_tpu_torch.ops import roi_pool as plain
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    t = time.perf_counter()
    for name, fm32, rects, valid, g32 in _roi_edge_cases(gen):
        for dt in (torch.float32, torch.bfloat16):
            _roi_bwd_check(K, plain, fm32.to(dt), rects, valid, g32.to(dt),
                           6, f"{name} {str(dt)[6:]}")
    log("train-kernels", "roi_pool_bwd edge cases (shared rows and bins, "
        "ties across rows and columns, map edges, an all-invalid image, "
        "one-cell-wide rois, bins of more than 8 rows), float32 and bf16: "
        "kernel == plain version at the stated tolerances, two launches "
        "bitwise equal", t)
    t = time.perf_counter()
    H, W, C = FM_HWC
    D, k = TRAIN_ROIS, 6
    # four levels: ties inside bins and between overlapping bins
    fm32 = (torch.randint(0, 4, (B, H, W, C), generator=gen).float()
            / 4).cuda()
    p0 = torch.rand(B, D, 2, generator=gen) * torch.tensor([W, H])
    ext = torch.rand(B, D, 2, generator=gen) * torch.tensor([W, H]) * 0.6
    raw = torch.cat([p0 - 2, p0 + ext], dim=-1).floor()
    rects = plain.prepare_roi_rects(raw, float(W), float(H)).cuda()
    valid = (torch.rand(B, D, generator=gen) < 96 / D).cuda()
    g32 = torch.randn(B, D, k, k, C, generator=gen).cuda()
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        fm, g = fm32.to(dt), g32.to(dt)
        err, tol = _roi_bwd_check(K, plain, fm, rects, valid, g, k,
                                  str(dt)[6:])
        run = lambda: K.adaptive_max_pool_valid_backward(
            fm, rects, valid, g, k, k)
        ms = time_ms(run)
        split = _roi_pass_split(run)
        # one call: the plain version takes ~1 s here
        pms = time_ms(lambda: plain.adaptive_max_pool_backward(
            fm, rects, valid, g, k, k), reps=1, warmup=0)
        n_valid = int(valid.sum())
        # operations: two compares per window cell of the forward's
        # recompute
        r = rects.to(torch.int64)[valid].cpu()
        cells = float(((r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])).sum())
        bms, by = bound_ms(_roi_bwd_bytes(fm, rects, valid, k),
                           2.0 * cells * C, dt)
        res[dt] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                   "bound_by": by, "max_abs_err": err, "library_ms": None}
        log("train-kernels", f"roi_pool_bwd {str(dt)[6:]} fm {tuple(fm.shape)}"
            f", {D} roi slots/image, {n_valid} valid: max abs err {err:.3g} "
            f"({tol}; two launches bitwise equal); kernel {ms:.4f} ms ("
            f"{split}), plain {pms:.3f} ms, bound {bms:.5f} ms ({by}); no "
            f"single PyTorch call computes it", t)
    return res[torch.bfloat16]


def check_roi_pool_bwd_step(trainer, batch):
    """The ROI-pool backward on the inputs of one bf16 train step, kept by
    a hook on the wrapper: against the plain version (bf16, and the same
    inputs in float32), two launches bitwise equal, its time and bound."""
    from frcnn_tpu_torch.ops import roi_pool as plain
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    t = time.perf_counter()
    kept = []
    real = K.adaptive_max_pool_valid_backward

    def keep(fm, rects, valid, g, kh, kw):
        if not kept:
            kept.append((fm.clone(), rects.clone(), valid.clone(), g.clone(),
                         kh))
        return real(fm, rects, valid, g, kh, kw)

    K.adaptive_max_pool_valid_backward = keep
    try:
        trainer.run_step(batch)
    finally:
        K.adaptive_max_pool_valid_backward = real
    torch.cuda.synchronize()
    fm, rects, valid, g, k = kept[0]
    g = g.to(fm.dtype)
    err, tol = _roi_bwd_check(K, plain, fm, rects, valid, g, k, "train step")
    err32, tol32 = _roi_bwd_check(K, plain, fm.float(), rects, valid,
                                  g.float(), k, "train step float32")
    run = lambda: K.adaptive_max_pool_valid_backward(fm, rects, valid, g,
                                                     k, k)
    ms = time_ms(run)
    split = _roi_pass_split(run)
    bms, by = bound_ms(_roi_bwd_bytes(fm, rects, valid, k), 0.0, fm.dtype)
    log("train", f"roi_pool_bwd on the step's own inputs: fm "
        f"{tuple(fm.shape)} {str(fm.dtype)[6:]}, {_roi_stats(rects, valid)}"
        f": max abs err {err:.3g} ({tol}), float32 "
        f"{err32:.3g} ({tol32}), two launches bitwise equal; kernel "
        f"{ms:.4f} ms ({split}), bound {bms:.5f} ms ({by})", t)


def check_roi_pool_step(trainer, batch, res):
    """The ROI-pool forward on the inputs of one bf16 train step, kept by
    a hook on the wrapper: bitwise its plain version; its device time per
    step."""
    from frcnn_tpu_torch.ops import roi_pool as plain
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    t = time.perf_counter()
    fm, rects, valid, k = _kept_roi_pool(lambda: trainer.run_step(batch))
    _roi_equal(K, plain, fm.detach(), rects, valid, "train step's inputs", k)
    dev = device_ms_per_call(lambda: trainer.run_step(batch), {
        "roi_pool": DEVICE_FRAGMENTS["roi_pool"]}, n_calls=5)
    res["device_ms_train_step"] = dev["roi_pool"]
    log("train", f"roi_pool on the step's own inputs ({str(fm.dtype)[6:]}, "
        f"{_roi_stats(rects, valid)}): bitwise equal; device time per step "
        f"(torch.profiler): {_device_text(dev)}", t)


def check_pool_bwd(gen):
    from frcnn_tpu_torch.ops import pool_bwd as plain
    from frcnn_tpu_torch.ops import pool_bwd_kernel as K

    t = time.perf_counter()
    lib_bwd = torch.ops.aten.max_pool2d_with_indices_backward
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "max_abs_err": 0.0}
    for (C, H, W) in POOL_INPUTS + (ODD_W_INPUT,):
        for dt in (torch.bfloat16, torch.float32):
            # three levels: ties in most windows, routed to the first max
            x = (torch.randint(0, 3, (B, C, H, W), generator=gen)
                 .to(dt).cuda().contiguous(memory_format=torch.channels_last))
            y, idx = F.max_pool2d(x, 2, 2, ceil_mode=True,
                                  return_indices=True)
            g = torch.randn(y.shape, generator=gen).to(dt).cuda() \
                .contiguous(memory_format=torch.channels_last)
            xh, gh = x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1)
            got = K.ceil_max_pool_2x2_bwd(xh, gh)
            torch.cuda.synchronize()
            ref = plain.ceil_max_pool_2x2_bwd(xh, gh)
            lib = lib_bwd(g, x, [2, 2], [2, 2], [0, 0], [1, 1], True, idx)
            lib = lib.permute(0, 2, 3, 1)
            for name, other in (("plain", ref), ("library", lib)):
                if not torch.equal(got, other):
                    raise AssertionError(
                        f"pool_bwd {str(dt)[6:]} {(B, H, W, C)}: kernel and "
                        f"{name} backward differ in "
                        f"{int((got != other).sum())} places")
            if dt != torch.bfloat16:
                continue
            ms = time_ms(lambda: K.ceil_max_pool_2x2_bwd(xh, gh))
            pms = time_ms(lambda: plain.ceil_max_pool_2x2_bwd(xh, gh),
                          reps=5)
            lms = time_ms(lambda: lib_bwd(g, x, [2, 2], [2, 2], [0, 0],
                                          [1, 1], True, idx))
            bms, by = bound_ms((2 * x.numel() + g.numel()) * 2,
                               3.0 * x.numel(), dt)
            log("train-kernels", f"pool_bwd x {(B, H, W, C)}: bitwise equal "
                f"to the plain and library backwards (bf16 and f32); bf16 "
                f"kernel {ms:.4f} ms, plain {pms:.3f} ms, max_pool2d backward "
                f"{lms:.4f} ms, bound {bms:.5f} ms ({by})", t)
            if (C, H, W) != ODD_W_INPUT:     # the 450x800 step's four pools
                tot["ms"] += ms
                tot["plain_ms"] += pms
                tot["library_ms"] += lms
                tot["bound_ms"] += bms
                tot["bound_by"] = by
            del x, y, idx, g, got, ref, lib
    torch.cuda.empty_cache()
    log("train-kernels", f"pool_bwd over the four pools of a 450x800 step "
        f"(bf16): kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.3f} ms, "
        f"max_pool2d backward {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.5f} ms", t)
    return tot


def phase_train_kernels():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    return {"roi_pool_bwd": check_roi_pool_bwd(gen),
            "pool_bwd": check_pool_bwd(gen)}


# -- train ----------------------------------------------------------------------

TRAIN_WARMUP, TRAIN_STEPS = 2, 5


def _train_config(compute: str):
    from frcnn_tpu_torch.config import duplo_config

    base = duplo_config()
    return base.replace(
        pallas_mode="on", compute_dtype=compute,
        shapes=dataclasses.replace(base.shapes, image_hw=IMAGE_HW,
                                   images_per_step=B))


def _train_batch(cfg, seed: int, hw=IMAGE_HW, b: int = B):
    """A TrainBatch on the card: ``b`` seeded uint8 frames of bucket
    ``hw`` (unwired by the objective), their six shaded rectangles as gt
    boxes and classes."""
    from frcnn_tpu_torch.train.objective import TrainBatch

    frames, boxes, classes = _frames(seed, b, hw)
    G = cfg.shapes.max_gt
    gt = np.zeros((b, G, 4), np.float32)
    gc = np.zeros((b, G), np.int32)
    gm = np.zeros((b, G), bool)
    gt[:, :6], gc[:, :6], gm[:, :6] = boxes, classes, True
    true_hw = np.tile(np.asarray([hw], np.int32), (b, 1))
    return TrainBatch(frames, true_hw, gt, gc, gm,
                      np.zeros(b, bool)).to("cuda")


def _step_grads(cfg, batches, pool_vjp: str):
    """``[(new batch stats, metrics, gradients)]``, one per batch of
    ``batches``, from one fresh Trainer of ``cfg`` (seed 0) that takes
    them in order: trainers of other configs given the same batches draw
    the same labels and masks."""
    from frcnn_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device="cuda", seed=0, pool_vjp=pool_vjp)
    out = []
    for b in batches:
        _, (bs, metrics), grads = tr.compute_gradients(b)
        out.append((bs, metrics, grads))
    torch.cuda.synchronize()
    del tr
    return out


def _assert_steps_close(phase: str, what: str, a, b):
    """Step ``a`` against step ``b`` (:func:`_step_grads`): losses and
    counts rtol 1e-5, batch-norm statistics rtol 1e-5, every gradient
    within 1e-4 of its tensor's largest magnitude. Returns (the largest
    relative gradient error, its tensor)."""
    (bs_k, m_k, g_k), (bs_p, m_p, g_p) = a, b
    for k in ("pcls", "preg", "dcls", "dreg", "cls_count", "reg_count"):
        torch.testing.assert_close(m_k[k], m_p[k], rtol=1e-5, atol=0,
                                   msg=lambda m, k=k: f"{what}: {k}: {m}")
    worst, worst_name = 0.0, next(iter(g_p))
    for name in g_p:
        x, y = g_k[name], g_p[name]
        if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
            raise AssertionError(f"{phase} {what}: non-finite gradient "
                                 f"{name}")
        rel = float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    for name in bs_p:
        torch.testing.assert_close(bs_k[name], bs_p[name], rtol=1e-5,
                                   atol=1e-7)
    # limit: float32 convolutions and matmuls may sum in another order
    # in the two runs (cuDNN/cuBLAS algorithms); the ported kernels
    # themselves route bitwise
    limit = 1e-4
    if worst > limit:
        raise AssertionError(f"{phase} {what}: gradient {worst_name} "
                             f"relative error {worst:.3g} over the {limit} "
                             f"limit")
    return worst, worst_name


def _f32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _check_f32_step(batch):
    """One float32 step through the kernels against one through the plain
    versions: same parameters, batch and generator seed, so the labels and
    dropout masks are the same draws."""
    t = time.perf_counter()
    _f32()
    cfg = _train_config("float32")
    (ker,) = _step_grads(cfg, [batch], "kernel")
    (ref,) = _step_grads(cfg.replace(pallas_mode="off"), [batch], "library")
    worst, worst_name = _assert_steps_close("train", "float32", ker, ref)
    m_k = ker[1]
    losses = ", ".join(f"{k} {float(m_k[k]):.6g}"
                       for k in ("pcls", "preg", "dcls", "dreg"))
    log("train", f"float32 B={B}: kernels == plain versions: losses "
        f"{losses} (rtol 1e-5), cls_count {float(m_k['cls_count']):.0f}, "
        f"reg_count {float(m_k['reg_count']):.0f}; largest relative gradient "
        f"error {worst:.3g} ({worst_name}; limit 1e-4)", t)


def phase_train(kernels):
    from frcnn_tpu_torch.ops import pool_bwd_kernel, roi_pool_kernel
    from frcnn_tpu_torch.train.trainer import Trainer

    counted = {"roi_pool": roi_pool_kernel.KERNEL,
               "roi_pool_bwd": roi_pool_kernel.BWD_KERNEL,
               "pool_bwd": pool_bwd_kernel.KERNEL}
    cfg = _train_config("float32")
    batch = _train_batch(cfg, 2)
    _check_f32_step(batch)
    torch.cuda.empty_cache()

    cfg = _train_config("bfloat16")
    steps_ms, trainer = {}, None
    for vjp in ("library", "kernel"):
        t = time.perf_counter()
        trainer = Trainer(cfg, device="cuda", seed=0, pool_vjp=vjp)
        for _ in range(TRAIN_WARMUP):
            trainer.run_step(batch)
        torch.cuda.synchronize()
        for k in counted.values():
            k.launches = 0
        pool_bwd_kernel.KERNEL.grad_copies = 0
        t_run = time.perf_counter()
        ms = [trainer.run_step(batch) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_run) / TRAIN_STEPS
        launches = {k: v.launches for k, v in counted.items()}
        steps_ms[vjp] = wall * 1e3
        for m in ms:
            if m["skipped"] != 0 or not all(
                    np.isfinite(m[k]) for k in ("pcls", "preg", "dcls",
                                                "dreg")):
                raise AssertionError(f"bf16 train ({vjp}): skipped or "
                                     f"non-finite step {m}")
        want = {"roi_pool": TRAIN_STEPS, "roi_pool_bwd": TRAIN_STEPS,
                "pool_bwd": 4 * TRAIN_STEPS if vjp == "kernel" else 0}
        if launches != want:
            raise AssertionError(f"bf16 train ({vjp}): launches {launches}, "
                                 f"expected {want}")
        last = ms[-1]
        log("train", f"bf16 B={B} {IMAGE_HW[0]}x{IMAGE_HW[1]}, pool "
            f"backward {vjp}: {wall * 1e3:.2f} ms/step, {B / wall:.1f} img/s "
            f"over {TRAIN_STEPS} steps (after {TRAIN_WARMUP}); launches per "
            f"step {({k: v / TRAIN_STEPS for k, v in launches.items()})}; "
            f"cotangent layout copies {pool_bwd_kernel.KERNEL.grad_copies}; "
            f"last step pcls {last['pcls']:.4f} preg {last['preg']:.4f} dcls "
            f"{last['dcls']:.4f} dreg {last['dreg']:.4f}, cls_count "
            f"{last['cls_count']:.0f}, reg_count {last['reg_count']:.0f}, "
            f"skipped 0 in every step", t)
        if vjp == "kernel":
            for k in ("roi_pool_bwd", "pool_bwd"):
                kernels[k]["launches"] = launches[k]
            check_roi_pool_bwd_step(trainer, batch)
            check_roi_pool_step(trainer, batch, kernels["roi_pool"])
        else:
            del trainer
            torch.cuda.empty_cache()
    profile_run("train-profile", f"bf16 train step B={B}, pool backward "
                f"kernel", lambda: trainer.run_step(batch), "step")
    return steps_ms


# -- vgg_large training --------------------------------------------------------

LARGE_TRAIN_STEPS = 3
# rows 2, 4 and 5 in a train step's trace: (name test, launches per step)
TRAIN_DEVICE = {
    "roi_pool": (lambda n: "roi_pool_kernel" in n, 1),
    "roi_pool_bwd": (lambda n: "roi_pool_bwd" in n, 2),   # both passes
    "pool_bwd": (lambda n: "pool_bwd_kernel" in n and "roi_pool" not in n,
                 4),
}


def _large_train_config(compute: str, remat: bool = False):
    from frcnn_tpu_torch.config import imagenet_config

    cfg = imagenet_config(pallas_mode="on", compute_dtype=compute,
                          remat=remat)
    assert cfg.shapes.images_per_step == B
    return cfg


def train_device_ms(fn, n_calls: int = 2):
    """Device ms per step of rows 2, 4 and 5 (:data:`TRAIN_DEVICE`) over
    ``n_calls`` steps ``fn()`` under torch.profiler: the mean per launch
    seen times the launches per step; None where none was seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(TRAIN_DEVICE, 0.0)
    seen = dict.fromkeys(TRAIN_DEVICE, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k, (match, _) in TRAIN_DEVICE.items():
            if match(e.name):
                us[k] += e.time_range.elapsed_us()
                seen[k] += 1
    return {k: (us[k] / seen[k] / 1e3 * TRAIN_DEVICE[k][1] if seen[k]
                else None) for k in TRAIN_DEVICE}


def _peak_step_mib(trainer, batch):
    """(peak MiB allocated during one step, MiB allocated before it)."""
    trainer.run_step(batch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.run_step(batch)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20, before / 2**20


def _check_f32_large(batches):
    """vgg_large float32 at full width, both buckets: one step through the
    kernels against one through the plain versions, and with remat against
    without, at the [train] tolerances."""
    t = time.perf_counter()
    _f32()
    cfg = _large_train_config("float32")
    ker = _step_grads(cfg, batches, "kernel")
    ref = _step_grads(cfg.replace(pallas_mode="off"), batches, "library")
    rem = _step_grads(cfg.replace(remat=True), batches, "kernel")
    for b, a, r, m in zip(batches, ker, ref, rem):
        hw = tuple(b.image.shape[1:3])
        worst, name = _assert_steps_close("train-large", f"float32 {hw}",
                                          a, r)
        worst_r, name_r = _assert_steps_close(
            "train-large", f"float32 remat {hw}", m, a)
        losses = ", ".join(f"{k} {float(a[1][k]):.6g}"
                           for k in ("pcls", "preg", "dcls", "dreg"))
        print(f"[train-large] float32 B={B} {hw[0]}x{hw[1]}: kernels == "
              f"plain versions: losses {losses} (rtol 1e-5), cls_count "
              f"{float(a[1]['cls_count']):.0f}, reg_count "
              f"{float(a[1]['reg_count']):.0f}; largest relative gradient "
              f"error {worst:.3g} ({name}; limit 1e-4); remat on == off: "
              f"losses rtol 1e-5, largest relative gradient error "
              f"{worst_r:.3g} ({name_r})", flush=True)
    del ker, ref, rem
    torch.cuda.empty_cache()
    log("train-large", "float32 checks done", t)


def phase_train_large(kernels):
    """vgg_large training at full width (imagenet config, 201 classes,
    bf16 compute, float32 masters, RMSprop, kernels on), B=8, both
    buckets through one Trainer."""
    from frcnn_tpu_torch.ops import pool_bwd_kernel, roi_pool_kernel
    from frcnn_tpu_torch.train.trainer import Trainer

    counted = {"roi_pool": roi_pool_kernel.KERNEL,
               "roi_pool_bwd": roi_pool_kernel.BWD_KERNEL,
               "pool_bwd": pool_bwd_kernel.KERNEL}
    batches = [_train_batch(_large_train_config("float32"), 40 + i, hw)
               for i, hw in enumerate(LARGE_HW)]
    _check_f32_large(batches)

    t = time.perf_counter()
    cfg = _large_train_config("bfloat16")
    trainer = Trainer(cfg, device="cuda", seed=0)
    peak = {}
    for b in batches:          # the first step of each bucket: warm-up
        peak[(tuple(b.image.shape[1:3]), False)] = _peak_step_mib(trainer, b)
    for k in counted:
        kernels[k]["launches_train_large"] = {}
        kernels[k]["device_ms_train_large"] = {}
    step_ms = {}
    for b in batches:
        hw = tuple(b.image.shape[1:3])
        torch.cuda.synchronize()
        for k in counted.values():
            k.launches = 0
        t_run = time.perf_counter()
        ms = [trainer.run_step(b) for _ in range(LARGE_TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_run) / LARGE_TRAIN_STEPS
        step_ms[(hw, False)] = wall * 1e3
        launches = {k: v.launches for k, v in counted.items()}
        for m in ms:
            if m["skipped"] != 0 or not all(
                    np.isfinite(m[k]) for k in ("pcls", "preg", "dcls",
                                                "dreg")):
                raise AssertionError(f"train-large bf16 {hw}: skipped or "
                                     f"non-finite step {m}")
        want = {"roi_pool": LARGE_TRAIN_STEPS,
                "roi_pool_bwd": LARGE_TRAIN_STEPS,
                "pool_bwd": 4 * LARGE_TRAIN_STEPS}
        if launches != want:
            raise AssertionError(f"train-large bf16 {hw}: launches "
                                 f"{launches}, expected {want}")
        dev = train_device_ms(lambda: trainer.run_step(b))
        key = f"{hw[0]}x{hw[1]}"
        for k in counted:
            kernels[k]["launches_train_large"][key] = (launches[k]
                                                       / LARGE_TRAIN_STEPS)
            kernels[k]["device_ms_train_large"][key] = dev[k]
        last = ms[-1]
        print(f"[train-large] bf16 B={B} {hw[0]}x{hw[1]}: {wall * 1e3:.2f} "
              f"ms/step, {B / wall:.1f} img/s over {LARGE_TRAIN_STEPS} steps "
              f"(after 2); launches per step "
              f"{({k: v / LARGE_TRAIN_STEPS for k, v in launches.items()})}; "
              f"device time per step (torch.profiler): {_device_text(dev)}; "
              f"last step pcls {last['pcls']:.4f} preg {last['preg']:.4f} "
              f"dcls {last['dcls']:.4f} dreg {last['dreg']:.4f}, cls_count "
              f"{last['cls_count']:.0f}, reg_count {last['reg_count']:.0f}, "
              f"skipped 0 in every step", flush=True)
    profile_run("train-large-profile", f"vgg_large bf16 train step B={B} "
                f"{LARGE_HW[0][0]}x{LARGE_HW[0][1]}",
                lambda: trainer.run_step(batches[0]), "step", n_calls=2)
    del trainer
    torch.cuda.empty_cache()
    remat = Trainer(_large_train_config("bfloat16", remat=True),
                    device="cuda", seed=0)
    for b in batches:
        hw = tuple(b.image.shape[1:3])
        peak[(hw, True)] = _peak_step_mib(remat, b)
        t_run = time.perf_counter()
        for _ in range(LARGE_TRAIN_STEPS):
            remat.run_step(b)
        torch.cuda.synchronize()
        step_ms[(hw, True)] = ((time.perf_counter() - t_run)
                               / LARGE_TRAIN_STEPS * 1e3)
    del remat
    torch.cuda.empty_cache()
    text = "; ".join(
        f"{hw[0]}x{hw[1]} remat {'on' if r else 'off'} {p:.0f} MiB "
        f"({p - before:.0f} above the {before:.0f} held before the step), "
        f"{step_ms[(hw, r)]:.2f} ms/step"
        for (hw, r), (p, before) in sorted(peak.items()))
    log("train-large", f"peak memory of a bf16 step "
        f"(torch.cuda.max_memory_allocated) and ms/step over "
        f"{LARGE_TRAIN_STEPS} steps: {text}", t)


# -- data -----------------------------------------------------------------------

DATA_HW = (720, 1280)                    # the frames on disk (a 1280->800 resize)
DATA_FRAMES = {"train": 40, "val": 16, "background": 4}
DATA_STEPS = 6
HOST_BATCHES = 6     # 6 x 7 training slots >= one epoch of the 41 files
CORRUPT = "corrupt.png"


def _write_dataset(root: Path) -> Path:
    """Seeded 1280x720 PNG frames (``_frames``: smooth noise plus the six
    shaded bricks) in the duplo layout: a CSV of their boxes, the
    background frames in a directory of their own, one corrupt PNG listed
    as a training file, and the manifest. Returns the manifest's path."""
    from concurrent.futures import ThreadPoolExecutor

    from frcnn_tpu_torch.data import codec
    from frcnn_tpu_torch.data.importers import (
        create_duplo_manifest,
        save_manifest,
    )

    (root / "bg").mkdir()
    n_fg = DATA_FRAMES["train"] + DATA_FRAMES["val"]
    n_all = n_fg + DATA_FRAMES["background"]

    def chunk(start: int):
        frames, boxes, classes = _frames(100 + start, 4, DATA_HW)
        rows = []
        for i, (img, bx, cl) in enumerate(zip(frames, boxes, classes)):
            k = start + i
            if k >= n_all:
                break
            if k >= n_fg:
                codec.write_png(str(root / "bg" / f"bg{k:03d}.png"), img, 1)
                continue
            codec.write_png(str(root / f"f{k:03d}.png"), img, 1)
            rows += [f'"f{k:03d}.png", {b[0]:.0f}, {b[1]:.0f}, {b[2]:.0f}, '
                     f'{b[3]:.0f}, "brick{c}", {c}, "M", 0'
                     for b, c in zip(bx, cl)]
        return rows

    with ThreadPoolExecutor(8) as pool:
        rows = [r for rs in pool.map(chunk, range(0, n_all, 4)) for r in rs]
    (root / "boxes.csv").write_text("\n".join(rows) + "\n")
    manifest = create_duplo_manifest("smoke", str(root / "boxes.csv"),
                                     str(root / "bg"),
                                     validation_size=DATA_FRAMES["val"],
                                     seed=0)
    (root / CORRUPT).write_bytes(b"\x89PNGx")
    manifest["training_set"].append(CORRUPT)
    manifest["ground_truth"][CORRUPT] = {
        "image_file_name": CORRUPT,
        "rois": [{"rect": [10.0, 10.0, 90.0, 90.0], "class_name": "brick0",
                  "class_index": 0}]}
    save_manifest(manifest, str(root / "manifest.json"))
    return root / "manifest.json"


class _LogCapture(logging.Handler):
    """The pipeline's warnings (skipped files), kept for a check."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


class _Recorder:
    """A ``BatchIterator``'s validation batches, kept as they are handed
    out, so that more detectors can score the same inputs (``_Replay``)."""

    def __init__(self, it):
        self.it, self.batches = it, []

    def padded_validation_batch(self, n: int):
        self.batches.append(self.it.padded_validation_batch(n))
        return self.batches[-1]


class _Replay:
    def __init__(self, batches):
        self.batches = iter(batches)

    def padded_validation_batch(self, n: int):
        return next(self.batches)


def _compare_iterators(cfg, manifest, t):
    """4 batches of the native path against 4 of the Python path, with
    augmentation off and the same seed (``tests/test_pipeline_native.py``'s
    tolerances)."""
    from frcnn_tpu_torch.config import AugmentationConfig
    from frcnn_tpu_torch.data.pipeline import BatchIterator

    cfg = cfg.replace(augmentation=AugmentationConfig())
    its = [BatchIterator(cfg, str(manifest), seed=3, use_native=n)
           for n in (True, False)]
    if [it.use_native for it in its] != [True, False]:
        raise AssertionError("the native path was not taken")
    worst = 0.0
    for _ in range(4):
        a, b = (it.next_training_batch() for it in its)
        for f in ("true_hw", "gt_mask", "gt_classes", "is_background"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"data: native and Python {f} differ")
        torch.testing.assert_close(a.gt_boxes, b.gt_boxes, rtol=0, atol=1e-3)
        torch.testing.assert_close(a.image, b.image, rtol=0, atol=3e-3)
        worst = max(worst, float((a.image - b.image).abs().max()))
    log("data", f"native path == Python path over 4 batches of {B}: "
        f"true_hw, gt_mask, gt_classes, is_background equal, gt_boxes "
        f"within 1e-3, images within 3e-3 (largest {worst:.3g})", t)


def _host_ms(it, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        it.next_training_batch()
    return (time.perf_counter() - t) / n * 1e3


def _host_split(cfg, path: Path) -> str:
    """Median ms of the Python path's stages on one frame (3 runs)."""
    from frcnn_tpu_torch.data import codec
    from frcnn_tpu_torch.data.pipeline import find_target_size, resize_image
    from frcnn_tpu_torch.ops.color import convert_color

    stages = {"decode": lambda: codec.read_rgb(str(path)),
              "to float + color": lambda: convert_color(
                  rgb.astype(np.float32) / 255.0, cfg.color_space),
              "resize": lambda: resize_image(img, tw, th)}
    rgb = codec.read_rgb(str(path))
    img = convert_color(rgb.astype(np.float32) / 255.0, cfg.color_space)
    tw, th = find_target_size(img.shape[1], img.shape[0],
                              cfg.target_smaller_side, cfg.max_pixel_size)
    out = []
    for name, fn in stages.items():
        times = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out.append(f"{name} {statistics.median(times):.1f} ms")
    return ", ".join(out)


def _match_detections(a, b, tol: float, what: str = "detections"):
    """Each entry of ``a`` has one in ``b`` of the same image and class
    with box and score within ``tol`` (and the counts are equal)."""
    if len(a) != len(b):
        raise AssertionError(f"data f32: {len(a)} {what} through the "
                             f"kernels, {len(b)} through the plain versions")
    free = {}
    for e in b:
        free.setdefault(e["image"], []).append(e)
    for d in a:
        cands = free.get(d["image"], [])
        for j, e in enumerate(cands):
            if (e["class"] == d["class"]
                    and abs(e["score"] - d["score"]) <= tol
                    and max(abs(x - y) for x, y in zip(e["box"], d["box"]))
                    <= tol):
                del cands[j]
                break
        else:
            raise AssertionError(f"data f32: {what[:-1]} {d} through the "
                                 f"kernels has no plain counterpart within "
                                 f"{tol}")


def phase_data(kernels, fixed_ms_step: float, root: Path) -> Path:
    """Train from image files and evaluate mAP: the host pipeline
    (decode, resize, batch) into the Trainer, its weights into the serving
    Detector, ``evaluate_map`` over the validation files. The dataset is
    written under ``root``; returns its manifest's path."""
    from frcnn_tpu_torch.config import serving_config
    from frcnn_tpu_torch.data import codec, native
    from frcnn_tpu_torch.data.pipeline import BatchIterator, PrefetchingIterator
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.detect.evaluation import (
        collect_detections,
        evaluate_map,
    )
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.ops import (
        block0_kernel,
        nms_kernel,
        pool_bwd_kernel,
        roi_pool_kernel,
    )
    from frcnn_tpu_torch.train.trainer import Trainer

    capture = _LogCapture()
    logging.getLogger("frcnn_tpu_torch.data").addHandler(capture)
    t = time.perf_counter()
    manifest = _write_dataset(root)
    log("data", f"{DATA_FRAMES} frames of {DATA_HW[1]}x{DATA_HW[0]} "
        f"written as PNG, one corrupt PNG ({CORRUPT}) listed for "
        f"training, duplo CSV -> manifest", t)
    t = time.perf_counter()
    lib = native.available()
    why = "built" if lib else "not available: " + " | ".join(
        ln for ln in native.build_error().splitlines() if "error" in ln)
    log("data", f"native host library {why}; frames decode through "
        f"the {codec.decoder()}", t)
    cfg = _train_config("bfloat16").replace(
        examples_base_path=str(root), background_base_path=str(root / "bg"))
    t = time.perf_counter()
    if lib:
        _compare_iterators(cfg, manifest, t)
    else:
        log("data", "native vs Python batches: not run, the native "
            "library did not build", t)

    t = time.perf_counter()
    bare = BatchIterator(cfg, str(manifest), seed=1)
    bare_ms = _host_ms(bare, HOST_BATCHES)
    pre = PrefetchingIterator(BatchIterator(cfg, str(manifest), seed=1))
    try:
        pre_ms = _host_ms(pre, 3)
    finally:
        pre.close()
    skipped = [m for m in capture.messages if CORRUPT in m]
    if not skipped:
        raise AssertionError(f"data: {CORRUPT} was not skipped and "
                             f"logged in {HOST_BATCHES} batches")
    split = _host_split(cfg, root / bare.training.items[0])
    log("data", f"host batches of {B} at {IMAGE_HW[0]}x{IMAGE_HW[1]} "
        f"({'native' if bare.use_native else 'Python'} path): "
        f"{bare_ms:.1f} ms/batch bare over {HOST_BATCHES}, "
        f"{pre_ms:.1f} ms/batch through PrefetchingIterator(depth=2) "
        f"over 3 with nothing else running; per frame {split}; "
        f"{CORRUPT} skipped and logged: {skipped[0]!r}", t)

    # train from the files: the slice's main path, counts read around it
    t = time.perf_counter()
    counted = {"roi_pool": roi_pool_kernel.KERNEL,
               "roi_pool_bwd": roi_pool_kernel.BWD_KERNEL,
               "pool_bwd": pool_bwd_kernel.KERNEL}
    trainer = Trainer(cfg, device="cuda", seed=0)
    pre = PrefetchingIterator(BatchIterator(cfg, str(manifest), seed=2))
    for k in counted.values():
        k.launches = 0
    try:
        ms, times = [], []
        for _ in range(DATA_STEPS):
            t_step = time.perf_counter()
            ms.append(trainer.run_step(pre.next_training_batch()))
            times.append(time.perf_counter() - t_step)
    finally:
        pre.close()
    launches = {k: v.launches for k, v in counted.items()}
    for m in ms:
        if m["skipped"] != 0 or not all(
                np.isfinite(m[k]) for k in ("pcls", "preg", "dcls",
                                            "dreg")):
            raise AssertionError(f"data train: skipped or non-finite "
                                 f"step {m}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"data train: launches {launches}")
    for k, n in launches.items():
        kernels[k]["launches_data"] = n
    step_ms = statistics.mean(times[1:]) * 1e3
    snap = root / "smoke.ckpt"
    trainer.save_snapshot(str(snap))
    losses = ", ".join(f"{k} {ms[-1][k]:.4f}"
                       for k in ("pcls", "preg", "dcls", "dreg"))
    log("data", f"bf16 train from files, B={B}: {DATA_STEPS} steps, "
        f"every loss finite, none skipped (last: {losses}); "
        f"{step_ms:.1f} ms/step wall over steps 2-{DATA_STEPS} "
        f"(first {times[0] * 1e3:.1f} ms) against {fixed_ms_step:.1f} "
        f"ms/step on the [train] phase's fixed batch; launches "
        f"{launches}; snapshot {snap.stat().st_size} bytes", t)

    # evaluate: the trainer's weights in the serving Detector
    t = time.perf_counter()
    serve = serving_config(cfg).replace(detect_fg_threshold=0.5)
    pnet, cnet = models_from_state_dicts(serve, trainer.state_dicts())
    del trainer
    det = Detector(serve, pnet, cnet, device="cuda")
    counted = {"fused_block0": block0_kernel.KERNEL,
               "nms_keep_mask": nms_kernel.KERNEL,
               "roi_pool": roi_pool_kernel.KERNEL}
    for k in counted.values():
        k.launches = 0
    record = _Recorder(BatchIterator(serve, str(manifest), seed=0))
    t_run = time.perf_counter()
    res = evaluate_map(serve, det, record,
                       max_images=DATA_FRAMES["val"],
                       with_proposal_recall=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_run) * 1e3
    launches = {k: v.launches for k, v in counted.items()}
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"data evaluate: launches {launches}")
    if res["num_images"] != DATA_FRAMES["val"]:
        raise AssertionError(f"data evaluate: {res['num_images']} "
                             f"images scored")
    for k, n in launches.items():
        kernels[k]["launches_data"] = (kernels[k].get("launches_data", 0)
                                       + n)
    log("data", f"evaluate_map (bf16 serving, detect_fg_threshold 0.5) "
        f"over {res['num_images']} validation files: "
        f"{json.dumps(res)}; launches {launches}; {wall:.1f} ms wall, "
        f"decode included", t)

    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = serve.replace(compute_dtype="float32")
    got = [collect_detections(
        Detector(c, pnet, cnet, device="cuda"), _Replay(record.batches),
        DATA_FRAMES["val"], with_proposals=True)
        for c in (f32, f32.replace(pallas_mode="off"))]
    (dk, gk, nk, pk), (dp, gp, np_, pp) = got
    _match_detections(dk, dp, 1e-3)
    if (gk, nk) != (gp, np_):
        raise AssertionError("data f32: ground truth or image count "
                             "differs")
    # the stage-1 survivors too: after 6 steps there may be no
    # detection to compare
    _match_detections(*(
        [{"image": i, "class": 0, "score": 0.0, "box": b}
         for i, bs in sorted(p.items()) for b in bs]
        for p in (pk, pp)), 1e-3, "proposals")
    log("data", f"float32 collect_detections over the same {nk} "
        f"validation images: kernels == plain versions ({len(dk)} "
        f"detections, classes equal, boxes and scores within 1e-3; "
        f"{sum(map(len, pk.values()))} proposals within 1e-3)", t)
    logging.getLogger("frcnn_tpu_torch.data").removeHandler(capture)
    phase_data_jpeg(kernels, root)
    return manifest


JPEG_DIR = ROOT / "frcnn_tpu_torch" / "tools" / "jpeg_fixtures"
JPEG_FRAME = "frame_q90_420_500x375.jpg"
JPEG_BATCH = 2       # images per vgg_large step from the fixtures
JPEG_STEPS = 2


def _jpeg_sources() -> dict:
    """{fixture: the SHA-256 of PIL's RGB bytes, or "raises"}, from the
    fixtures' SOURCES.md (written where PIL is installed)."""
    out = {}
    for ln in (JPEG_DIR / "SOURCES.md").read_text().splitlines():
        m = re.match(r"^\| `([^`]+\.jpg)` \|.*\| `([0-9a-f]{64}|raises)` \|$",
                     ln)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _voc_xml(stem: str, w: int, h: int, cls: str) -> str:
    """A PASCAL VOC-style annotation, as ILSVRC DET writes them: one object
    of ``cls`` over the middle half of the image."""
    box = "".join(f"<{k}>{v}</{k}>" for k, v in (
        ("xmin", w // 4), ("ymin", h // 4), ("xmax", 3 * w // 4),
        ("ymax", 3 * h // 4)))
    return (f"<annotation><filename>{stem}</filename><size><width>{w}"
            f"</width><height>{h}</height></size><object><name>{cls}</name>"
            f"<bndbox>{box}</bndbox></object></annotation>\n")


def phase_data_jpeg(kernels, root: Path):
    """JPEG on the card's machine, which has neither ``jpeglib.h`` nor
    PIL: every fixture of ``tools/jpeg_fixtures`` through ``data/jpeg.py``,
    its RGB bytes' SHA-256 against PIL's in SOURCES.md (the truncated one
    refused); ms per frame beside the PNG reader's on the same pixels; then
    ``import-imagenet`` over them as an ILSVRC DET tree with VOC XML
    annotations, and vgg_large ``train --steps 2 --plot 0`` from it."""
    import hashlib
    import shutil

    from frcnn_tpu_torch.config import imagenet_config
    from frcnn_tpu_torch.data import codec

    t = time.perf_counter()
    sources = _jpeg_sources()
    sizes, refused = {}, []
    for name, want in sources.items():
        path = str(JPEG_DIR / name)
        if want == "raises":
            try:
                codec.read_rgb(path, use_native=False)
            except ValueError as e:
                refused.append(str(e))
                continue
            raise AssertionError(f"data jpeg: {name} decoded; PIL raises")
        rgb = codec.read_rgb(path, use_native=False)
        got = hashlib.sha256(rgb.tobytes()).hexdigest()
        if got != want:
            raise AssertionError(f"data jpeg: {name} decodes to SHA-256 "
                                 f"{got}, PIL's decode to {want}")
        sizes[name] = rgb.shape[:2]
    if not sizes or not refused:
        raise AssertionError(f"data jpeg: {len(sizes)} fixtures decoded, "
                             f"{len(refused)} refused")
    frame = str(JPEG_DIR / JPEG_FRAME)
    png = str(root / "jpeg_frame.png")
    codec.write_png(png, codec.read_rgb(frame, use_native=False))

    def median_ms(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    jpeg_ms = median_ms(lambda: codec.read_rgb(frame, use_native=False))
    png_ms = median_ms(lambda: codec.read_rgb(png, use_native=False))
    log("data", f"{len(sizes)} JPEG fixtures through data/jpeg.py, each "
        f"one's RGB SHA-256 equal to PIL's decode (SOURCES.md); refused as "
        f"the file's fault: {refused[0]!r}; {JPEG_FRAME}: {jpeg_ms:.1f} "
        f"ms per frame, the same pixels as PNG {png_ms:.1f} ms (median of "
        f"3, host)", t)

    t = time.perf_counter()
    base = root / "ilsvrc"
    names = [n for n, hw in sizes.items() if min(hw) >= 30]
    names.append(next(n for n, v in sources.items() if v == "raises"))
    for split, files in (("train", names), ("val", names[:2])):
        ann = base / "Annotations" / "DET" / split / "fixtures"
        data = base / "Data" / "DET" / split / "fixtures"
        ann.mkdir(parents=True)
        data.mkdir(parents=True)
        for i, name in enumerate(files):
            stem = Path(name).stem
            shutil.copy(JPEG_DIR / name, data / f"{stem}.JPEG")
            h, w = sizes.get(name, (120, 160))   # the truncated file's crop
            (ann / f"{stem}.xml").write_text(
                _voc_xml(stem, w, h, f"n0000000{i % 3}"))
    man = root / "ilsvrc.json"
    wall_i, _, _ = _cli(["import-imagenet", "--base-dir", str(base),
                         "--out", str(man)])
    m = json.loads(man.read_text())
    if (len(m["training_set"]), len(m["validation_set"])) != (len(names), 2):
        raise AssertionError(f"data jpeg: import-imagenet listed "
                             f"{len(m['training_set'])} training and "
                             f"{len(m['validation_set'])} validation files")
    cfg = imagenet_config(pallas_mode="on", compute_dtype="bfloat16",
                          plot_interval=0, snapshot_interval=0)
    cfg = cfg.replace(shapes=dataclasses.replace(
        cfg.shapes, images_per_step=JPEG_BATCH))
    (root / "ilsvrc_cfg.json").write_text(cfg.to_json())
    capture = _LogCapture()
    logging.getLogger("frcnn_tpu_torch.data").addHandler(capture)
    try:
        wall_t, _, launches = _cli([
            "train", "--cfg", str(root / "ilsvrc_cfg.json"), "--train",
            str(man), "--name", str(root / "jpeg"), "--steps",
            str(JPEG_STEPS), "--plot", "0"])
    finally:
        logging.getLogger("frcnn_tpu_torch.data").removeHandler(capture)
    recs = [json.loads(ln) for ln in
            (root / "jpeg_metrics.jsonl").read_text().splitlines()]
    want = {"roi_pool": JPEG_STEPS, "roi_pool_bwd": JPEG_STEPS,
            "pool_bwd": 4 * JPEG_STEPS}
    if len(recs) != JPEG_STEPS or any(
            r["skipped"] or not np.isfinite(r["loss"]) for r in recs) or \
            launches != want:
        raise AssertionError(f"data jpeg train: metrics {recs}, launches "
                             f"{launches} (expected {want})")
    skipped = [x for x in capture.messages if "Invalid image" in x]
    kernels["roi_pool"]["launches_data_jpeg"] = launches["roi_pool"]
    log("data", f"import-imagenet over an ILSVRC DET tree of the fixtures "
        f"({len(names)} training files, 2 validation, VOC XML; "
        f"{wall_i:.2f} s), then vgg_large train --steps {JPEG_STEPS} "
        f"--plot 0 from JPEG (imagenet config, bf16, kernels on, B="
        f"{JPEG_BATCH}; decoder: {codec.decoder()}): losses "
        f"{[round(r['loss'], 4) for r in recs]}, none skipped, launches "
        f"{launches}; files skipped and logged: {len(skipped)}"
        f"{f' ({skipped[0]!r})' if skipped else ''}; {wall_t:.2f} s wall",
        t)


# -- the CLI ------------------------------------------------------------------

CLI_STEPS = 4


def _cli(argv):
    """One in-process run of the port's CLI on the card, with every
    kernel's launch count set to 0 before it. Returns (wall s, standard
    output, {kernel: launches} of the kernels it launched)."""
    from frcnn_tpu_torch import cli
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY

    for k in REGISTRY.values():
        k.launches = 0
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cuda", *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return wall, out.getvalue(), {n: k.launches for n, k in REGISTRY.items()
                                  if k.launches}


@contextlib.contextmanager
def _environ(values: dict):
    """``os.environ`` with ``values`` set, restored at exit."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _leaves(tree) -> list:
    """The arrays of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _check_group_train(work: Path, common, cfg, plain_s: float, smi: str):
    """``train`` again, 2 steps on the same files and seed, with
    ``torchrun``'s variables set: ``cmd_train`` takes its rank path and
    trains in a one-rank NCCL group it joins and destroys. Held against
    the plain run's first 2 steps: bitwise, else the ``[train]``
    tolerances (losses rtol 1e-5, counts equal, every parameter array
    within 1e-4 of its largest magnitude)."""
    import torch.distributed as dist

    from frcnn_tpu_torch.parallel.mesh import data_parallel_size, free_port
    from frcnn_tpu_torch.utils.serialization import load_checkpoint

    steps = 2
    grp = str(work / "grp")
    with _environ(dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(free_port()))):
        wall, _, launches = _cli(["train", *common, "--name", grp,
                                  "--steps", str(steps), "--snapshot", "2"])
    if dist.is_initialized():
        raise AssertionError("cli train (group): a process group is left "
                             "initialized")
    want = {"roi_pool": steps, "roi_pool_bwd": steps, "pool_bwd": 4 * steps}
    if launches != want:
        raise AssertionError(f"cli train (group): launches {launches}, "
                             f"expected {want}")
    recs = [[json.loads(x) for x in
             (work / f"{n}_metrics.jsonl").read_text().splitlines()[:steps]]
            for n in ("grp", "run")]
    for r in recs[0] + recs[1]:
        r.pop("step_time_s")
    got, ref = (_leaves(load_checkpoint(str(work / f"{n}_000002.ckpt"))[
        "params"]) for n in ("grp", "run"))
    bitwise = recs[0] == recs[1] and all(
        np.array_equal(x, y) for x, y in zip(got, ref, strict=True))
    how = "bitwise"
    if not bitwise:
        for a, b in zip(*recs, strict=True):
            for k in ("cls_count", "reg_count", "skipped"):
                if a[k] != b[k]:
                    raise AssertionError(f"cli train (group): {k} {a[k]} "
                                         f"against {b[k]}")
            for k in ("pcls", "preg", "dcls", "dreg", "loss"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           err_msg=f"cli train (group) {k}")
        worst = max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
                    for x, y in zip(got, ref))
        if worst > 1e-4:
            raise AssertionError(f"cli train (group): step-2 parameters "
                                 f"{worst:.3g} of their largest apart")
        how = (f"NOT bitwise: within the [train] tolerances (parameters at "
               f"most {worst:.3g} of their largest apart)")
    count = torch.cuda.device_count()
    world = data_parallel_size(count, cfg.shapes.images_per_step)
    print(f"[cli] train (group): RANK=0 WORLD_SIZE=1, cmd_train's rank path "
          f"in a one-rank NCCL group: {wall:.2f} s wall for {steps} steps "
          f"(the plain train: {plain_s:.2f} s for {CLI_STEPS}); metrics and "
          f"step-2 snapshot {how} the plain run's; launches {launches}; no "
          f"process group left; the device rule picks world {world} on "
          f"this machine ({count} card(s), images_per_step "
          f"{cfg.shapes.images_per_step}); {smi}", flush=True)
    return launches


def phase_cli(kernels, root: Path, smi: str):
    """``python -m frcnn_tpu_torch`` with ``--device cuda`` on the data
    phase's PNG files and a config JSON with ``pallas_mode: "on"``:
    import-duplo, train, the same train through the CLI's rank path
    (:func:`_check_group_train`), evaluate --serving fast, demo, and the
    t7 model export/import cycle."""
    from frcnn_tpu_torch.utils.serialization import load_checkpoint

    t = time.perf_counter()
    work = root / "cli"
    work.mkdir()
    # the plots need matplotlib, which the card's machine may lack
    plot = 2 if importlib.util.find_spec("matplotlib") else 0
    cfg = _train_config("bfloat16").replace(
        examples_base_path=str(root), background_base_path=str(root / "bg"),
        snapshot_interval=2, plot_interval=plot)
    cfg_path = str(work / "cfg.json")
    (work / "cfg.json").write_text(cfg.to_json())
    man, name = str(work / "manifest.json"), str(work / "run")
    ckpt = f"{name}_{CLI_STEPS:06d}.ckpt"
    common = ["--cfg", cfg_path, "--train", man]
    runs = (
        ("import-duplo", ["import-duplo", "--csv", str(root / "boxes.csv"),
                          "--background", str(root / "bg"), "--out", man,
                          "--name", "smoke", "--val-size",
                          str(DATA_FRAMES["val"])]),
        ("train", ["train", *common, "--name", name, "--steps",
                   str(CLI_STEPS), "--snapshot", "2"]),
        ("evaluate", ["evaluate", *common, "--restore", ckpt, "--count",
                      str(DATA_FRAMES["val"]), "--serving", "fast"]),
        ("demo", ["demo", *common, "--restore", ckpt, "--out",
                  str(work / "demo"), "--count", "2"]),
        ("export-t7-model", ["export-t7-model", "--cfg", cfg_path,
                             "--restore", ckpt, "--out",
                             str(work / "run.t7")]),
        ("import-t7-model", ["import-t7-model", "--cfg", cfg_path, "--t7",
                             str(work / "run.t7"), "--out",
                             str(work / "imported.ckpt")]),
    )
    launches_cli = {}
    for what, argv in runs:
        wall, out, launches = _cli(argv)
        note = ""
        if what == "train":
            recs = (work / "run_metrics.jsonl").read_text().splitlines()
            snaps = sorted(p.name for p in work.glob("run_*.ckpt"))
            if len(recs) != CLI_STEPS or snaps != ["run_000002.ckpt",
                                                   "run_000004.ckpt"]:
                raise AssertionError(f"cli train: {len(recs)} metrics "
                                     f"records, snapshots {snaps}")
            want = {"roi_pool": CLI_STEPS, "roi_pool_bwd": CLI_STEPS,
                    "pool_bwd": 4 * CLI_STEPS}
            if launches != want:
                raise AssertionError(f"cli train: launches {launches}, "
                                     f"expected {want}")
            last = json.loads(recs[-1])
            note = (f"; {len(recs)} metrics records, snapshots {snaps}, "
                    f"plot {'written' if plot else 'off (no matplotlib)'}; "
                    f"last step loss {last['loss']:.4f}, skipped "
                    f"{last['skipped']:.0f}")
        elif what == "evaluate":
            res = json.loads(out)
            # dynamic scales: block 0 runs the float kernel, then the
            # int8 chain quantizes its output
            if res["num_images"] != DATA_FRAMES["val"] or not all(
                    launches.get(k) for k in ("fused_block0",
                                              "nms_keep_mask", "roi_pool")):
                raise AssertionError(f"cli evaluate: {res['num_images']} "
                                     f"images, launches {launches}")
            note = f"; {json.dumps(res)}"
        elif what == "demo":
            pngs = sorted(p.name for p in (work / "demo").glob("*.png"))
            if pngs != ["output1.png", "output2.png"] or not all(
                    launches.get(k) for k in ("nms_keep_mask", "roi_pool")):
                raise AssertionError(f"cli demo: {pngs}, launches "
                                     f"{launches}")
            note = f"; wrote {pngs}"
        elif what == "import-t7-model":
            a = load_checkpoint(ckpt)["params"]
            b = load_checkpoint(str(work / "imported.ckpt"))["params"]
            n = _assert_trees_equal(a, b)
            note = f"; {n} weight arrays back bitwise"
        launches_cli[what] = launches
        print(f"[cli] {what}: {wall:.2f} s wall; launches {launches}{note}",
              flush=True)
        if what == "train":
            launches_cli["train (group)"] = _check_group_train(
                work, common, cfg, wall, smi)
    for what, launches in launches_cli.items():
        for k, n in launches.items():
            kernels[k].setdefault("launches_cli", {})[what] = n
    log("cli", f"python -m frcnn_tpu_torch --device cuda: every subcommand "
        f"ran on the card", t)


def _assert_trees_equal(a, b) -> int:
    """Nested dicts of numpy arrays equal bitwise; returns the array
    count."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"keys differ: {sorted(a)} {sorted(b)}")
        return sum(_assert_trees_equal(a[k], b[k]) for k in a)
    if not np.array_equal(np.asarray(a), np.asarray(b)):
        raise AssertionError("cli t7 cycle: weights differ")
    return 1


# -- data parallelism ----------------------------------------------------------

def phase_parallel():
    """A world-size-1 NCCL group on the card: one data-parallel step (its
    sums, counts, gradients and skip vote through NCCL all-reduces) against
    ``Trainer.run_step``, float32, at the [train] tolerances; then a
    ShardedDetector of one replica against the Detector."""
    import torch.distributed as dist

    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.parallel.mesh import batch_shard, free_port
    from frcnn_tpu_torch.parallel.serving import ShardedDetector
    from frcnn_tpu_torch.train.trainer import Trainer

    t = time.perf_counter()
    _f32()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        cfg = _train_config("float32")
        batch = _train_batch(cfg, 2, IMAGE_HW)
        one = Trainer(cfg, device="cuda", seed=0)
        dp = Trainer(cfg, device="cuda", seed=0, shard=batch_shard())
        a = one.compute_gradients(batch)
        d = dp.compute_gradients(batch)
        worst, name = _assert_steps_close(
            "parallel", "data-parallel step", (d[1][0], d[1][1], d[2]),
            (a[1][0], a[1][1], a[2]))
        one.apply_gradients(a[2], a[1][0])
        dp.apply_gradients(d[2], d[1][0])
        moved = max(float((dp.params[k] - one.params[k]).abs().max())
                    for k in one.params)
        log("parallel", f"NCCL world size 1, float32 B={B} "
            f"{IMAGE_HW[0]}x{IMAGE_HW[1]}: data-parallel step == "
            f"Trainer step: losses rtol 1e-5, largest relative gradient "
            f"error {worst:.3g} ({name}; limit 1e-4); updated parameters "
            f"at most {moved:.3g} apart", t)
        del one, dp, a, d
        torch.cuda.empty_cache()

        t = time.perf_counter()
        scfg, pnet, cnet = _load_models("parallel")
        frames, _, _ = _frames(1, B, IMAGE_HW)
        hw = np.tile(np.asarray([IMAGE_HW], np.int32), (B, 1))
        want = Detector(scfg, pnet, cnet, device="cuda").detect(frames, hw)
        got = ShardedDetector(scfg, pnet, cnet,
                              devices=["cuda"]).detect(frames, hw)
        for f in ("valid", "classes", "proposals_valid"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"parallel: ShardedDetector {f} "
                                     f"differs")
        for f, tol in (("boxes", 1e-3), ("proposals", 1e-3),
                       ("confidence", 1e-5), ("fg_score", 1e-5)):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=tol)
        log("parallel", f"ShardedDetector (1 replica, cuda) == Detector on "
            f"a bf16 serving batch of {B}: {int(want.valid.sum())} "
            f"detections, valid/classes equal, boxes within 1e-3", t)
    finally:
        dist.destroy_process_group()


# -- the flagship entry and the dryrun's real stage ---------------------------

def _launches():
    """{kernel: launches} since the counts were set to 0, nonzero only."""
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY

    return {n: k.launches for n, k in REGISTRY.items() if k.launches}


def _zero_launches():
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY

    for k in REGISTRY.values():
        k.launches = 0


def _nonempty(phase: str, what: str, res) -> None:
    """A comparison of ``res`` with another result compares something:
    it holds stage-1 proposals and detections."""
    if not (res.proposals_valid.any() and res.valid.any()):
        raise AssertionError(
            f"{phase} {what}: {int(res.proposals_valid.sum())} proposals, "
            f"{int(res.valid.sum())} detections: the comparison would hold "
            f"nothing")


def phase_entry(kernels, device: str = "cuda"):
    """``frcnn_tpu_torch.entry.entry()`` on the card (the flagship detect
    program: vgg_small, duplo at 450x800, seeded weights, B=2 zero frames,
    bf16, the plain versions as the config has no kernels on): shapes and
    finite values only, as the zero frames give no proposal. Then the same
    program in float32 with weights that carry load (``_seeded_models``
    and the bench's stress biases) on two brick frames, as the config
    runs it (the plain versions) against the same program with the
    kernels on (NMS, ROI pool); both must hold proposals and detections.
    Then the real-config stage of ``dryrun_multichip`` (vgg_small, duplo,
    224x800, kernels, remat, bf16) as rank 0 of a world-size-1 NCCL
    group, with its kernel launches. (``device="cpu"`` rehearses the
    phase: gloo, the plain versions.)"""
    import torch.distributed as dist

    from frcnn_tpu_torch.bench import stress_weights
    from frcnn_tpu_torch.detect.detector import build_detect_fn
    from frcnn_tpu_torch.entry import entry, entry_config
    from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
    from frcnn_tpu_torch.models.factory import for_compute
    from frcnn_tpu_torch.ops.color import unwire_uint8
    from frcnn_tpu_torch.parallel import dryrun
    from frcnn_tpu_torch.parallel.mesh import free_port

    t = time.perf_counter()
    fn, args = entry(device)
    out = fn(*args)
    torch.cuda.synchronize()
    D = entry_config().shapes.max_detections
    if out.boxes.shape != (2, D, 4) or not all(
            torch.isfinite(getattr(out, f)).all()
            for f in ("boxes", "confidence", "proposals")):
        raise AssertionError(f"entry: boxes {tuple(out.boxes.shape)}, "
                             f"non-finite outputs")
    ms = time_ms(lambda: fn(*args), reps=5, warmup=1)
    log("entry", f"entry() on {args[0].device}: {entry_config().model.name}"
        f" {tuple(args[0].shape)} {args[0].dtype}, {ms:.3f} ms/call; "
        f"{int(out.valid.sum())} detections and "
        f"{int(out.proposals_valid.sum())} proposals on the zero frames "
        f"(shapes and finite values only)", t)

    t = time.perf_counter()
    _f32()
    cfg32 = entry_config().replace(compute_dtype="float32")
    # 17 class logits: a spread of 100 takes some past the 0.2 gate
    pnet, cnet = _seeded_models(cfg32, cls_spread=100.0)
    with torch.no_grad():
        stress_weights(pnet)
    H, W = cfg32.shapes.image_hw
    images = unwire_uint8(torch.from_numpy(_frames(3, 2, (H, W))[0]),
                          cfg32.color_space).to(device)
    res = {}
    for mode in ("off", "on"):
        c = cfg32.replace(pallas_mode=mode)
        res[mode] = build_detect_fn(
            c, AnchorGenerator(c), for_compute(pnet, torch.float32, device),
            for_compute(cnet, torch.float32, device),
            torch.device(device))(images, args[1])
    _nonempty("entry", "float32 program", res["off"])
    torch.testing.assert_close(res["on"].proposals, res["off"].proposals,
                               rtol=0, atol=1e-3)
    _check_f32_detect("entry", res["on"], res["off"],
                      "entry program, brick frames, weights that carry "
                      "load + stress biases (stage-1 survivors within 1e-3)",
                      t)

    t = time.perf_counter()
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        _zero_launches()
        metrics = dryrun.dryrun_real_config(1, device=device)
        torch.cuda.synchronize()
        launches = _launches()
    finally:
        dist.destroy_process_group()
    want = {"roi_pool": 1, "roi_pool_bwd": 1, "pool_bwd": 4}
    if launches != want and device == "cuda":
        raise AssertionError(f"entry: dryrun real stage launches "
                             f"{launches}, expected {want}")
    for k, n in launches.items():
        kernels[k]["launches_dryrun_real"] = n
    log("entry", f"dryrun_multichip real-config stage ({backend} world "
        f"size 1): "
        f"loss {metrics['loss']:.4f}, skipped {metrics['skipped']:.0f}; "
        f"launches {launches}", t)


# -- the bench -------------------------------------------------------------------

BENCH_MODES = {      # mode -> the kernels its program launches
    "bf16": set(),
    "pallas+s2d": {"fused_block0", "nms_keep_mask", "roi_pool"},
    "int8s+pallas+s2d+s8p": {"block0_s8out", "nms_keep_mask", "roi_pool"},
    "imagenet+int8s+pallas+s2d": {"block0_2conv_int8", "nms_keep_mask",
                                  "roi_pool"},
}
BENCH_ITERS = 2


def phase_bench(kernels, device: str = "cuda"):
    """``frcnn_tpu_torch.bench``'s measurement at B=8, 2 iterations, for
    four modes: one JSON record each, with the kernel launches per timed
    call (each mode's kernels, and none for bf16); then the float32
    ``pallas+s2d`` program, with weights that carry load
    (``_seeded_models``) under the stress biases, against the same
    program through the plain versions; both must hold proposals and
    detections."""
    from frcnn_tpu_torch import bench

    for mode, want in BENCH_MODES.items():
        t = time.perf_counter()
        _zero_launches()
        rec = bench.measure(B, BENCH_ITERS, mode, device)
        if device == "cuda" and set(rec["kernels"]) != want or \
                rec["value"] <= 0:
            raise AssertionError(f"bench {mode}: launches {rec['kernels']},"
                                 f" expected {sorted(want)}")
        for k, n in rec["kernels"].items():
            kernels[k].setdefault("launches_bench", {})[mode] = n
        print(f"[bench] {json.dumps(rec)}", flush=True)
        log("bench", f"{mode}: {rec['value']:.2f} img/s", t)
        torch.cuda.empty_cache()

    t = time.perf_counter()
    _f32()
    cfg = bench.bench_config("pallas+s2d").replace(compute_dtype="float32")
    models = _seeded_models(cfg, cls_spread=100.0)   # as in [entry]
    ker_fn, args = bench.bench_program(cfg, "pallas+s2d", B, device,
                                       models=models)
    ker = ker_fn(*args)
    plain_fn, pargs = bench.bench_program(cfg.replace(pallas_mode="off"),
                                          "pallas+s2d", B, device,
                                          models=models)
    ref = plain_fn(*pargs)
    _nonempty("bench", "float32 pallas+s2d program", ref)
    torch.testing.assert_close(ker.proposals, ref.proposals, rtol=0,
                               atol=1e-3)
    # the block0 kernel's float32 sums are not cuDNN's: confidences that
    # tie near 1 may take either slot
    _check_f32_detect("bench", ker, ref,
                      "pallas+s2d program, weights that carry load + stress "
                      "biases (stage-1 survivors within 1e-3)", t,
                      ordered=False)


# -- the stage profilers -----------------------------------------------------------

PROFILE_N = 2


def phase_profile_stages(device: str = "cuda"):
    """``tools/profile_detect.py`` (its default stages and tailparts,
    mode=pallas+s2d, B=8, 450x800) and ``tools/profile_train.py`` (step,
    grad, bwdparts with the kernels, B=8): ms per stage, and the kernels
    each launched."""
    from frcnn_tpu_torch.tools import profile_detect, profile_train

    def out(line):
        print(f"[profile-stages] {line}", flush=True)

    t = time.perf_counter()
    _zero_launches()
    S = profile_detect.setup(B, "pallas+s2d", IMAGE_HW, device)
    profile_detect.run(S, [*profile_detect.DEFAULT_STAGES, "tailparts"],
                       PROFILE_N, out)
    launches = _launches()
    if device == "cuda" and not {"fused_block0", "nms_keep_mask",
                                 "roi_pool"} <= set(launches):
        raise AssertionError(f"profile_detect: launches {launches}")
    log("profile-stages", f"profile_detect mode=pallas+s2d B={B} "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]} n={PROFILE_N}: launches {launches}",
        t)
    del S
    torch.cuda.empty_cache()

    t = time.perf_counter()
    _zero_launches()
    S = profile_train.setup(B, IMAGE_HW, pallas=True, device=device)
    profile_train.run(S, ["step", "grad", "bwdparts"], PROFILE_N // 2, out)
    launches = _launches()
    if device == "cuda" and not {"roi_pool", "roi_pool_bwd",
                                 "pool_bwd"} <= set(launches):
        raise AssertionError(f"profile_train: launches {launches}")
    log("profile-stages", f"profile_train pallas B={B} "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]} n={PROFILE_N // 2}: launches "
        f"{launches}", t)
    del S
    torch.cuda.empty_cache()


# -- the int8 matmul probe (row 7) ---------------------------------------------------

PROBE_ITERS = 20
# the int8 chain's largest GEMM: block 1's second conv at B=8 and 450x800
# (_conv_layers: 8 x 225 x 400 rows of im2col, K = 9 x 128, N = 128)
PROBE_CHAIN = (B * 225 * 400, 9 * 128, 128)
PROBE_PLAIN_ROWS = 8192
# the mma.sync route (via="sync"): one element; ragged tiles with K or N no
# multiple of 16 bytes (the kernel's plain-load staging) and K tails;
# several tiles each way
PROBE_EDGES = ((1, 1, 1), (33, 70, 17), (64, 96, 40), (300, 77, 260),
               (130, 1040, 200), (257, 1152, 136))
# int32 sums past 2^31 - 1: K x 127^2 >= 2^31 from K = 133,144
PROBE_WRAP = (17, 133200, 24)
# the TMA route, on the 16-byte grain: M no multiple of 128, N no multiple
# of BN (136, 8, 1000, 24, 16, 104, 376), K no multiple of 128 bytes (1040
# s8 and 2080 bf16, 48, 272, 64 s8, 80, 208); on the card's 132 SMs tiles
# of 128 x 64 (BN = 64: at most 66 tiles of 128 x 128; 6, 2 and 1 tiles),
# 128 x 256 (252), 128 x 128 (133 and 131) and 128 x 192 (134): every BN,
# and at each of the wider ones the persistent grid's partial last round
# or a round short of one SM
PROBE_TMA_EDGES = ((200, 1040, 136), (130, 48, 8), (8000, 272, 1000),
                   (17000, 64, 24), (16, 1024, 16), (16700, 80, 104),
                   (8500, 208, 376))
PROBE_TMA_WRAP = (17, 133200, 32)
# the tool's run on the mma.sync route (K and N off the 16-byte grain)
PROBE_SYNC_TOOL = (33, 70, 17)


def _mm_bound(m: int, k: int, n: int, dtype):
    """A and B read once, the 4-byte output written once; 2 M K N
    operations at the input type's peak."""
    size = 1 if dtype == torch.int8 else 2
    return bound_ms((m * k + k * n) * size + 4 * m * n, 2.0 * m * k * n,
                    dtype)


def _mm_check(K, plain, a, b, what: str, via: str, tol=None) -> float:
    """The kernel on route ``via`` against the plain version: bitwise, or
    within ``tol(a, b)`` elementwise. Returns the max abs err."""
    got = K.mm(a, b, via=via)
    torch.cuda.synchronize()
    want = plain(a, b)
    if tol is None:
        if not torch.equal(got, want):
            raise AssertionError(
                f"probe: {what} ({via}): {int((got != want).sum())} of "
                f"{got.numel()} values differ from the plain version")
        return 0.0
    err = (got - want).abs()
    if not bool((err <= tol(a, b)).all()):
        raise AssertionError(f"probe: {what} ({via}): max abs err "
                             f"{float(err.max()):.3g} past the tolerance")
    return float(err.max())


def _mm_times(fn, plain, library, m, k, n, dtype, plain_reps: int = 5):
    """Times of one product: ``ms`` (CUDA-event median of single calls,
    the wrapper's host work included), ``device_ms`` (back-to-back calls,
    ``tools/probe_int8_dot.py::device_ms``), the plain version's ms, the
    library call's both, the bound and the kernel's TOPS on device time."""
    from frcnn_tpu_torch.tools.probe_int8_dot import device_ms

    bms, by = _mm_bound(m, k, n, dtype)
    r = {"ms": time_ms(fn), "device_ms": device_ms(fn, PROBE_ITERS),
         "plain_ms": None if plain is None else time_ms(
             plain, reps=plain_reps, warmup=1),
         "library_ms": time_ms(library),
         "library_device_ms": device_ms(library, PROBE_ITERS),
         "bound_ms": bms, "bound_by": by}
    r["tops"] = 2.0 * m * k * n / r["device_ms"] / 1e9
    return r


def _mm_line(what: str, r) -> str:
    return (f"{what}: kernel {r['ms']:.4f} ms ({r['device_ms']:.5f} device, "
            f"{r['tops']:.1f} TOPS), library {r['library_ms']:.4f} ms "
            f"({r['library_device_ms']:.5f} device), plain "
            + ("-" if r["plain_ms"] is None else f"{r['plain_ms']:.4f}")
            + f" ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")


def _chain_gemms(cfg):
    """Every distinct (M, K, N) of the int8 chain's products at B and
    IMAGE_HW, each with a conv that makes it: (M, K, N, name, NHWC input
    shape, kh, kw, padding, outputs)."""
    out = {}
    for _, name, shape, kh, kw, (ph, pw), n in _conv_layers(cfg, IMAGE_HW):
        b, h, w, c = shape
        m = b * (h + 2 * ph - kh + 1) * (w + 2 * pw - kw + 1)
        key = (max(m, 17), -(-kh * kw * c // 8) * 8, -(-n // 8) * 8)
        out.setdefault(key, (name, shape, kh, kw, ((ph, ph), (pw, pw)), n))
    return [(*k, *v) for k, v in sorted(out.items())]


def _probe_sweep(K, gen):
    """The int8 chain's GEMMs of vgg_small at B=8, 450x800, each as
    ``ops/int8_conv.py``'s ``im2col`` and ``weight_matrix`` build it, B
    K-contiguous (``wmat.t()``, the chain's call): the kernel bitwise
    ``torch._int_mm``; kernel, library and bound times."""
    from frcnn_tpu_torch.config import serving_config
    from frcnn_tpu_torch.ops import int8_conv
    from frcnn_tpu_torch.tools.probe_int8_dot import device_ms

    t = time.perf_counter()
    rows = []
    for m, k, n, name, shape, kh, kw, pad, n_out in _chain_gemms(
            serving_config()):
        xq = torch.randint(-127, 128, shape, device="cuda", generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n_out, shape[3], kh, kw),
                           device="cuda", generator=gen, dtype=torch.int8)
        a = int8_conv.im2col(xq, kh, kw, pad)
        b = int8_conv.weight_matrix(wq).t()
        if tuple(a.shape) != (m, k) or tuple(b.shape) != (k, n) or \
                K.route(a, b) != "tma":
            raise AssertionError(f"probe: {name} gives {tuple(a.shape)} x "
                                 f"{tuple(b.shape)} ({K.route(a, b)})")
        got = K.mm(a, b)
        if not torch.equal(got, torch._int_mm(a, b)):
            raise AssertionError(f"probe: {name} {m}x{k}x{n} differs from "
                                 f"torch._int_mm")
        del got
        dms = device_ms(lambda: K.mm(a, b), PROBE_ITERS)
        lms = device_ms(lambda: torch._int_mm(a, b), PROBE_ITERS)
        bms, by = _mm_bound(m, k, n, torch.int8)
        rows.append({"conv": name, "shape": [m, k, n], "device_ms": dms,
                     "library_device_ms": lms, "bound_ms": bms,
                     "bound_by": by})
        print(f"[probe] sweep {name} {m}x{k}x{n}: == torch._int_mm; kernel "
              f"{dms:.5f} ms, _int_mm {lms:.5f} ms ({dms / lms:.2f}x), "
              f"bound {bms:.5f} ms ({by}; kernel at "
              f"{100 * bms / dms:.0f}%)", flush=True)
        del xq, wq, a, b
    torch.cuda.empty_cache()
    k_tot = sum(r["device_ms"] for r in rows)
    l_tot = sum(r["library_device_ms"] for r in rows)
    log("probe", f"chain sweep: {len(rows)} GEMMs bitwise torch._int_mm "
        f"with B K-contiguous; device ms summed: kernel {k_tot:.4f}, "
        f"_int_mm {l_tot:.4f}", t)
    return rows


def phase_probe(kernels):
    """Row 7, the int8 matmul probe's kernels (``csrc/matmul.cu``): the
    TMA/``wgmma`` route (``mm``) and the ``mma.sync`` route (``mm_sync``).
    ``tools/probe_int8_dot.py`` at its default 1024^3 (TMA) and at an
    unaligned shape (``mma.sync``), the launches of both counted; then on
    both routes the kernel against its plain version
    (``ops/matmul.py::mm_plain``): at 1024^3 s8 bitwise, bf16 bitwise on
    the probe's integer values and within 2^-20 sum|a_ik b_kj| on normal
    values; on edge shapes of each route s8 and bf16 bitwise (integer
    values), the TMA route's also with B K-contiguous; a product whose
    int32 sums wrap on each route, bitwise. Times at 1024^3 of both routes
    beside the plain version and the library (``torch._int_mm``,
    ``torch.matmul``): single-call medians and device time of back-to-back
    calls. The int8 chain's largest GEMM in both B layouts, bitwise
    ``torch._int_mm`` and the plain version on its first rows, timed the
    same way; then every GEMM of the chain (:func:`_probe_sweep`)."""
    from frcnn_tpu_torch.ops import matmul_kernel as K
    from frcnn_tpu_torch.ops.matmul import mm_plain
    from frcnn_tpu_torch.tools import probe_int8_dot as P

    _f32()
    t = time.perf_counter()
    n = 1024
    lines, launches = _tool("probe_int8_dot", P.main,
                            [str(n)] * 3 + [str(PROBE_ITERS)], "probe")
    lines_s, launches_s = _tool("probe_int8_dot", P.main,
                                [*map(str, PROBE_SYNC_TOOL),
                                 str(PROBE_ITERS)], "probe")
    recs = [json.loads(lines[0]), json.loads(lines_s[0])]
    routes = [json.loads(ln).get("route") for ln in lines[1:3] + lines_s[1:3]]
    if not all(r["builds"] and r["exact"] and r["exact_bf16"]
               for r in recs) or set(launches) != {"mm"} or \
            set(launches_s) != {"mm_sync"} or \
            routes != ["tma", "tma", "sync", "sync"]:
        raise AssertionError(f"probe: {recs}, routes {routes}, launches "
                             f"{launches}, {launches_s}")
    log("probe", f"probe_int8_dot {n}^3 and {PROBE_SYNC_TOOL} x "
        f"{PROBE_ITERS}: s8 and bf16 exact; launches {launches} (TMA "
        f"route), {launches_s} (mma.sync route)", t)

    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)

    def ints(shape, hi, dtype=torch.int8):
        return torch.randint(-hi, hi + 1, shape, device="cuda",
                             generator=gen, dtype=torch.int8).to(dtype)

    a8, b8, abf, bbf = P.operands(n, n, n, "cuda")
    an = torch.randn(n, n, device="cuda", generator=gen).to(torch.bfloat16)
    bn = torch.randn(n, n, device="cuda", generator=gen).to(torch.bfloat16)
    err_bf = {}
    for via in ("tma", "sync"):
        _mm_check(K, mm_plain, a8, b8, "s8 1024^3", via)
        _mm_check(K, mm_plain, abf, bbf, "bf16 1024^3, integer values", via)
        err_bf[via] = _mm_check(
            K, mm_plain, an, bn, "bf16 1024^3, normal values", via,
            lambda a, b: 2.0 ** -20 * (a.float().abs() @ b.float().abs()))
        # |values| <= 15: every partial sum below 2^24 up to K = 74,565
        for m, k, nn in PROBE_TMA_EDGES + (PROBE_EDGES if via == "sync"
                                           else ()):
            a = ints((m, k), 127)
            _mm_check(K, mm_plain, a, ints((k, nn), 127), f"s8 {m}x{k}x{nn}",
                      via)
            _mm_check(K, mm_plain, a, ints((nn, k), 127).t(),
                      f"s8 {m}x{k}x{nn}, B K-contiguous", via)
            _mm_check(K, mm_plain, ints((m, k), 15, torch.bfloat16),
                      ints((k, nn), 15, torch.bfloat16), f"bf16 {m}x{k}x{nn}",
                      via)
    wrapped = {}
    for via, (m, k, nn) in (("sync", PROBE_WRAP), ("tma", PROBE_TMA_WRAP)):
        aw = torch.full((m, k), 127, dtype=torch.int8, device="cuda")
        bw = ints((k, nn), 127)
        bw[:, 0] = 127
        bw[:, 1] = -127
        _mm_check(K, mm_plain, aw, bw, f"s8 {m}x{k}x{nn} (int32 sums wrap)",
                  via)
        if via == "tma":
            _mm_check(K, mm_plain, aw, bw.t().contiguous().t(),
                      f"s8 {m}x{k}x{nn} (int32 sums wrap), B K-contiguous",
                      via)
        wrapped[via] = int(((aw[:1].double() @ bw.double()).abs()
                            >= 2 ** 31).sum())
        if wrapped[via] < 2:
            raise AssertionError(f"probe: the wrap case {m}x{k}x{nn} does "
                                 f"not wrap")
    log("probe", f"mm == plain on both routes: s8 bitwise, bf16 bitwise on "
        f"integer values and within 2^-20 sum|ab| on normal values (max abs "
        f"err {err_bf['tma']:.3g} TMA, {err_bf['sync']:.3g} mma.sync) at "
        f"1024^3; s8 (B N- and K-contiguous) and bf16 bitwise at "
        f"{len(PROBE_TMA_EDGES)} TMA edge shapes {PROBE_TMA_EDGES} on both "
        f"routes and at {len(PROBE_EDGES)} mma.sync edge shapes "
        f"{PROBE_EDGES}; s8 bitwise at {PROBE_TMA_WRAP} (TMA, both B "
        f"layouts) and {PROBE_WRAP} (mma.sync) with {wrapped['tma']} and "
        f"{wrapped['sync']} int32 sums past 2^31", t)

    t = time.perf_counter()
    res = {"tma": {}, "sync": {}}
    for dt, a, b, lib, lib_name in (
            (torch.int8, a8, b8, lambda: torch._int_mm(a8, b8), "_int_mm"),
            (torch.bfloat16, abf, bbf, lambda: torch.matmul(abf, bbf),
             "matmul (bf16 out)")):
        for via in ("tma", "sync"):
            r = _mm_times(lambda: K.mm(a, b, via=via),
                          lambda: mm_plain(a, b), lib, n, n, n, dt)
            res[via][dt] = r
            print(f"[probe] " + _mm_line(
                f"mm {str(dt)[6:]} {n}^3 via {via}, torch.{lib_name}", r),
                flush=True)
    log("probe", f"{n}^3 timed", t)
    del a8, b8, abf, bbf, an, bn

    t = time.perf_counter()
    m, k, nn = PROBE_CHAIN
    a, b = ints((m, k), 127), ints((k, nn), 127)
    # the int8 chain calls torch._int_mm(cols, wmat.t()): B K-contiguous
    bk = b.t().contiguous().t()
    want = torch._int_mm(a, bk)
    if not torch.equal(torch._int_mm(a, b), want):
        raise AssertionError("probe: torch._int_mm differs by B's layout")
    for via, bb, lay in (("tma", b, "N"), ("tma", bk, "K"),
                         ("sync", b, "N")):
        got = K.mm(a, bb, via=via)
        if not torch.equal(got, want) or not torch.equal(
                got[:PROBE_PLAIN_ROWS], mm_plain(a[:PROBE_PLAIN_ROWS], b)):
            raise AssertionError(f"probe: s8 {PROBE_CHAIN} ({via}, B "
                                 f"{lay}-contiguous) differs from "
                                 f"torch._int_mm or the plain version")
        del got
    del want
    chain = {}
    for via, bb, lay in (("tma", bk, "K"), ("tma", b, "N"),
                         ("sync", b, "N")):
        r = _mm_times(lambda: K.mm(a, bb, via=via),
                      (lambda: mm_plain(a, b)) if lay == "N" and via == "tma"
                      else None, lambda: torch._int_mm(a, bb), m, k, nn,
                      torch.int8, plain_reps=3)
        chain[(via, lay)] = r
        print(f"[probe] " + _mm_line(
            f"mm s8 {m}x{k}x{nn} via {via}, B {lay}-contiguous, "
            f"torch._int_mm on the same B", r), flush=True)
    log("probe", f"mm s8 {m}x{k}x{nn} (block 1's second conv at B={B}, "
        f"450x800): both routes and both B layouts == torch._int_mm over "
        f"the whole product and == plain on the first {PROBE_PLAIN_ROWS} "
        f"rows", t)
    del a, b, bk
    torch.cuda.empty_cache()
    sweep = _probe_sweep(K, gen)

    def entry(via, launches_n):
        r8 = res[via][torch.int8]
        ck = chain[(via, "K")] if via == "tma" else None
        cn = chain[(via, "N")]
        plain = chain[("tma", "N")]["plain_ms"]
        return {"launches": launches_n, "max_abs_err": 0.0, **r8,
                "bf16": {**res[via][torch.bfloat16],
                         "max_abs_err_normal": err_bf[via]},
                "chain": {"shape": list(PROBE_CHAIN),
                          **({"b_kmajor": ck} if ck else {}),
                          "b_nmajor": {**cn, "plain_ms": plain}}}

    kernels["mm"] = {**entry("tma", launches["mm"]), "chain_sweep": sweep}
    kernels["mm_sync"] = entry("sync", launches_s["mm_sync"])


# -- the micro-benchmarks ------------------------------------------------------------

MICRO_ITERS = 2
MICRO_BLOCK0_B = 2


def phase_micro(kernels):
    """``tools/bench_block0.py`` (B=2, every variant, then ``normparts``),
    ``tools/bench_pool_bwd.py`` and ``tools/bench_scan.py`` through their
    ``main`` at 2 iterations, their lines printed; the block0 kernel's and
    the pool backward kernel's launches in them."""
    from frcnn_tpu_torch.tools import bench_block0, bench_pool_bwd, bench_scan

    t = time.perf_counter()
    n = str(MICRO_ITERS)
    _, b0 = _tool("bench_block0", bench_block0.main,
                  [str(MICRO_BLOCK0_B), n, *bench_block0.VARIANTS], "micro")
    _tool("bench_block0 normparts", bench_block0.main,
          ["normparts", str(MICRO_BLOCK0_B), n], "micro")
    _, pb = _tool("bench_pool_bwd", bench_pool_bwd.main, [n], "micro")
    _tool("bench_scan", bench_scan.main, [n], "micro")
    if set(b0) != {"fused_block0"} or set(pb) != {"pool_bwd"}:
        raise AssertionError(f"micro: launches {b0} (bench_block0), {pb} "
                             f"(bench_pool_bwd)")
    kernels["fused_block0"]["launches_micro"] = b0["fused_block0"]
    kernels["pool_bwd"]["launches_micro"] = pb["pool_bwd"]
    log("micro", f"bench_block0 B={MICRO_BLOCK0_B} (all variants, "
        f"normparts), bench_pool_bwd, bench_scan at {MICRO_ITERS} "
        f"iterations; launches {b0} and {pb}", t)


# -- the accuracy tools ------------------------------------------------------------

ACC_IMAGES = 24      # a quarter of them the validation split
TINY_STEPS = 160
PHOTO_SCENES = 8     # imagenet_smoke photo scenes read back
PHOTO_STEPS = 8      # train_synthetic_eval --scale imagenet_smoke


def _tool(name: str, main, argv, phase: str = "accuracy"):
    """One in-process run of a tool's ``main`` on the card, the launch
    counts set to 0 just before it, its output lines printed under
    ``[phase]``; returns (lines, launches)."""
    _zero_launches()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    launches = _launches()
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"[{phase}] {name}: {ln}", flush=True)
    if rc != 0:
        raise AssertionError(f"{phase}: {name} returned {rc}")
    print(f"[{phase}] {name}: {time.perf_counter() - t:.2f} s wall; "
          f"launches {launches}", flush=True)
    return lines, launches


def phase_accuracy(root: Path, device: str = "cuda"):
    """The accuracy tools on the card: the duplo-scale synthetic scenes
    (24 PNGs of 800x450, seed 0) and a checkpoint (the detect phase's
    weights) make a run directory; eval_quant_parity over its four headline
    modes, sweep_conf_gate, recall_attribution (fg 0.5, 0.95) and
    analyze_detections on it; then train_synthetic_eval at the tiny scale.
    Every mAP is printed; no accuracy limit: a path check."""
    from frcnn_tpu_torch.data.importers import create_duplo_manifest
    from frcnn_tpu_torch.tools import (
        analyze_detections,
        eval_quant_parity,
        recall_attribution,
        sweep_conf_gate,
        train_synthetic_eval,
    )
    from frcnn_tpu_torch.utils.serialization import (
        load_checkpoint,
        save_checkpoint,
    )
    from frcnn_tpu_torch.utils.weights import to_jax_params

    t = time.perf_counter()
    run, data = root / "acc", root / "acc" / "dataset"
    w, h, lo, hi, n_cls = train_synthetic_eval.SCALES["duplo"][:5]
    csv = train_synthetic_eval.make_dataset(str(data), ACC_IMAGES, w, h,
                                            n_cls, lo, hi, seed=0)
    manifest = str(data / "manifest.json")
    create_duplo_manifest("synthetic-duplo", csv, None, manifest,
                          validation_size=0.25, seed=0)
    cfg = train_synthetic_eval.duplo_scale_cfg(n_cls).replace(
        examples_base_path=str(data))
    if CKPT.exists():
        payload = load_checkpoint(str(CKPT))
        params, stats, step = (payload["params"], payload["batch_stats"],
                               int(payload["step"]))
        src = f"{CKPT.relative_to(ROOT)} (step {step})"
    else:
        pnet, cnet = _seeded_models(cfg)
        params, stats = to_jax_params(pnet.state_dict(), cnet.state_dict(),
                                      cfg)
        step, src = 0, "seeded initialisation (no checkpoint in the tree)"
    save_checkpoint(str(run / "final.ckpt"), params=params,
                    batch_stats=stats, step=step, config_json=cfg.to_json())
    log("accuracy", f"{ACC_IMAGES} duplo-scale PNGs of {w}x{h} (seed 0) and "
        f"the weights of {src} in {run.name}/final.ckpt", t)

    t = time.perf_counter()
    common = ["--run", str(run), "--scale", "duplo", "--device", device]
    n_val = str(ACC_IMAGES // 4)
    _, launches = _tool("eval_quant_parity", eval_quant_parity.main,
                        [*common, "--eval-count", n_val, "--calib-count",
                         n_val])
    # int8_static_s2d: the float block0 kernel (the duplo config's chain
    # is not s8-pooled), both NMS calls and the ROI pool
    if device == "cuda" and not {"fused_block0", "nms_keep_mask",
                                 "roi_pool"} <= set(launches):
        raise AssertionError(f"eval_quant_parity: launches {launches}")
    _tool("sweep_conf_gate", sweep_conf_gate.main,
          [*common, "--eval-count", n_val])
    _tool("recall_attribution", recall_attribution.main,
          [*common, "--eval-count", n_val, "--fg", "0.5,0.95"])
    _tool("analyze_detections", analyze_detections.main,
          ["--ckpt", str(run / "final.ckpt"), "--manifest", manifest,
           "--count", n_val, "--device", device])
    log("accuracy", "eval_quant_parity, sweep_conf_gate, "
        "recall_attribution and analyze_detections ran on the card", t)

    t = time.perf_counter()
    lines, _ = _tool("train_synthetic_eval", train_synthetic_eval.main,
                     ["--scale", "tiny", "--steps", str(TINY_STEPS),
                      "--out", str(root / "tiny"), "--chunk", "16",
                      "--eval-count", "15", "--demo-count", "2",
                      "--device", device])
    result = json.loads((root / "tiny" / "result.json").read_text())
    if result["steps"] != TINY_STEPS:
        raise AssertionError(f"train_synthetic_eval: {result}")
    log("accuracy", f"train_synthetic_eval --scale tiny, {TINY_STEPS} "
        f"steps: mAP {result['mAP']:.4f} over {result['num_images']} "
        f"images, loss {result['first_loss_mean_25']:.4f} -> "
        f"{result['final_loss_mean_last25']:.4f}", t)
    _photo_scenes(root / "photo")

    t = time.perf_counter()
    run = root / "imagenet_smoke"
    _tool("train_synthetic_eval", train_synthetic_eval.main,
          ["--scale", "imagenet_smoke", "--steps", str(PHOTO_STEPS),
           "--images", str(PHOTO_SCENES), "--out", str(run), "--chunk",
           "4", "--eval-count", "2", "--demo-count", "1", "--device",
           device])
    result = json.loads((run / "result.json").read_text())
    if result["steps"] != PHOTO_STEPS or not np.isfinite(
            result["final_loss_mean_last25"]):
        raise AssertionError(f"train_synthetic_eval: {result}")
    log("accuracy", f"train_synthetic_eval --scale imagenet_smoke (vgg_large"
        f", photo scenes, both buckets), {PHOTO_STEPS} steps: mAP "
        f"{result['mAP']:.4f} over {result['num_images']} images, loss "
        f"{result['first_loss_mean_25']:.4f} -> "
        f"{result['final_loss_mean_last25']:.4f}", t)


def _photo_scenes(root: Path):
    """imagenet_smoke photo scenes (mixed orientation, seed 0) written
    and read back through a ``BatchIterator``: every file of the CSV but
    the corrupt ones decoded into one of the two buckets (both seen), the
    corrupt ones skipped and logged."""
    from frcnn_tpu_torch.data.importers import create_duplo_manifest
    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.tools import train_synthetic_eval as TSE

    t = time.perf_counter()
    w, h, lo, hi, n_cls, cfg_fn, maker = TSE.scale_spec("imagenet_smoke")
    csv = maker(str(root), PHOTO_SCENES, w, h, n_cls, lo, hi, seed=0)
    gen_s = time.perf_counter() - t
    # every file of the CSV in the validation split
    manifest = create_duplo_manifest("photo", csv, None,
                                     validation_size=PHOTO_SCENES, seed=0)
    names = manifest["validation_set"]
    corrupt = [n for n in names
               if (root / n).read_bytes() == TSE.CORRUPT_BYTES]
    cfg = cfg_fn(n_cls).replace(examples_base_path=str(root))
    capture = _LogCapture()
    logging.getLogger("frcnn_tpu_torch.data").addHandler(capture)
    try:
        items = BatchIterator(cfg, manifest, seed=0).next_validation(
            len(names) - len(corrupt))
    finally:
        logging.getLogger("frcnn_tpu_torch.data").removeHandler(capture)
    shapes = sorted({it["image"].shape for it in items})
    buckets = {cfg.shapes.bucket_for(*sh[:2]) for sh in shapes}
    skipped = [m for m in capture.messages if "Invalid image" in m]
    if len(items) != len(names) - len(corrupt) or len(buckets) != 2 or \
            len(skipped) != len(corrupt) or not corrupt:
        raise AssertionError(f"accuracy: photo scenes {len(names)} in the "
                             f"CSV, {len(corrupt)} corrupt, {len(items)} "
                             f"read, shapes {shapes}, logged {skipped}")
    log("accuracy", f"{PHOTO_SCENES} imagenet_smoke photo scenes of {w}x{h} "
        f"(mixed orientation) written in {gen_s:.2f} s; {len(names)} in the "
        f"CSV read back through BatchIterator: {len(items)} decoded "
        f"({shapes}, buckets {sorted(buckets)}), {len(corrupt)} corrupt "
        f"skipped and logged ({skipped[0]!r})", t)


# -- shapes -------------------------------------------------------------------
# Every shape the Pallas kernels of rows 1, 2, 3, 4 and 6 take that the
# published configurations do not reach: kernel-level cases against the
# plain versions, then paths (a)-(d) through Detector.detect and
# Trainer.run_step with the kernels on.

SHAPE_ROI_BINS = ((9, 9), (14, 14), (3, 16))     # at C = 384
SHAPE_ROI_C = (12, 20)                           # at 6x6
SHAPE_ROI_D = 32
# row 4 only: (B, H, W, C, D) at 6x6; a 4-row map 32768 wide, then row
# bins of 33 and 68 rows (two- and three-word tie masks)
SHAPE_ROI_BWD_MAPS = ((2, 4, 32768, 16, 32), (2, 188, 50, 64, 32),
                      (2, 400, 50, 64, 32))
SHAPE_BLOCK0_F = (8, 24, 96, 128)
SHAPE_2CONV_F = (8, 32, 128)
SHAPE_2CONV_BHW = (2, 480, 1000)
SHAPE_NMS = ((87553, 100), (120000, 100))        # (N, picks) at B = 2
POOL9 = 9                                        # path (a)'s ROI pool
TALL_HW, TALL_B = (3008, 480), 2                 # path (b)
NARROW_F = 32                                    # paths (c) and (d)
SHAPE_CALLS = 1


def _shape_record(kernels, name: str, case: str, launches: int, err: float,
                  ms: float, pms: float, bms: float, by: str) -> None:
    kernels[name].setdefault("shapes", []).append(
        {"case": case, "launches": launches, "max_abs_err": err, "ms": ms,
         "plain_ms": pms, "bound_ms": bms, "bound_by": by})


def _one_launch(kernel, fn):
    """``fn()`` with ``kernel``'s launches counted: (result, launches)."""
    kernel.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, kernel.launches


def _levels(gen, shape, dtype):
    """A map of four levels (ties inside bins and across them) on the
    card."""
    return (torch.randint(0, 4, shape, generator=gen).float() / 4).to(
        dtype).cuda()


def _shape_rects(gen, b: int, H: int, W: int, D: int, span: float = 0.8):
    """D prepared rects per image of up to ``span`` of the map, the first
    of each image the whole map (the tallest row bins), ~3/4 valid."""
    from frcnn_tpu_torch.ops import roi_pool as plain

    p0 = torch.rand(b, D, 2, generator=gen) * torch.tensor([W, H])
    ext = torch.rand(b, D, 2, generator=gen) * torch.tensor([W, H]) * span
    raw = torch.cat([p0 - 2, p0 + ext], dim=-1).floor()
    raw[:, 0] = torch.tensor([0.0, 0.0, W, H])
    rects = plain.prepare_roi_rects(raw, float(W), float(H))
    valid = torch.rand(b, D, generator=gen) < 0.75
    valid[:, 0] = True
    return rects.cuda(), valid.cuda()


def _roi_bwd_values(K, plain, fm, rects, valid, g, kh, kw, what):
    """The backward kernel against its plain version (float32 within atol
    1e-6 and the count of values not bitwise equal, bf16 within one ulp)
    and two launches bitwise equal; returns (max abs err, launches of the
    first call, values that differ, the plain call's CUDA-event ms)."""
    run = lambda: K.adaptive_max_pool_valid_backward(fm, rects, valid, g,
                                                     kh, kw)
    got, n = _one_launch(K.BWD_KERNEL, run)
    again = run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = plain.adaptive_max_pool_backward(fm, rects, valid, g, kh, kw)
    end.record()
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.uint8), again.view(torch.uint8)):
        raise AssertionError(f"roi_pool_bwd {what}: two launches differ")
    if fm.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    elif _ulps(got, ref) > 1:
        raise AssertionError(f"roi_pool_bwd {what}: {_ulps(got, ref)} ulps "
                             f"apart")
    err = float((got.float() - ref.float()).abs().max())
    return err, n, int((got != ref).sum()), start.elapsed_time(end)


def shapes_roi_pool(gen, kernels):
    """Rows 2 and 4 at kh x kw past 8 and C off the 16-byte vector; row 4
    also on a 32768-wide map and on row bins of more than 32 rows."""
    from frcnn_tpu_torch.ops import roi_pool as plain
    from frcnn_tpu_torch.ops import roi_pool_kernel as K

    H, W, _ = FM_HWC
    cases = [(2, H, W, 384, SHAPE_ROI_D, kh, kw) for kh, kw in SHAPE_ROI_BINS]
    cases += [(2, H, W, C, SHAPE_ROI_D, 6, 6) for C in SHAPE_ROI_C]
    cases += [(b, h, w, c, d, 6, 6) for b, h, w, c, d in SHAPE_ROI_BWD_MAPS]
    for b, h, w, C, D, kh, kw in cases:
        t = time.perf_counter()
        rects, valid = _shape_rects(gen, b, h, w, D)
        g32 = torch.randn(b, D, kh, kw, C, generator=gen).cuda()
        fm32 = _levels(gen, (b, h, w, C), torch.float32)
        route = K.backward_plan(D, h, w, C, kh, kw)
        parts = []
        for dt in (torch.float32, torch.bfloat16):
            fm, g = fm32.to(dt), g32.to(dt)
            what = f"B={b} {h}x{w}x{C} {kh}x{kw} {str(dt)[6:]}"
            forward = w < 32768     # the 32768-wide map: backward only
            if forward:
                got, nf = _one_launch(K.KERNEL, lambda: (
                    K.adaptive_max_pool_valid(fm, rects, valid, kh, kw)))
                ref = plain.adaptive_max_pool(fm, rects, valid, kh, kw)
                bits = torch.int16 if dt == torch.bfloat16 else torch.int32
                if not torch.equal(got.view(bits), ref.view(bits)):
                    raise AssertionError(f"roi_pool {what}: kernel and plain "
                                         f"differ")
            err, nb, n_diff, pms_b = _roi_bwd_values(
                K, plain, fm, rects, valid, g, kh, kw, what)
            ms_b = time_ms(lambda: K.adaptive_max_pool_valid_backward(
                fm, rects, valid, g, kh, kw), reps=3, warmup=1)
            r = rects.to(torch.int64)[valid].cpu()
            cells = float(((r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])).sum())
            n_bytes = (2 * fm.numel() + int(valid.sum()) * kh * kw * C) \
                * fm.element_size() + rects.numel() * 4 + valid.numel()
            bms_b, by_b = bound_ms(n_bytes, 2.0 * cells * C, dt)
            _shape_record(kernels, "roi_pool_bwd", what, nb, err, ms_b, pms_b,
                          bms_b, by_b)
            text = (f"{str(dt)[6:]}: backward max abs err {err:.3g}, "
                    f"{n_diff} values not bitwise, {nb} launch, {ms_b:.4f} ms"
                    f" (plain {pms_b:.2f}, bound {bms_b:.5f} {by_b})")
            if forward:
                ms_f = time_ms(lambda: K.adaptive_max_pool_valid(
                    fm, rects, valid, kh, kw), reps=5, warmup=1)
                pms_f = time_ms(lambda: plain.adaptive_max_pool(
                    fm, rects, valid, kh, kw), reps=1, warmup=0)
                bms_f, by_f = _roi_bound(fm, rects, valid, got, kh, kw)
                _shape_record(kernels, "roi_pool", what, nf, 0.0, ms_f,
                              pms_f, bms_f, by_f)
                text = (f"{str(dt)[6:]}: forward bitwise, {nf} launch, "
                        f"{ms_f:.4f} ms (plain {pms_f:.2f}, bound "
                        f"{bms_f:.5f} {by_f}); " + text.split(": ", 1)[1])
            parts.append(text)
        log("shapes", f"roi_pool B={b} {h}x{w}x{C}, {D} rects/image "
            f"({int(valid.sum())} valid), {kh}x{kw} (forward route "
            f"{K.forward_plan(C, kh, kw, torch.bfloat16)}, backward "
            f"(route, words) {route}): " + "; ".join(parts), t)


def shapes_block0(gen, kernels):
    """Row 3 at F = 8, 24, 96 and 128: both dtypes, both output modes."""
    from frcnn_tpu_torch.ops import block0_kernel as K

    H, W = IMAGE_HW
    planes = K.pack_padded(torch.randn(B, H + 2, W + 2, 3,
                                       generator=gen).cuda())
    slope = torch.tensor([0.25], device="cuda")
    for Fo in SHAPE_BLOCK0_F:
        t = time.perf_counter()
        w = (torch.randn(Fo, 3, 3, 3, generator=gen) * 0.3).cuda()
        bias = (torch.randn(Fo, generator=gen) * 0.1).cuda()
        parts = []
        for dt in (torch.float32, torch.bfloat16):
            w27, b32 = K.block0_weights(w, bias, dt)
            l, c = (x.to(dt) for x in planes)
            (got, err, _, n_mis), n = _one_launch(
                K.KERNEL, lambda: _block0_values(K, l, c, w27, b32, slope))
            inv = _inv(_absmax_scale(K.block0_plain(l, c, w27, b32, slope)))
            q, nq = _one_launch(K.S8_KERNEL, lambda: K.fused_block0(
                l, c, w27, b32, slope, inv_out=inv))
            step, share = _flips(q, K.block0_plain(l, c, w27, b32, slope,
                                                   inv_out=inv),
                                 f"block0_s8out F={Fo} {str(dt)[6:]}")
            if tuple(got.shape) != (B, H // 2, W // 2, Fo):
                raise AssertionError(f"fused_block0 F={Fo}: shape "
                                     f"{tuple(got.shape)}")
            ms = time_ms(lambda: K.fused_block0(l, c, w27, b32, slope))
            ms_q = time_ms(lambda: K.fused_block0(l, c, w27, b32, slope,
                                                  inv_out=inv))
            pms = time_ms(lambda: K.block0_plain(l, c, w27, b32, slope),
                          reps=3, warmup=0)
            n_ops = 2.0 * B * (H // 2) * (W // 2) * Fo * 4 * 27
            into = (l.numel() + c.numel() + 27 * Fo) * l.element_size() \
                + 4 * (Fo + 2)
            bms, by = bound_ms(into + got.numel() * got.element_size(),
                               n_ops, dt)
            bms_q, by_q = bound_ms(into + q.numel(), n_ops, dt)
            what = f"F={Fo} {str(dt)[6:]} B={B} {H}x{W}"
            _shape_record(kernels, "fused_block0", what, n, err, ms, pms, bms,
                          by)
            _shape_record(kernels, "block0_s8out", what, nq, float(step),
                          ms_q, pms, bms_q, by_q)
            parts.append(f"{str(dt)[6:]} (w27 {tuple(w27.shape)}): float out "
                         f"max abs err {err:.3g} ({n_mis} values differ), "
                         f"{n} launch, {ms:.4f} ms (bound {bms:.5f} {by}); "
                         f"int8 out {step} step apart in {100 * share:.4f}%,"
                         f" {nq} launch, {ms_q:.4f} ms (bound {bms_q:.5f} "
                         f"{by_q}); plain {pms:.3f} ms")
        log("shapes", f"fused_block0 F={Fo} B={B} {H}x{W}: "
            + "; ".join(parts), t)


def shapes_block0_2conv(gen, kernels):
    """Row 6 at F = 8, 32 and 128 in its three modes: float conv1, int8
    conv1 (float and int8 out), float conv1 with int8 out."""
    from frcnn_tpu_torch.models.quant import quantize_weight
    from frcnn_tpu_torch.ops import block0_2conv_kernel as K
    from frcnn_tpu_torch.ops.block0_kernel import pack_padded, unpack_s2d

    b, H, W = SHAPE_2CONV_BHW
    padded = torch.randn(b, H + 2, W + 2, 3, generator=gen).cuda()
    s0, s1 = 0.25, 0.1
    for Fo in SHAPE_2CONV_F:
        t = time.perf_counter()
        std = (2.0 / (9 * Fo)) ** 0.5
        w0 = (torch.randn(Fo, 3, 3, 3, generator=gen) * std).cuda()
        w1 = (torch.randn(Fo, Fo, 3, 3, generator=gen) * std).cuda()
        b0 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
        b1 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
        w1q, s_w = quantize_weight(w1)
        parts = []
        for dt in (torch.float32, torch.bfloat16):
            p = K.block0_2conv_weights(w0, b0, w1, b1, s0, s1, dt)
            l, c = (x.to(dt) for x in pack_padded(padded))
            what = f"F={Fo} {str(dt)[6:]} B={b} {H}x{W}"
            (got, err, tol, n_mis), n = _one_launch(
                K.KERNEL, lambda: _check_2conv_values(K, l, c, p))
            if tuple(got.shape) != (b, H // 2, W // 2, Fo):
                raise AssertionError(f"fused_block0_2conv F={Fo}: shape "
                                     f"{tuple(got.shape)}")
            y0 = F.conv2d(unpack_s2d(l, c).float(), w0.to(dt).float(), b0)
            s_y = _absmax_scale(torch.where(y0 >= 0, y0, s0 * y0))
            del y0
            wq9, ws = K.block0_2conv_weights_q(w1q, s_w, s_y)
            qa = (p.w0, p.b0, wq9, p.b1, p.slopes)
            inv_y = _inv(s_y)
            (fl, ferr, fshare), nq = _one_launch(
                K.INT8_KERNEL, lambda: _int8_conv1_values(
                    K, l, c, qa, ws, inv_y, s_y, w1, what))
            inv_o = _inv(_absmax_scale(fl))
            q8 = K.fused_block0_2conv(l, c, *qa, w1_scale=ws, inv_y=inv_y,
                                      inv_out=inv_o)
            step, share = _flips(q8, K.block0_2conv_plain(
                l, c, *qa, w1_scale=ws, inv_y=inv_y, inv_out=inv_o), what)
            fo = K.fused_block0_2conv(l, c, *p, inv_out=inv_o)
            fstep, fo_share = _flips(fo, K.block0_2conv_plain(
                l, c, *p, inv_out=inv_o), f"{what} float conv1, int8 out")
            ms = time_ms(lambda: K.fused_block0_2conv(l, c, *p), reps=5,
                         warmup=1)
            ms_q = time_ms(lambda: K.fused_block0_2conv(
                l, c, *qa, w1_scale=ws, inv_y=inv_y, inv_out=inv_o), reps=5,
                warmup=1)
            ms_fo = time_ms(lambda: K.fused_block0_2conv(
                l, c, *p, inv_out=inv_o), reps=5, warmup=1)
            pms = time_ms(lambda: K.block0_2conv_plain(l, c, *p), reps=1,
                          warmup=0)
            pms_q = time_ms(lambda: K.block0_2conv_plain(
                l, c, *qa, w1_scale=ws, inv_y=inv_y, inv_out=inv_o), reps=1,
                warmup=0)
            n_pix = float(b * H * W)
            into = (l.numel() + c.numel() + 27 * Fo) * l.element_size() \
                + 4 * (2 * Fo + 2)
            bms, by = bound_ms(into + 9 * Fo * Fo * l.element_size()
                               + got.numel() * got.element_size(),
                               2.0 * n_pix * Fo * (27 + 9 * Fo), dt)
            bms_q, by_q = bound_ms_of(
                into + 9 * Fo * Fo + 4 * Fo + q8.numel(),
                {dt: 2.0 * n_pix * Fo * 27,
                 torch.int8: 2.0 * n_pix * Fo * 9 * Fo})
            _shape_record(kernels, "fused_block0_2conv", what, n, err, ms, pms,
                          bms, by)
            _shape_record(kernels, "block0_2conv_int8", what, nq, float(step),
                          ms_q, pms_q, bms_q, by_q)
            parts.append(
                f"{str(dt)[6:]}: float {n} launch, max abs err {err:.3g} "
                f"({tol}; {n_mis} differ), {ms:.4f} ms (bound {bms:.5f} {by},"
                f" plain {pms:.2f}); int8 conv1 {nq} launch, float out "
                f"{100 * fshare:.4f}% past the float tolerance (max "
                f"{ferr:.3g}), int8 out {step} step in {100 * share:.4f}%, "
                f"{ms_q:.4f} ms (bound {bms_q:.5f} {by_q}, plain "
                f"{pms_q:.2f}); float conv1 int8 out {fstep} step in "
                f"{100 * fo_share:.4f}%, {ms_fo:.4f} ms")
            del got, fl, q8, fo
        torch.cuda.empty_cache()
        log("shapes", f"fused_block0_2conv F={Fo} (padded to {K.plan(Fo)}) "
            f"B={b} {H}x{W}: " + "; ".join(parts), t)


def shapes_nms(gen, kernels):
    """Row 1 past the largest staged image (each block reads its share
    from device memory): N = 87553 and 120000, B = 2, 100 picks."""
    plain = importlib.import_module(NMS_MODULE)
    from frcnn_tpu_torch.ops import nms_kernel as K

    for n, m in SHAPE_NMS:
        t = time.perf_counter()
        boxes, valid = _scattered(gen, 2, n, (3000.0, 3000.0), 8, 160)
        boxes, valid = boxes.cuda(), valid.cuda()
        (keep, _), nl = _one_launch(K.KERNEL, lambda: _nms_equal(
            K, plain, boxes, valid, 0.7, m, f"N={n}"))
        ms = time_ms(lambda: K.nms_keep_slots(boxes, valid, 0.7, m), reps=5,
                     warmup=1)
        pms = time_ms(lambda: plain.nms_keep_slots(boxes, valid, 0.7, m),
                      reps=1, warmup=0)
        picks, bms, by = _nms_stats(keep, boxes, valid, 0.7, m)
        _shape_record(kernels, "nms_keep_mask", f"B=2 N={n} max_out={m}",
                      nl, 0.0, ms, pms, bms, by)
        log("shapes", f"nms_keep_mask B=2 N={n} (direct: {K.plan(n)}) thr "
            f"0.7 max_out={m}: keep masks and slots bitwise the plain "
            f"version's, {nl} launch; {picks}; kernel {ms:.4f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.6f} ms ({by})", t)


def _shapes_detect(what: str, cfg, pnet, cnet, counted, quantized=False,
                   ordered=True):
    """float32 detect through the kernels against the plain versions (as
    [detect], or as [detect-int8] with block 0 handed over), then bf16
    serving from packed device planes: launches per call of the kernels
    in ``counted`` {name: launches per call}, finite and non-empty
    outputs."""
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY

    buckets = [tuple(b) for b in cfg.shapes.buckets()]
    batches, calib = _int8_batches(cfg, 11, buckets[:1])
    planes, true_hw = batches[buckets[0]]
    t = time.perf_counter()
    _f32()
    if quantized:
        _check_f32_int8_detect("shapes", cfg, pnet, cnet, batches, calib)
    else:
        cfg32 = cfg.replace(compute_dtype="float32")
        ker = Detector(cfg32, pnet, cnet, device="cuda").detect(planes,
                                                                true_hw)
        ref = Detector(cfg32.replace(pallas_mode="off"), pnet, cnet,
                       device="cuda").detect(planes, true_hw)
        torch.cuda.synchronize()
        _check_f32_detect("shapes", ker, ref, what, t, ordered=ordered)
    t = time.perf_counter()
    kw = {"quantized": True, "quant_calibration": calib} if quantized else {}
    det = Detector(cfg, pnet, cnet, device="cuda", **kw)
    det.detect(planes, true_hw)                 # warm-up
    torch.cuda.synchronize()
    for k in REGISTRY.values():
        k.launches = 0
    t_run = time.perf_counter()
    outs = [det.detect(planes, true_hw) for _ in range(SHAPE_CALLS)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_run) / SHAPE_CALLS * 1e3
    launches = {k: REGISTRY[k].launches for k in counted}
    want = {k: n * SHAPE_CALLS for k, n in counted.items()}
    if launches != want:
        raise AssertionError(f"shapes {what} bf16: launches {launches}, "
                             f"expected {want}")
    out = outs[-1]
    if not all(torch.isfinite(x).all() for x in
               (out.boxes, out.confidence, out.fg_score, out.proposals)):
        raise AssertionError(f"shapes {what} bf16: non-finite outputs")
    n_roi, n_det = int(out.proposals_valid.sum()), int(out.valid.sum())
    if n_roi == 0:
        raise AssertionError(f"shapes {what} bf16: no proposals")
    log("shapes", f"{what}: bf16 {'int8 ' if quantized else ''}serving "
        f"B={planes[0].shape[0]} {buckets[0][0]}x{buckets[0][1]}, "
        f"{wall:.2f} ms/batch, {n_roi} rois, {n_det} detections; launches "
        f"{launches} over {SHAPE_CALLS} calls", t)
    del det
    torch.cuda.empty_cache()


def _shapes_train(what: str, cfg, batch):
    """One float32 step through the kernels against one through the plain
    versions (as [train]), then one bf16 Trainer.run_step with the kernels
    on: finite, not skipped, one launch of the ROI pool forward and
    backward and four of the pool backward."""
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY
    from frcnn_tpu_torch.train.trainer import Trainer

    t = time.perf_counter()
    _f32()
    cfg32 = cfg.replace(compute_dtype="float32")
    (ker,) = _step_grads(cfg32, [batch], "kernel")
    (ref,) = _step_grads(cfg32.replace(pallas_mode="off"), [batch], "library")
    worst, worst_name = _assert_steps_close("shapes", f"{what} float32", ker,
                                            ref)
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, device="cuda", seed=0, pool_vjp="kernel")
    for k in REGISTRY.values():
        k.launches = 0
    t_run = time.perf_counter()
    m = trainer.run_step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_run) * 1e3
    launches = {k: REGISTRY[k].launches
                for k in ("roi_pool", "roi_pool_bwd", "pool_bwd")}
    if launches != {"roi_pool": 1, "roi_pool_bwd": 1, "pool_bwd": 4}:
        raise AssertionError(f"shapes {what} bf16 step: launches {launches}")
    if m["skipped"] != 0 or not all(np.isfinite(m[k]) for k in
                                    ("pcls", "preg", "dcls", "dreg")):
        raise AssertionError(f"shapes {what} bf16 step: skipped or "
                             f"non-finite {m}")
    log("shapes", f"{what}: float32 step kernels == plain versions (losses "
        f"rtol 1e-5, largest relative gradient error {worst:.3g} in "
        f"{worst_name}); one bf16 Trainer.run_step with kernels ({wall:.1f} "
        f"ms, first step), launches {launches}, losses pcls {m['pcls']:.4f} "
        f"preg {m['preg']:.4f} dcls {m['dcls']:.4f} dreg {m['dreg']:.4f}", t)
    del trainer
    torch.cuda.empty_cache()


def _duplo_serving(**changes):
    """vgg_small's serving config at full width (duplo, 6 classes, the
    smoke's bucket), the detect phase's fg gate, with ``changes``."""
    from frcnn_tpu_torch.config import duplo_config, serving_config

    base = duplo_config(class_count=6)
    cfg = serving_config(base.replace(shapes=dataclasses.replace(
        base.shapes, image_hw=IMAGE_HW)))
    return cfg.replace(detect_fg_threshold=0.5, **changes)


def _narrow_first(cfg, filters: int):
    """``cfg`` with its first block's convs at ``filters``."""
    layers = cfg.model.layers
    return cfg.replace(model=dataclasses.replace(cfg.model, layers=(
        dataclasses.replace(layers[0], filters=filters),) + tuple(layers[1:])))


def shapes_paths():
    """Paths (a)-(d): the new shapes as configurations reach them."""
    from frcnn_tpu_torch.config import (
        RoiPoolingConfig,
        imagenet_config,
        serving_config,
    )
    from frcnn_tpu_torch.parallel.dryrun import tiny_config

    small = {"nms_keep_mask": 2, "roi_pool": 1, "fused_block0": 1}
    pool9 = RoiPoolingConfig(kh=POOL9, kw=POOL9)
    # (a) vgg_small, duplo at full width, a 9x9 ROI pool
    cfg = _duplo_serving(roi_pooling=pool9)
    pnet, cnet = _seeded_models(cfg)
    _shapes_detect(f"(a) {POOL9}x{POOL9} ROI pool", cfg, pnet,
                   cnet, small)
    tcfg = _train_config("bfloat16").replace(roi_pooling=pool9)
    _shapes_train(f"(a) {POOL9}x{POOL9} ROI pool B={B} "
                  f"{IMAGE_HW[0]}x{IMAGE_HW[1]}", tcfg,
                  _train_batch(tcfg, 21))
    # (b) vgg_small on tall frames: a 188-row map, row bins of 33 rows
    base = _train_config("bfloat16")
    tcfg = base.replace(max_pixel_size=TALL_HW[0], shapes=dataclasses.replace(
        base.shapes, image_hw=TALL_HW, images_per_step=TALL_B))
    _shapes_train(f"(b) tall frames B={TALL_B} "
                  f"{TALL_HW[0]}x{TALL_HW[1]}", tcfg,
                  _train_batch(tcfg, 22, TALL_HW, TALL_B))
    # (c) vgg_small with a narrow first layer, s2d bf16, float and int8;
    # and the tiny config (a first layer of 8) served with the kernels
    cfg = _narrow_first(_duplo_serving(), NARROW_F)
    pnet, cnet = _seeded_models(cfg)
    what = f"(c) first layer {NARROW_F} filters"
    _shapes_detect(what, cfg, pnet, cnet, small)
    _shapes_detect(what, cfg, pnet, cnet, {
        "nms_keep_mask": 2, "roi_pool": 1, "block0_s8out": 1},
        quantized=True)
    cfg = serving_config(tiny_config(B)).replace(
        compute_dtype="bfloat16", detect_fg_threshold=0.5)
    pnet, cnet = _seeded_models(cfg)
    _shapes_detect("(c) tiny config, first layer 8 filters", cfg,
                   pnet, cnet, small)
    # (d) vgg_large with a narrow first block, float and int8 at 480x1000
    cfg = _narrow_first(serving_config(imagenet_config()), NARROW_F).replace(
        detect_fg_threshold=0.5)
    pnet, cnet = _seeded_models(cfg, cls_spread=500.0)
    what = f"(d) vgg_large first block 2 x {NARROW_F} filters"
    _shapes_detect(what, cfg, pnet, cnet, {
        "nms_keep_mask": 2, "roi_pool": 1, "fused_block0_2conv": 1},
        ordered=False)
    _shapes_detect(what, cfg, pnet, cnet, {
        "nms_keep_mask": 2, "roi_pool": 1, "block0_2conv_int8": 1},
        quantized=True)


def phase_shapes(kernels):
    gen = torch.Generator().manual_seed(19)
    _f32()
    shapes_roi_pool(gen, kernels)
    shapes_block0(gen, kernels)
    shapes_block0_2conv(gen, kernels)
    shapes_nms(gen, kernels)
    shapes_paths()


def main() -> int:
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    name, smi = phase_env()
    phase_build()
    kernels, two_conv = phase_kernels()
    phase_api(kernels, smi)
    kernels.update(phase_kernels_int8(two_conv))
    phase_probe(kernels)
    phase_detect(kernels)
    phase_detect_large(kernels)
    phase_detect_int8(kernels)
    kernels.update(phase_train_kernels())
    steps_ms = phase_train(kernels)
    phase_train_large(kernels)
    phase_shapes(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        phase_data(kernels, steps_ms["kernel"], Path(tmp))
        phase_cli(kernels, Path(tmp), smi)
    phase_parallel()
    phase_entry(kernels)
    phase_bench(kernels)
    phase_profile_stages()
    phase_micro(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        phase_accuracy(Path(tmp))
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY

    line = []
    for k, r in kernels.items():
        kern = REGISTRY[k]
        line.append({"name": k, "route": "cuda", "source": kern.source,
                     "replaces": kern.replaces,
                     "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "device_ms": r.get("device_ms")})
        for extra in ("tops", "bf16", "chain", "chain_sweep",
                      "library_device_ms", "launches_micro",
                      "device_ms_train_step", "device_ms_large",
                      "launches_data", "launches_train_large",
                      "device_ms_train_large", "launches_cli",
                      "launches_dryrun_real", "launches_bench",
                      "launches_api", "ms_api", "large_n", "published",
                      "launches_data_jpeg", "shapes"):
            if extra in r:
                line[-1][extra] = r[extra]
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
