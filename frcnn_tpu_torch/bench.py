"""Detection throughput benchmark of the port (the counterpart of
``bench.py``).

    python -m frcnn_tpu_torch.bench [batch] [iters] [mode] [--device cuda|cpu]

Times the batched end-to-end detect program (normalize, pnet, dense
decode, proposal NMS, ROI pool, cnet, per-class NMS) of a mode string at
``batch`` images (default 32) and prints ONE JSON line per mode:

  {"metric": ..., "value": images/s, "unit": "images/sec/chip",
   "device": "<nvidia-smi name, power limit>",
   "kernels": {kernel: launches per timed call}}

Modes are ``bench.py``'s: ``bf16`` | ``int8`` (int8 pnet, dynamic scales)
| ``int8s`` (static scales calibrated on the normalized batch) |
``pallas`` (the kernels) | ``s2d`` (host-packed space-to-depth planes and
the fused block0 kernel; the 2-conv kernel under vgg_large) | ``large``
(vgg_large) | ``imagenet`` (vgg_large at the 480x1000 imagenet envelope) |
``s8p`` (quantize in the int8 chain's conv epilogue, pool on int8) |
``b0bf16`` (the 2-conv kernel's conv1 in bf16 under int8s) | ``b0roll``
and ``+`` combinations; ``best`` is the head of the JAX bench's chain,
``int8s+pallas+s2d+s8p``, and nothing else: the port does not fall back
down that chain. ``bf16``, ``int8`` and ``int8s`` alone turn no kernel
on: they time the plain PyTorch versions, as the JAX bench times XLA
there, and their records' ``kernels`` say so.

The weights are the seeded initialisation (``models/factory.py::
init_models``, seed 0) with the JAX bench's stress biases: every anchor
head's output bias is 6.0 on the three fg logits, so that every cell
passes the 0.95 gate and the proposal NMS sees its full K rows per image,
a heavier proposal load than any real scene.

Timing: the JAX bench runs N iterations inside one XLA program; here the
program is called N times on the same device tensors with one
``torch.cuda.synchronize()`` after the loop, best of 3 trials at
``1 + iters // 4`` and at ``1 + iters`` calls, and the two are
subtracted, as the JAX bench does, to cancel the fixed cost. Not carried
over from ``bench.py``: ``vs_baseline`` and ``best_recorded_before_
outage`` (a TPU north star and a scan of TPU logs), the subprocess health
check (here: a CUDA device must exist) and the retries.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from frcnn_tpu_torch.cli import require_device
from frcnn_tpu_torch.utils.metrics import sync

BEST = "int8s+pallas+s2d+s8p"
UNIT = "images/sec/chip"


def metric_name(m: str) -> str:
    """The metric label a mode string is recorded under (``bench.py:104``,
    string for string)."""
    suffix = "" if m == "bf16" else f" [{m}]"
    if "imagenet" in m:
        return ("batched detect images/sec/chip @1000x480 "
                f"(vgg_large/imagenet){suffix}")
    model = "vgg_large" if "large" in m else "vgg_small"
    return (f"batched detect images/sec/chip @800x450 "
            f"({model}/duplo){suffix}")


def bench_config(mode: str):
    """The Config a mode string measures: ``bench.py:115``'s, field for
    field. Its ``pallas_mode="on"`` runs the kernels on CUDA tensors and
    their plain versions on CPU tensors (``--device cpu``), where the JAX
    bench reads ``FRCNN_BENCH_INTERPRET``. ``b0roll`` sets
    ``s2d_block0_layout="roll"``, a TPU scratch layout that the port does
    not read: it times the same program as the default layout."""
    import dataclasses

    from frcnn_tpu_torch.config import (
        duplo_config,
        imagenet_config,
        vgg_large_model,
    )

    if "imagenet" in mode:
        cfg = imagenet_config()
        cfg = cfg.replace(shapes=dataclasses.replace(cfg.shapes,
                                                     image_hw=(480, 1000)))
    else:
        cfg = duplo_config()
        cfg = cfg.replace(shapes=dataclasses.replace(cfg.shapes,
                                                     image_hw=(450, 800)))
    if "large" in mode:
        cfg = cfg.replace(model=vgg_large_model())
    if "pallas" in mode or "s2d" in mode:
        cfg = cfg.replace(pallas_mode="on")
    if "s2d" in mode:
        cfg = cfg.replace(input_layout="s2d")
    if "b0bf16" in mode:
        cfg = cfg.replace(s2d_block0_int8=False)
    if "b0roll" in mode:
        cfg = cfg.replace(s2d_block0_layout="roll")
    return cfg


@torch.no_grad()
def stress_weights(pnet) -> None:
    """``bench.py:179-187``: every anchor head's output bias is 6.0 at the
    fg logit of each aspect (indices 0, 6, 12) and 0 elsewhere, in
    place."""
    for ai in range(len(pnet.model_cfg.anchor_nets)):
        b = getattr(pnet, f"anchor{ai}_out").bias
        b.zero_()
        b[0::6] = 6.0


def bench_program(cfg, mode: str, batch_size: int, device, seed: int = 0,
                  models=None):
    """The program that :func:`run_bench` times and its device-resident
    inputs: ``(fn, (images, true_hw))``, ``fn(images, true_hw) ->
    DetectionResult``.

    ``models``: (pnet, cnet) float32 modules with their weights, else the
    seeded initialisation of ``seed``; either way a copy gets the stress
    biases (:func:`stress_weights`). The batch is ``bench.py``'s:
    ``normal(0.3, 0.2)`` images from ``numpy.random.default_rng(seed)``
    at the bucket's full size. ``s2d``: the planes are packed on the host
    before the transfer, outside the timed region. ``int8*``: the pnet is
    the ``QuantizedPNet`` of the float weights (``pool_s8`` under
    ``s8p``); ``int8s`` calibrates its static scales on the normalized
    batch through ``calibrate_quantized_pnet`` (under ``s2d`` through the
    serving producer of block 0, as the serving ``Detector`` does)."""
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.models.factory import init_models
    from frcnn_tpu_torch.ops.block0_kernel import pack_s2d_np
    from frcnn_tpu_torch.ops.normalization import normalize_image

    device = torch.device(device)
    if models is None:
        models = init_models(cfg, torch.Generator().manual_seed(seed))
    pnet, cnet = (copy.deepcopy(m) for m in models)
    stress_weights(pnet)

    H, W = cfg.shapes.image_hw
    rng = np.random.default_rng(seed)
    raw = rng.normal(0.3, 0.2, size=(batch_size, H, W, 3)).astype(np.float32)
    true_hw = torch.tensor([[H, W]] * batch_size, dtype=torch.int32,
                           device=device)
    quant = {}
    if "int8" in mode:
        cfg = cfg.replace(quant_pool_s8="s8p" in mode)
        quant["quantized"] = True
        if "int8s" in mode:
            n = cfg.normalization
            quant["quant_calibration"] = normalize_image(
                torch.from_numpy(raw).to(device), true_hw[:, 0],
                true_hw[:, 1], method=n.method, width=n.width,
                centering=n.centering, scaling=n.scaling)
    det = Detector(cfg, pnet, cnet, device=device, **quant)
    if cfg.input_layout == "s2d":
        images = tuple(torch.from_numpy(p).to(device)
                       for p in pack_s2d_np(raw))
    else:
        images = torch.from_numpy(raw).to(device)
    return det._program_for((H, W)), (images, true_hw)


def launches_per_call(fn, args, device) -> dict:
    """{kernel: launches} of one call of ``fn(*args)`` (every registered
    kernel's count set to 0 before it), the kernels it launched only."""
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY

    for k in REGISTRY.values():
        k.launches = 0
    fn(*args)
    sync(device)
    return {n: k.launches for n, k in REGISTRY.items() if k.launches}


def run_bench(batch_size: int, iters: int, mode: str, device="cuda",
              seed: int = 0):
    """(images/s, {kernel: launches per call}) of one mode's program."""
    cfg = bench_config(mode)
    fn, args = bench_program(cfg, mode, batch_size, device, seed)
    t0 = time.perf_counter()
    fn(*args)                     # kernel build, first-call allocations
    sync(device)
    print(f"# [{mode}] build+first-run: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    kernels = launches_per_call(fn, args, device)

    # eager PyTorch hoists nothing out of a loop, so the JAX bench's
    # per-iteration input perturbation has no work to do here
    def timed(k, trials=3):
        best = float("inf")
        for _ in range(trials):
            t = time.perf_counter()
            for _ in range(k):
                fn(*args)
            sync(device)
            best = min(best, time.perf_counter() - t)
        return best

    n_small, n_big = 1 + iters // 4, 1 + iters
    dt = timed(n_big) - timed(n_small)
    if dt <= 0:
        raise RuntimeError(f"{n_big} calls took no longer than {n_small}: "
                           f"raise iters")
    return batch_size * (n_big - n_small) / dt, kernels


def device_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s line of the card
    (``cpu`` for the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def record(metric: str, value: float, device, kernels=None,
           error: str = "") -> dict:
    rec = {"metric": metric, "value": round(value, 2), "unit": UNIT}
    if error:
        rec["error"] = error[-500:]
    else:
        rec["device"] = device_line(device)
        rec["kernels"] = kernels
    return rec


def measure(batch_size: int, iters: int, mode: str, device="cuda") -> dict:
    """One mode's JSON record (:func:`run_bench`)."""
    value, kernels = run_bench(batch_size, iters, mode, device)
    return record(metric_name(mode), value, device, kernels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("mode", nargs="?", default="best")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mode = BEST if args.mode == "best" else args.mode
    try:
        require_device(args.device)
    except SystemExit as e:
        print(json.dumps(record(metric_name(mode), 0.0, args.device,
                                error=str(e))), flush=True)
        raise
    try:
        rec = measure(args.batch, args.iters, mode, args.device)
    except Exception as e:  # noqa: BLE001 - one parseable record, then fail
        print(json.dumps(record(metric_name(mode), 0.0, args.device,
                                error=f"{type(e).__name__}: {e}")),
              flush=True)
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
