"""The port's counterpart of ``__graft_entry__.py``.

``entry()``  -> (detect_fn, example_args): the flagship forward step, the
                full batched detect program (normalize, pnet, dense decode,
                proposal NMS, ROI pool, cnet, per-class NMS) of vgg_small
                with the duplo config at the 450x800 bucket, on the card.
``dryrun_multichip(n)`` -> one data-parallel train step over ``n`` gloo
                processes on a tiny config, a sharded detect, then the
                budget-gated real-config stage (``parallel/dryrun.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from frcnn_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]

B = 2


def entry_config():
    """``duplo_config()`` with its bucket pinned to the 800x450 frames of
    the flagship workload (the duplo default is the 450x1000 envelope of
    arbitrary wide images)."""
    from frcnn_tpu_torch.config import duplo_config

    cfg = duplo_config()
    return cfg.replace(shapes=dataclasses.replace(cfg.shapes,
                                                  image_hw=(450, 800)))


def entry(device="cuda"):
    """``(detect_fn, (images, true_hw))``: ``build_detect_fn`` of
    :func:`entry_config` with the seeded weights
    (``models/factory.py::init_models``, a ``torch.Generator`` seeded 0),
    cast once to the compute dtype, and B=2 zero images with their
    ``true_hw``, all on ``device``. ``detect_fn(images, true_hw)`` returns
    a ``DetectionResult``. A CUDA device that is not there raises
    ``SystemExit`` (no fallback to the CPU)."""
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.detect.detector import build_detect_fn
    from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
    from frcnn_tpu_torch.models.factory import (
        compute_dtype,
        for_compute,
        init_models,
    )

    device = require_device(device)
    cfg = entry_config()
    pnet, cnet = init_models(cfg, torch.Generator().manual_seed(0))
    dt = compute_dtype(cfg)
    detect = build_detect_fn(cfg, AnchorGenerator(cfg),
                             for_compute(pnet, dt, device),
                             for_compute(cnet, dt, device), device)
    H, W = cfg.shapes.image_hw
    images = torch.zeros((B, H, W, 3), dtype=torch.float32, device=device)
    true_hw = torch.tensor([[H, W]] * B, dtype=torch.int32, device=device)
    return detect, (images, true_hw)
