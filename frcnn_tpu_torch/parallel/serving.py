"""Data-parallel batched serving over several devices.

The JAX package runs one detect program with the image batch sharded over
a mesh (``frcnn_tpu/parallel/serving.py``); detection needs no
communication between images. Here each device holds its own
:class:`Detector` replica, the batch is split into equal parts, each part
is detected on its device and the results are concatenated.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.detect.detector import DetectionResult, Detector


class ShardedDetector:
    """One :class:`Detector` per device of ``devices`` (CUDA unless the
    caller names other devices), built from the same float32 ``pnet`` and
    ``cnet`` with the same options.

    ``detect(images, true_hw)``: ``images`` [B, H, W, 3] (or a packed
    (lum4, chroma) pair) with B divisible by the number of devices, else
    ``ValueError``. Part ``i`` of the batch runs on device ``i``; the
    results are concatenated on the first device, in batch order.
    """

    def __init__(self, cfg: Config, pnet, cnet,
                 devices: Sequence = ("cuda",), quantized: bool = False,
                 quant_calibration=None):
        if not devices:
            raise ValueError("ShardedDetector needs at least one device")
        self.cfg = cfg
        self.replicas = [Detector(cfg, pnet, cnet, device=d,
                                  quantized=quantized,
                                  quant_calibration=quant_calibration)
                         for d in devices]

    def detect(self, images, true_hw) -> DetectionResult:
        n = len(self.replicas)
        packed = isinstance(images, (tuple, list))
        b = (images[0] if packed else images).shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not divide over {n} "
                             f"devices")
        k = b // n
        hw = np.asarray(true_hw) if not isinstance(true_hw, torch.Tensor) \
            else true_hw
        parts = []
        for i, det in enumerate(self.replicas):
            rows = slice(i * k, (i + 1) * k)
            part = (tuple(p[rows] for p in images) if packed
                    else images[rows])
            parts.append(det.detect(part, hw[rows]))
        dev = self.replicas[0].device
        return DetectionResult(*[torch.cat([getattr(p, f).to(dev)
                                            for p in parts])
                                 for f in DetectionResult._fields])
