"""Inverse of the uint8 wire format (the JAX package's
``ops/color.py::unwire_uint8``): uint8 RGB -> float [0, 1] -> the
configured color space, on numpy arrays or tensors."""

from __future__ import annotations

import numpy as np
import torch

# torch/image rgb2yuv coefficients
RGB2YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14713, -0.28886, 0.436],
        [0.615, -0.51499, -0.10001],
    ],
    dtype=np.float32,
)


def unwire_uint8(img, color_space: str):
    """uint8 RGB ``[..., 3]`` -> float32 in ``color_space`` ('rgb' or
    'yuv'); float inputs pass through unchanged."""
    if isinstance(img, torch.Tensor):
        if img.dtype != torch.uint8:
            return img
        x = img.to(torch.float32) / 255.0
        if color_space == "yuv":
            return x @ torch.from_numpy(RGB2YUV.T.copy()).to(img.device)
    else:
        if img.dtype != np.uint8:
            return img
        x = img.astype(np.float32) / np.float32(255.0)
        if color_space == "yuv":
            return x @ RGB2YUV.T
    if color_space not in ("rgb", "", None):
        raise ValueError(
            f"uint8 wire format supports rgb/yuv, not {color_space!r}")
    return x
