"""Color-space conversions (the JAX package's ``ops/color.py``), matching
torch/image semantics (``utilities.lua:205-218``: rgb2yuv / rgb2lab /
rgb2hsv on float RGB in [0, 1]): numpy functions for the host pipeline,
and the inverse of the uint8 wire format, on numpy arrays or tensors."""

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

YUV2RGB = np.linalg.inv(RGB2YUV).astype(np.float32)


def rgb2yuv(img: np.ndarray) -> np.ndarray:
    """img [H, W, 3] float -> YUV."""
    return img @ RGB2YUV.T


def yuv2rgb(img: np.ndarray) -> np.ndarray:
    return img @ YUV2RGB.T


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """Standard HSV with H in [0, 1] (torch convention)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.max(img, axis=-1)
    minc = np.min(img, axis=-1)
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-20), 0.0)
    dz = np.maximum(delta, 1e-20)
    h = np.where(
        maxc == r, (g - b) / dz % 6.0,
        np.where(maxc == g, (b - r) / dz + 2.0, (r - g) / dz + 4.0),
    )
    h = np.where(delta > 0, h / 6.0, 0.0)
    return np.stack([h, s, maxc], axis=-1).astype(img.dtype)


def _srgb_to_linear(c):
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


# sRGB (linear) -> XYZ, and the D65 white point
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float64,
)
_WHITE = np.array([0.950456, 1.0, 1.088754])


def rgb2lab(img: np.ndarray) -> np.ndarray:
    """CIE L*a*b* with the D65 white point (torch image.rgb2lab applies the
    sRGB linearization, then XYZ -> Lab)."""
    lin = _srgb_to_linear(np.clip(img, 0.0, 1.0))
    xyz = (lin @ _RGB2XYZ.T) / _WHITE
    eps = 0.008856
    f = np.where(xyz > eps, np.cbrt(xyz), 7.787 * xyz + 16.0 / 116.0)
    L = np.where(xyz[..., 1] > eps, 116.0 * f[..., 1] - 16.0,
                 903.3 * xyz[..., 1])
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1).astype(img.dtype)


def convert_color(img: np.ndarray, color_space: str) -> np.ndarray:
    """``load_image``'s color conversion (``utilities.lua:205-218``) of
    float RGB [H, W, 3]."""
    if color_space in ("rgb", None, ""):
        return img
    if color_space == "yuv":
        return rgb2yuv(img)
    if color_space == "lab":
        return rgb2lab(img)
    if color_space == "hsv":
        return rgb2hsv(img)
    raise ValueError(f"unknown color space: {color_space}")


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
