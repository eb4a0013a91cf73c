"""Box overlay drawing (the JAX package's ``utils/drawing.py``) —
``draw_rectangle`` (``utilities.lua:149-177``): 1-pixel box outlines drawn
into a float image, clipped at the borders — and PNG output through
``data/codec.py`` (the port has no JPEG encoder)."""

from __future__ import annotations

import numpy as np

from frcnn_tpu_torch.data import codec

RED = (1.0, 0.0, 0.0)
GREEN = (0.0, 1.0, 0.0)
BLUE = (0.0, 0.0, 1.0)
WHITE = (1.0, 1.0, 1.0)


def draw_rectangle(img: np.ndarray, rect, color=GREEN) -> np.ndarray:
    """Draw the outline of ``rect`` (minx, miny, maxx, maxy) in-place on
    ``img`` [H, W, 3] float. Returns img."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (int(round(v)) for v in rect)
    c = np.asarray(color, img.dtype)
    cx0, cx1 = max(x0, 0), min(x1, w)
    cy0, cy1 = max(y0, 0), min(y1, h)
    if cx1 > cx0:
        if 0 <= y0 < h:
            img[y0, cx0:cx1] = c
        if 0 <= y1 - 1 < h:
            img[y1 - 1, cx0:cx1] = c
    if cy1 > cy0:
        if 0 <= x0 < w:
            img[cy0:cy1, x0] = c
        if 0 <= x1 - 1 < w:
            img[cy0:cy1, x1 - 1] = c
    return img


def save_image(img: np.ndarray, path: str):
    """Save a float [0,1]-ish RGB image as PNG. Any other extension raises
    ``ValueError``: the port writes PNG only."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"save_image writes PNG only, not {path!r}")
    arr = np.clip(img, 0.0, 1.0)
    codec.write_png(path, (arr * 255).astype(np.uint8))
