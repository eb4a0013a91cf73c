"""Dense multi-scale anchor field.

Port of the JAX package's ``geometry/anchors.py::AnchorGenerator``. The
tables are host-side numpy, computed once per bucket; the canonical flat
order is (tap, aspect, y, x). An anchor map's channels ``[6j, 6j+6)`` hold
``(cls_fg, cls_bg, x, y, w, h)`` of aspect ``j``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.geometry.localizer import (
    Localizer,
    layer_infos_for_feature_map,
    layer_infos_for_tap,
)

BIN_SIZE = 16  # nearby-anchor center hash granularity (``Anchors.lua:5``)


def aspect_dims(scale: float) -> List[Tuple[float, float]]:
    """(w, h) of the 3 equal-area aspects of ``scale`` (``Anchors.lua:32-35``)."""
    a = scale / math.sqrt(2)
    return [(float(scale), float(scale)), (2 * a, a), (a, 2 * a)]


class AnchorGenerator:
    """Static anchor field for one padded image bucket.

    Attributes (numpy): ``boxes`` [A, 4] float32, ``tap``/``aspect``/``fy``/
    ``fx``/``bin_x``/``bin_y`` [A] int32, ``tap_dims`` the (H, W) of each
    anchor map for the padded bucket.
    """

    def __init__(self, cfg: Config, image_hw: Tuple[int, int] = None):
        """``image_hw`` overrides the bucket (default: the config's primary
        bucket), as for the portrait bucket's anchor field."""
        self.cfg = cfg
        model = cfg.model
        self.scales = cfg.scales
        H, W = image_hw if image_hw is not None else cfg.shapes.image_hw
        self.image_hw = (int(H), int(W))
        self.tap_localizers = [
            Localizer(layer_infos_for_tap(model, i))
            for i in range(len(cfg.scales))
        ]
        self.fm_localizer = Localizer(layer_infos_for_feature_map(model))
        self.fm_hw = tuple(reversed(self.fm_localizer.feature_map_size(W, H)))

        self.tap_dims: List[Tuple[int, int]] = []
        boxes, taps, aspects, fys, fxs = [], [], [], [], []
        for i, loc in enumerate(self.tap_localizers):
            w_cells, h_cells = loc.feature_map_size(W, H)
            self.tap_dims.append((h_cells, w_cells))
            cx = self._centers(loc, w_cells, axis="x")
            cy = self._centers(loc, h_cells, axis="y")
            for j, (bw, bh) in enumerate(aspect_dims(self.scales[i])):
                gx, gy = np.meshgrid(cx, cy)
                b = np.stack([gx - bw / 2, gy - bh / 2, gx + bw / 2,
                              gy + bh / 2], axis=-1)
                boxes.append(b.reshape(-1, 4))
                taps.append(np.full(h_cells * w_cells, i, np.int32))
                aspects.append(np.full(h_cells * w_cells, j, np.int32))
                yy, xx = np.meshgrid(np.arange(h_cells, dtype=np.int32),
                                     np.arange(w_cells, dtype=np.int32),
                                     indexing="ij")
                fys.append(yy.reshape(-1))
                fxs.append(xx.reshape(-1))

        self.boxes = np.concatenate(boxes).astype(np.float32)
        self.tap = np.concatenate(taps)
        self.aspect = np.concatenate(aspects)
        self.fy = np.concatenate(fys)
        self.fx = np.concatenate(fxs)
        centers = (self.boxes[:, :2] + self.boxes[:, 2:]) * 0.5
        self.bin_x = np.floor(centers[:, 0] / BIN_SIZE).astype(np.int32)
        self.bin_y = np.floor(centers[:, 1] / BIN_SIZE).astype(np.int32)
        self.num_anchors = self.boxes.shape[0]

    @staticmethod
    def _centers(loc: Localizer, n_cells: int, axis: str) -> np.ndarray:
        """Input-space center of each one-cell feature rect ``[c, c+1)``
        (the localizer is affine: center(c) = S*c + C0)."""
        if axis == "x":
            s, bmin, bmax = loc.scale_x, loc.offset_min_x, loc.offset_max_x
        else:
            s, bmin, bmax = loc.scale_y, loc.offset_min_y, loc.offset_max_y
        c0 = (s + bmin + bmax) / 2.0
        return s * np.arange(n_cells, dtype=np.float64) + c0

    def lookup_tables(self, extent: int = 200):
        """The reference's ``self.w`` / ``self.h`` tables (``Anchors.lua:15-19,
        38-57``), numpy [num_scales, 3, extent, 2] each: entry [i, j, c] is
        the (min, max) extent of the anchor at 1-based feature coordinate
        c+1."""
        ns = len(self.scales)
        w = np.zeros((ns, 3, extent, 2))
        h = np.zeros((ns, 3, extent, 2))
        for i, loc in enumerate(self.tap_localizers):
            cx = self._centers(loc, extent, "x")
            cy = self._centers(loc, extent, "y")
            for j, (bw, bh) in enumerate(aspect_dims(self.scales[i])):
                w[i, j, :, 0] = cx - bw / 2
                w[i, j, :, 1] = cx + bw / 2
                h[i, j, :, 0] = cy - bh / 2
                h[i, j, :, 1] = cy + bh / 2
        return w, h

    def get(self, tap: int, aspect: int, y: int, x: int) -> np.ndarray:
        """One anchor box (numpy [4]) by (tap, aspect, feature y, feature
        x), all 0-based: ``Anchors:get`` (``Anchors.lua:60-67``) is the
        1-based form."""
        cx = self._centers(self.tap_localizers[tap], x + 1, "x")[x]
        cy = self._centers(self.tap_localizers[tap], y + 1, "y")[y]
        bw, bh = aspect_dims(self.scales[tap])[aspect]
        return np.array([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2])

    def flatten_tap_outputs(self, tap_outputs: Sequence[torch.Tensor]
                            ) -> torch.Tensor:
        """Anchor maps of one image (NHWC ``[H, W, 18]`` each) -> the
        canonical flat ``[A, 6]``: per tap ``[H, W, 3, 6] -> [3, H, W, 6]``,
        so that aspect is outermost within the tap."""
        return torch.cat([
            out.reshape(h, w, 3, 6).permute(2, 0, 1, 3).reshape(-1, 6)
            for out, (h, w) in zip(tap_outputs, self.tap_dims)])

    def unflatten_to_tap_deltas(self, flat: torch.Tensor
                                ) -> List[torch.Tensor]:
        """Inverse of :meth:`flatten_tap_outputs`: ``[A, 6]`` -> one
        ``[H, W, 18]`` map per tap."""
        outs = []
        for (s, e), (h, w) in zip(self.flat_slices(), self.tap_dims):
            x = flat[s:e].reshape(3, h, w, 6)
            outs.append(x.permute(1, 2, 0, 3).reshape(h, w, 18))
        return outs

    def flat_slices(self) -> List[Tuple[int, int]]:
        """[start, end) of each tap's anchors in the flat order."""
        out, start = [], 0
        for (h, w) in self.tap_dims:
            out.append((start, start + 3 * h * w))
            start += 3 * h * w
        return out

    def detect_order(self) -> np.ndarray:
        """``perm[native_idx] = canonical_idx`` for the anchor maps' native
        flat order (per tap: y, x, aspect, i.e. NHWC ``[H, W, 18]``
        reshaped to ``[-1, 6]``)."""
        parts, off = [], 0
        for (h, w) in self.tap_dims:
            n = h * w
            yy, xx, jj = np.meshgrid(np.arange(h), np.arange(w),
                                     np.arange(3), indexing="ij")
            parts.append((off + jj * n + yy * w + xx).reshape(-1))
            off += 3 * n
        return np.concatenate(parts).astype(np.int32)

    def fm_valid_mask(self, true_h, true_w, fy=None, fx=None):
        """Anchors whose cell exists in the true-size anchor map (the
        vectorized ``cleanAnchors``, ``objective.lua:32-43``).

        ``true_h``/``true_w``: [B] tensors (or scalars). ``fy``/``fx``:
        per-anchor cell tables (default: canonical order; a permutation
        within tap blocks, such as :meth:`detect_order`, is fine). Returns
        [B, A] bool (or [A] for scalar sizes) on the device of ``true_h``.
        """
        th = torch.as_tensor(true_h)
        tw = torch.as_tensor(true_w, device=th.device)
        fy = torch.as_tensor(self.fy if fy is None else fy, device=th.device)
        fx = torch.as_tensor(self.fx if fx is None else fx, device=th.device)
        parts = []
        for (s, e), loc in zip(self.flat_slices(), self.tap_localizers):
            w_t, h_t = loc.feature_map_size_t(tw, th)
            parts.append((fy[s:e] < h_t[..., None]) & (fx[s:e] < w_t[..., None]))
        return torch.cat(parts, dim=-1)

    def inside_image_mask(self, true_h, true_w, boxes=None):
        """Anchors fully inside the true image rect, max edge closed (the
        clip rect of ``findRangesXY``, ``Anchors.lua:105-110``).

        ``true_h``/``true_w``: [B] tensors (or scalars); ``boxes``: the
        anchor boxes as a tensor (default: :attr:`boxes` on the device of
        ``true_h``). Returns [B, A] bool (or [A])."""
        th = torch.as_tensor(true_h)
        tw = torch.as_tensor(true_w, device=th.device)
        b = torch.as_tensor(self.boxes if boxes is None else boxes,
                            device=th.device)
        return ((b[:, 0] >= 0) & (b[:, 1] >= 0)
                & (b[:, 2] <= tw[..., None]) & (b[:, 3] <= th[..., None]))
