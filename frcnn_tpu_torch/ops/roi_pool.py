"""Adaptive max pooling over ROI feature rects: the plain PyTorch version.

Port of the JAX package's ``ops/roi_pool.py`` and of the function its
Pallas kernel computes (``ops/pallas_roi_pool.py::_forward``). Bin ``b`` of
a rect of extent ``h`` covers ``[floor(b*h/k), ceil((b+1)*h/k))``, so bins
overlap when the rect is smaller than the grid.
"""

from __future__ import annotations

import torch


def prepare_roi_rects(feature_rects, fm_w, fm_h):
    """Clip integer-valued feature rects ``[..., 4]`` (x0, y0, x1, y1) to
    the true feature map and force at least one row and column
    (``objective.lua:5-13``). ``fm_w``/``fm_h`` broadcast against
    ``feature_rects[..., 0]``."""
    x0, y0, x1, y1 = feature_rects.unbind(-1)
    fw = torch.as_tensor(fm_w, dtype=feature_rects.dtype,
                         device=feature_rects.device)
    fh = torch.as_tensor(fm_h, dtype=feature_rects.dtype,
                         device=feature_rects.device)
    zero = torch.zeros((), dtype=feature_rects.dtype,
                       device=feature_rects.device)
    x0 = torch.clamp(x0, zero, fw)
    y0 = torch.clamp(y0, zero, fh)
    x1 = torch.clamp(x1, zero, fw)
    y1 = torch.clamp(y1, zero, fh)
    x0 = torch.clamp(torch.minimum(x0, x1 - 1), zero, fw - 1)
    y0 = torch.clamp(torch.minimum(y0, y1 - 1), zero, fh - 1)
    x1 = torch.maximum(x1, x0 + 1)
    y1 = torch.maximum(y1, y0 + 1)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def _bin_windows(start, end, k: int, size: int, window: int):
    """Per rect and bin: the ``window`` cell indices starting at the bin's
    first cell (clamped into the map) and the mask of those inside the
    bin. start/end [...] int64 -> ([..., k, window], [..., k, window])."""
    ext = (end - start)[..., None]
    b = torch.arange(k, device=start.device)
    lo = start[..., None] + torch.div(b * ext, k, rounding_mode="floor")
    hi = start[..., None] - torch.div(-(b + 1) * ext, k, rounding_mode="floor")
    t = torch.arange(window, device=start.device)
    idx = torch.clamp(lo[..., None] + t, 0, size - 1)
    return idx, t < (hi - lo)[..., None]


def adaptive_max_pool(fm, rects, valid, kh: int, kw: int):
    """Batched adaptive max pool.

    fm [B, H, W, C]; rects [B, D, 4] prepared feature rects (integer
    valued, any dtype; truncated to integers as the kernel does); valid
    [B, D] bool. Returns [B, D, kh, kw, C] in the dtype of ``fm``, zero
    where ``valid`` is False.

    Rows first, then columns, over gathered windows of the largest bin
    extent (``ceil(H/kh)+1`` rows, ``ceil(W/kw)+1`` columns) with the cells
    outside each bin masked to -inf: the maxima are those of the float32
    comparison, since widening bf16 to float32 is exact and monotone.
    """
    B, H, W, C = fm.shape
    D = rects.shape[1]
    r = rects.to(torch.int32).to(torch.int64)
    x0, y0, x1, y1 = r.unbind(-1)
    maxh = min(H, -(-H // kh) + 1)
    maxw = min(W, -(-W // kw) + 1)
    rows, rmask = _bin_windows(y0, y1, kh, H, maxh)   # [B, D, kh, maxh]
    cols, cmask = _bin_windows(x0, x1, kw, W, maxw)   # [B, D, kw, maxw]
    neg = torch.tensor(-torch.inf, dtype=fm.dtype, device=fm.device)
    d_idx = torch.arange(D, device=fm.device)[:, None, None]
    out = []
    for b in range(B):
        win = fm[b][rows[b]]                          # [D, kh, maxh, W, C]
        win = torch.where(rmask[b][..., None, None], win, neg)
        rowmax = win.amax(dim=2)                      # [D, kh, W, C]
        win = rowmax[d_idx, :, cols[b]]               # [D, kw, maxw, kh, C]
        win = torch.where(cmask[b][..., None, None], win, neg)
        out.append(win.amax(dim=2).transpose(1, 2))   # [D, kh, kw, C]
    pooled = torch.stack(out)
    return torch.where(valid[:, :, None, None, None], pooled,
                       torch.zeros((), dtype=fm.dtype, device=fm.device))
