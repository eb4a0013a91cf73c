"""Adaptive max pooling over ROI feature rects: the plain PyTorch versions
of the forward and of its gradient.

Port of the JAX package's ``ops/roi_pool.py`` and of the functions its
Pallas kernels compute (``ops/pallas_roi_pool.py::_forward`` and
``_backward``). Bin ``b`` of a rect of extent ``h`` covers
``[floor(b*h/k), ceil((b+1)*h/k))``, so bins overlap when the rect is
smaller than the grid.
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


def roi_pool_feature_rects(localizer, input_rects, fm_w, fm_h):
    """Input-space rects -> prepared integer feature rects: the whole
    coordinate path of ``extract_roi_pooling_input`` (``objective.lua:5-13``),
    ``localizer.input_to_feature_rect_t`` then :func:`prepare_roi_rects`."""
    return prepare_roi_rects(localizer.input_to_feature_rect_t(input_rects),
                             fm_w, fm_h)


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


def adaptive_max_pool_backward(fm, rects, valid, g, kh: int, kw: int):
    """Gradient of :func:`adaptive_max_pool` with respect to ``fm``.

    fm [B, H, W, C]; rects [B, D, 4] prepared feature rects; valid [B, D]
    bool (invalid rois contribute nothing); g [B, D, kh, kw, C], cast to the
    dtype of ``fm`` first as the JAX wrapper does. Returns dfm [B, H, W, C]
    in the dtype of ``fm``, accumulated in float32 and cast once.

    The VJP of the JAX formulation, which reduces COLUMNS first, then rows
    (``frcnn_tpu/ops/roi_pool.py::adaptive_max_pool``): per roi, recompute
    each column bin's max over every row (``colmax [H, kw, C]``); the row
    stage splits ``g`` evenly among the rows that tie for a row bin's max of
    ``colmax`` and sums it per (row, column bin) into ``dcol`` across
    overlapping row bins; the column stage splits ``dcol`` evenly among the
    columns of the bin where ``fm`` equals ``colmax``. (The forward here
    reduces rows first; autodiff through it would split ties otherwise.)
    Sums run in the order of the Pallas kernel (rois, then row bins into
    ``dcol``; rois, then column bins into ``dfm``), so in float32 the
    result is that kernel's to the bit.
    """
    B, H, W, C = fm.shape
    D = rects.shape[1]
    f = fm.float()
    gq = g.to(fm.dtype).float()
    r = rects.to(torch.int32).to(torch.int64)
    x0, y0, x1, y1 = r.unbind(-1)
    maxh = min(H, -(-H // kh) + 1)
    maxw = min(W, -(-W // kw) + 1)
    rows, rmask = _bin_windows(y0, y1, kh, H, maxh)   # [B, D, kh, maxh]
    cols, cmask = _bin_windows(x0, x1, kw, W, maxw)   # [B, D, kw, maxw]
    neg = torch.tensor(-torch.inf, device=fm.device)
    zero = torch.zeros((), device=fm.device)
    bi = torch.arange(B, device=fm.device)
    dfm = torch.zeros((B, H, W, C), dtype=torch.float32, device=fm.device)
    dfm_t = dfm.permute(0, 2, 1, 3)                   # [B, W, H, C] view
    for d in range(D):
        # column stage forward over every row: colmax [B, kw, H, C]
        win = f[bi[:, None, None], :, cols[:, d]]     # [B, kw, maxw, H, C]
        win = torch.where(cmask[:, d][..., None, None], win, neg)
        colmax = win.amax(dim=2)
        eq_c = win == colmax[:, :, None]
        cnt_c = eq_c.sum(dim=2).clamp(min=1)          # [B, kw, H, C]
        # row stage: split g among the tied rows of each row bin
        rwin = colmax.permute(0, 2, 1, 3)[bi[:, None, None], rows[:, d]]
        rwin = torch.where(rmask[:, d][..., None, None], rwin, neg)
        eq_r = rwin == rwin.amax(dim=2, keepdim=True)  # [B, kh, maxh, kw, C]
        share = gq[:, d] / eq_r.sum(dim=2).clamp(min=1)
        share = torch.where(valid[:, d][:, None, None, None], share, zero)
        dcol = torch.zeros((B, H, kw, C), dtype=torch.float32,
                           device=fm.device)
        for rb in range(kh):
            dcol.index_put_((bi[:, None], rows[:, d, rb]),
                            eq_r[:, rb] * share[:, rb, None], accumulate=True)
        # column stage: split dcol among the tied columns of each bin
        for cb in range(kw):
            part = dcol[:, :, cb] / cnt_c[:, cb]      # [B, H, C]
            dfm_t.index_put_((bi[:, None], cols[:, d, cb]),
                             eq_c[:, cb] * part[:, None], accumulate=True)
    return dfm.to(fm.dtype)


class _RoiPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fm, rects, valid, kh, kw, forward, backward):
        ctx.save_for_backward(fm, rects, valid)
        ctx.args = (kh, kw, backward)
        return forward(fm, rects, valid, kh, kw)

    @staticmethod
    def backward(ctx, g):
        fm, rects, valid = ctx.saved_tensors
        kh, kw, backward = ctx.args
        return (backward(fm, rects, valid, g, kh, kw),
                None, None, None, None, None, None)


def adaptive_max_pool_grad(fm, rects, valid, kh: int, kw: int,
                           forward=adaptive_max_pool,
                           backward=adaptive_max_pool_backward):
    """``forward(fm, rects, valid, kh, kw)``, differentiable in ``fm``
    through ``backward(fm, rects, valid, g, kh, kw)`` (default: the plain
    versions of this module)."""
    return _RoiPool.apply(fm, rects, valid, kh, kw, forward, backward)
