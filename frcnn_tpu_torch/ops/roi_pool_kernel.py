"""Batched adaptive max ROI pooling on hand-written CUDA kernels: the
forward ``csrc/roi_pool.cu`` and its gradient ``csrc/roi_pool_bwd.cu``.

Port of ``frcnn_tpu/ops/pallas_roi_pool.py::pallas_adaptive_max_pool_valid``
and its custom VJP. On CPU tensors the wrappers run the plain versions
(``ops/roi_pool.py::adaptive_max_pool`` and ``adaptive_max_pool_backward``);
on CUDA tensors they launch the kernels or raise.
:func:`adaptive_max_pool_valid_grad` is the differentiable form that
training uses.
"""

from __future__ import annotations

import ctypes

import torch

from frcnn_tpu_torch.ops import roi_pool as plain
from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    name="roi_pool",
    entry="roi_pool_kernel",
    symbols={torch.float32: "frcnn_roi_pool_f32",
             torch.bfloat16: "frcnn_roi_pool_bf16"},
    # fm, rects, valid, out; B, D, H, W, C, kh, kw, route
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 8,
    source="frcnn_tpu_torch/csrc/roi_pool.cu",
    replaces="frcnn_tpu/ops/pallas_roi_pool.py:36 (_kernel of _forward, "
             "pallas_call at :186)",
)

BWD_KERNEL = CudaKernel(
    name="roi_pool_bwd",
    entry="roi_pool_bwd_kernel",
    symbols={torch.float32: "frcnn_roi_pool_bwd_f32",
             torch.bfloat16: "frcnn_roi_pool_bwd_bf16"},
    # fm, rects, valid, g, tie masks, dfm; B, D, H, W, C, kh, kw, route,
    # words
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 9,
    source="frcnn_tpu_torch/csrc/roi_pool_bwd.cu",
    replaces="frcnn_tpu/ops/pallas_roi_pool.py:194 (_bwd_kernel of "
             "_backward, pallas_call at :344)",
)


# routes of the C launchers: the vector instances that the published shapes
# run, or the any-shape kernels
VECTOR, ANY = 0, 1
SMEM_OPTIN = 232448          # bytes of shared memory a block may opt in to
BWD_ROI_BYTES = 48           # roi_pool_bwd.cu's RoiRow
BWD_STATIC_SMEM = 1024       # what the launchers keep for static arrays


def _check_bins(C: int, kh: int, kw: int) -> None:
    if C < 1 or kh < 1 or kw < 1:
        raise ValueError(f"roi_pool: needs C, kh, kw >= 1; got C={C}, "
                         f"kh={kh}, kw={kw}")


def forward_plan(C: int, kh: int, kw: int, dtype) -> int:
    """The forward kernel's route for C channels of ``dtype`` pooled to kh
    x kw bins: :data:`VECTOR` (16 bytes of channels per access, at most 8
    column bins a thread: C a multiple of 8 in bfloat16 or 4 in float32,
    kw at most 8) or :data:`ANY` (any C, kh and kw, as the Pallas kernel's
    full-C block takes). Raises only for an empty grid or map."""
    _check_bins(C, kh, kw)
    vec = 16 // dtype.itemsize
    return VECTOR if C % vec == 0 and kw <= 8 else ANY


def tie_mask_rows(H: int, kh: int) -> int:
    """Most rows in a row bin of a prepared rect, ``min(H, ceil(H/kh) +
    1)``: the bits a (roi, row bin, column bin, channel) row-tie mask of
    the backward kernel needs (one per row)."""
    return min(H, -(-H // kh) + 1)


def tie_mask_words(H: int, kh: int) -> int:
    """32-bit words per row-tie mask: ``ceil(tie_mask_rows / 32)``."""
    return -(-tie_mask_rows(H, kh) // 32)


def backward_plan(D: int, H: int, W: int, C: int, kh: int, kw: int):
    """(route, words) of the backward kernels for D rois over an H x W x C
    map pooled to kh x kw bins. :data:`VECTOR`, with one-word masks, where
    C is a multiple of 16, kh and kw at most 8, W under 32768, row bins of
    at most 32 rows and D rois' 48-byte records fit the shared memory;
    else :data:`ANY`, with ``tie_mask_words(H, kh)`` words per mask.
    Raises only for an empty grid or map, or where the any-shape kernel
    could not stage 32 rois' bin edges (3 + kh + 2 kw int32s each) in the
    shared memory, a grid some thousands of bins wide."""
    _check_bins(C, kh, kw)
    if H < 1 or W < 1:
        raise ValueError(f"roi_pool_bwd: needs H, W >= 1; got {H}x{W}")
    if (C % 16 == 0 and max(kh, kw) <= 8 and W < 32768
            and tie_mask_rows(H, kh) <= 32
            and D * BWD_ROI_BYTES <= SMEM_OPTIN - BWD_STATIC_SMEM):
        return VECTOR, 1
    if 32 * 4 * (3 + kh + 2 * kw) > SMEM_OPTIN - BWD_STATIC_SMEM:
        raise ValueError(f"roi_pool_bwd kernel: the bin edges of a {kh}x{kw} "
                         f"grid do not fit its shared memory")
    return ANY, tie_mask_words(H, kh)


def adaptive_max_pool_valid(fm, rects, valid, kh: int, kw: int):
    """fm [B, H, W, C] (float32 or bfloat16), rects [B, D, 4] prepared
    feature rects (integer valued, truncated to int32), valid [B, D] bool.
    Returns [B, D, kh, kw, C] in the dtype of ``fm``; rows with
    ``valid == False`` are zero. Any C, kh and kw (:func:`forward_plan`
    picks the kernel)."""
    if fm.device.type == "cpu":
        return plain.adaptive_max_pool(fm, rects, valid, kh, kw)
    B, H, W, C = fm.shape
    D = rects.shape[1]
    route = forward_plan(C, kh, kw, fm.dtype)
    rects_i = rects.to(torch.int32).contiguous()
    if route == VECTOR:
        fm = _aligned16(fm)
    check_cuda("fm", fm, fm.dtype, (B, H, W, C))
    check_cuda("rects", rects_i, torch.int32, (B, D, 4))
    check_cuda("valid", valid, torch.bool, (B, D))
    out = torch.empty((B, D, kh, kw, C), dtype=fm.dtype, device=fm.device)
    KERNEL.launch(fm.dtype, ptr(fm), ptr(rects_i), ptr(valid), ptr(out),
                  B, D, H, W, C, kh, kw, route)
    return out


def _aligned16(t):
    """``t``, or a copy of it when its data is not 16-byte aligned (the
    vector kernels move 16 bytes of channels per access)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def adaptive_max_pool_valid_backward(fm, rects, valid, g, kh: int, kw: int):
    """dfm [B, H, W, C] in the dtype of ``fm`` for the cotangent ``g``
    [B, D, kh, kw, C] of :func:`adaptive_max_pool_valid` (cast to the dtype
    of ``fm`` first); invalid rois contribute nothing. Any shape
    (:func:`backward_plan` picks the kernels and sizes the tie masks)."""
    if fm.device.type == "cpu":
        return plain.adaptive_max_pool_backward(fm, rects, valid, g, kh, kw)
    B, H, W, C = fm.shape
    D = rects.shape[1]
    route, words = backward_plan(D, H, W, C, kh, kw)
    rects_i = rects.to(torch.int32).contiguous()
    gq = g.to(fm.dtype).contiguous()
    if route == VECTOR:
        fm, gq = _aligned16(fm), _aligned16(gq)
    check_cuda("fm", fm, fm.dtype, (B, H, W, C))
    check_cuda("rects", rects_i, torch.int32, (B, D, 4))
    check_cuda("valid", valid, torch.bool, (B, D))
    check_cuda("g", gq, fm.dtype, (B, D, kh, kw, C))
    ties = torch.empty((B, D, kh, kw, words * C), dtype=torch.int32,
                       device=fm.device)
    dfm = torch.empty_like(fm)
    BWD_KERNEL.launch(fm.dtype, ptr(fm), ptr(rects_i), ptr(valid), ptr(gq),
                      ptr(ties), ptr(dfm), B, D, H, W, C, kh, kw, route,
                      words)
    return dfm


def adaptive_max_pool_valid_grad(fm, rects, valid, kh: int, kw: int):
    """:func:`adaptive_max_pool_valid`, differentiable in ``fm`` through
    :func:`adaptive_max_pool_valid_backward`. Exact for training only where
    the losses mask invalid rois out (their cotangent is then zero), as
    for the JAX wrapper."""
    return plain.adaptive_max_pool_grad(fm, rects, valid, kh, kw,
                                        adaptive_max_pool_valid,
                                        adaptive_max_pool_valid_backward)
