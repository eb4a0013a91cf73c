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
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 7,
    source="frcnn_tpu_torch/csrc/roi_pool.cu",
    replaces="frcnn_tpu/ops/pallas_roi_pool.py:36 (_kernel of _forward, "
             "pallas_call at :186)",
)

BWD_KERNEL = CudaKernel(
    name="roi_pool_bwd",
    entry="roi_pool_bwd_kernel",
    symbols={torch.float32: "frcnn_roi_pool_bwd_f32",
             torch.bfloat16: "frcnn_roi_pool_bwd_bf16"},
    # fm, rects, valid, g, tie masks, dfm; B, D, H, W, C, kh, kw
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 7,
    source="frcnn_tpu_torch/csrc/roi_pool_bwd.cu",
    replaces="frcnn_tpu/ops/pallas_roi_pool.py:194 (_bwd_kernel of "
             "_backward, pallas_call at :344)",
)


def adaptive_max_pool_valid(fm, rects, valid, kh: int, kw: int):
    """fm [B, H, W, C] (float32 or bfloat16), rects [B, D, 4] prepared
    feature rects (integer valued, truncated to int32), valid [B, D] bool.
    Returns [B, D, kh, kw, C] in the dtype of ``fm``; rows with
    ``valid == False`` are zero. The kernel moves 16 bytes of channels per
    access, so it needs C to be a multiple of 8 (bfloat16) or 4 (float32),
    and holds at most 8 column bins: kh and kw at most 8."""
    if fm.device.type == "cpu":
        return plain.adaptive_max_pool(fm, rects, valid, kh, kw)
    B, H, W, C = fm.shape
    D = rects.shape[1]
    vec = 16 // fm.element_size()
    if C % vec or not (1 <= kh <= 8 and 1 <= kw <= 8):
        raise ValueError(f"roi_pool kernel: takes C a multiple of {vec} "
                         f"({fm.dtype}) and 1 <= kh, kw <= 8; got C={C}, "
                         f"kh={kh}, kw={kw}")
    rects_i = rects.to(torch.int32).contiguous()
    fm = _aligned16(fm)
    check_cuda("fm", fm, fm.dtype, (B, H, W, C))
    check_cuda("rects", rects_i, torch.int32, (B, D, 4))
    check_cuda("valid", valid, torch.bool, (B, D))
    out = torch.empty((B, D, kh, kw, C), dtype=fm.dtype, device=fm.device)
    KERNEL.launch(fm.dtype, ptr(fm), ptr(rects_i), ptr(valid), ptr(out),
                  B, D, H, W, C, kh, kw)
    return out


def tie_mask_rows(H: int, kh: int) -> int:
    """Most rows in a row bin of a prepared rect, ``min(H, ceil(H/kh) +
    1)``: the bits the backward kernel's 32-bit row-tie masks need (one
    per row). Raises above 32."""
    rows = min(H, -(-H // kh) + 1)
    if rows > 32:
        raise ValueError(f"roi_pool_bwd kernel: row bins of up to {rows} "
                         f"rows (H={H}, kh={kh}); the tie masks hold 32")
    return rows


def _aligned16(t):
    """``t``, or a copy of it when its data is not 16-byte aligned (the
    kernels move 16 bytes of channels per access)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def adaptive_max_pool_valid_backward(fm, rects, valid, g, kh: int, kw: int):
    """dfm [B, H, W, C] in the dtype of ``fm`` for the cotangent ``g``
    [B, D, kh, kw, C] of :func:`adaptive_max_pool_valid` (cast to the dtype
    of ``fm`` first); invalid rois contribute nothing. The kernel needs C
    to be a multiple of 16, kh and kw at most 8 and W under 32768."""
    if fm.device.type == "cpu":
        return plain.adaptive_max_pool_backward(fm, rects, valid, g, kh, kw)
    B, H, W, C = fm.shape
    D = rects.shape[1]
    if C % 16 or max(kh, kw) > 8 or W >= 32768:
        raise ValueError(f"roi_pool_bwd kernel: takes C a multiple of 16, "
                         f"kh and kw <= 8 and W < 32768; got C={C}, kh={kh}, "
                         f"kw={kw}, W={W}")
    tie_mask_rows(H, kh)
    rects_i = rects.to(torch.int32).contiguous()
    fm = _aligned16(fm)
    gq = _aligned16(g.to(fm.dtype).contiguous())
    check_cuda("fm", fm, fm.dtype, (B, H, W, C))
    check_cuda("rects", rects_i, torch.int32, (B, D, 4))
    check_cuda("valid", valid, torch.bool, (B, D))
    check_cuda("g", gq, fm.dtype, (B, D, kh, kw, C))
    ties = torch.empty((B, D, kh, kw, C), dtype=torch.int32,
                       device=fm.device)
    dfm = torch.empty_like(fm)
    BWD_KERNEL.launch(fm.dtype, ptr(fm), ptr(rects_i), ptr(valid), ptr(gq),
                      ptr(ties), ptr(dfm), B, D, H, W, C, kh, kw)
    return dfm


def adaptive_max_pool_valid_grad(fm, rects, valid, kh: int, kw: int):
    """:func:`adaptive_max_pool_valid`, differentiable in ``fm`` through
    :func:`adaptive_max_pool_valid_backward`. Exact for training only where
    the losses mask invalid rois out (their cotangent is then zero), as
    for the JAX wrapper."""
    return plain.adaptive_max_pool_grad(fm, rects, valid, kh, kw,
                                        adaptive_max_pool_valid,
                                        adaptive_max_pool_valid_backward)
