"""Batched adaptive max ROI pooling on the hand-written CUDA kernel
``csrc/roi_pool.cu`` (forward only).

Port of ``frcnn_tpu/ops/pallas_roi_pool.py::pallas_adaptive_max_pool_valid``.
On a CPU tensor the wrapper runs the plain version
(``ops/roi_pool.py::adaptive_max_pool``); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from frcnn_tpu_torch.ops import roi_pool as plain
from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    name="roi_pool",
    symbols={torch.float32: "frcnn_roi_pool_f32",
             torch.bfloat16: "frcnn_roi_pool_bf16"},
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 7,
    source="frcnn_tpu_torch/csrc/roi_pool.cu",
    replaces="frcnn_tpu/ops/pallas_roi_pool.py:36 (_kernel of _forward, "
             "pallas_call at :186)",
)


def adaptive_max_pool_valid(fm, rects, valid, kh: int, kw: int):
    """fm [B, H, W, C] (float32 or bfloat16), rects [B, D, 4] prepared
    feature rects (integer valued, truncated to int32), valid [B, D] bool.
    Returns [B, D, kh, kw, C] in the dtype of ``fm``; rows with
    ``valid == False`` are zero."""
    if fm.device.type == "cpu":
        return plain.adaptive_max_pool(fm, rects, valid, kh, kw)
    B, H, W, C = fm.shape
    D = rects.shape[1]
    rects_i = rects.to(torch.int32).contiguous()
    check_cuda("fm", fm, fm.dtype, (B, H, W, C))
    check_cuda("rects", rects_i, torch.int32, (B, D, 4))
    check_cuda("valid", valid, torch.bool, (B, D))
    out = torch.empty((B, D, kh, kw, C), dtype=fm.dtype, device=fm.device)
    KERNEL.launch(fm.dtype, ptr(fm), ptr(rects_i), ptr(valid), ptr(out),
                  B, D, H, W, C, kh, kw)
    return out
