"""Batched greedy NMS on the hand-written CUDA kernel ``csrc/nms.cu``.

Port of ``frcnn_tpu/ops/pallas_nms.py``: the sort stays in PyTorch around
the kernel, as the JAX wrapper keeps it in XLA; the kernel computes the
keep mask over the sorted order and, in the same launch, the compaction
to ``[B, max_out]`` slots that the JAX wrapper runs in XLA after it. On a
CPU tensor the wrapper runs the plain version
(``ops/nms.py::nms_keep_slots``); on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from frcnn_tpu_torch.ops.nms import nms_keep_slots as plain_keep_slots
from frcnn_tpu_torch.ops.nms import sorted_nms
from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr

MAX_BOXES = 2048  # shared memory: 20 bytes per box, under the 48 KB default

KERNEL = CudaKernel(
    name="nms_keep_mask",
    entry="nms_keep_kernel",
    symbols={torch.float32: "frcnn_nms_keep"},
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
              ctypes.c_int],
    source="frcnn_tpu_torch/csrc/nms.cu",
    replaces="frcnn_tpu/ops/pallas_nms.py:33 (_kernel of "
             "pallas_nms_keep_mask, pallas_call at :91)",
)


def nms_keep_slots(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                   iou_threshold: float, max_out: int):
    """boxes_sorted [B, N, 4] float32, valid_sorted [B, N] bool, both in
    processing order. Returns (keep mask [B, N] bool, slots [B, max_out]
    int32: the sorted positions of the picks in pick order, -1 padded)."""
    if boxes_sorted.device.type == "cpu":
        return plain_keep_slots(boxes_sorted, valid_sorted, iou_threshold,
                                max_out)
    B, N = valid_sorted.shape
    check_cuda("boxes_sorted", boxes_sorted, torch.float32, (B, N, 4))
    check_cuda("valid_sorted", valid_sorted, torch.bool, (B, N))
    if N > MAX_BOXES:
        raise ValueError(f"nms kernel takes at most {MAX_BOXES} boxes, got {N}")
    if max_out < 1:
        raise ValueError(f"nms kernel needs max_out >= 1, got {max_out}")
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes_sorted.device)
    slots = torch.empty((B, max_out), dtype=torch.int32,
                        device=boxes_sorted.device)
    if B > 0:
        KERNEL.launch(torch.float32, ptr(boxes_sorted), ptr(valid_sorted),
                      ptr(keep), ptr(slots), B, N, float(iou_threshold),
                      int(max_out))
    return keep, slots


def nms_keep_mask(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                  iou_threshold: float, max_out: int) -> torch.Tensor:
    """The keep mask [B, N] bool of :func:`nms_keep_slots`."""
    return nms_keep_slots(boxes_sorted, valid_sorted, iou_threshold,
                          max_out)[0]


def cuda_nms(boxes, scores, valid, iou_threshold: float, max_out: int):
    """Batched drop-in for ``ops/nms.py::plain_nms`` through the kernel:
    [B, N, 4] / [B, N] inputs, returns (indices [B, max_out] int32, -1
    padded; valid [B, max_out])."""
    return sorted_nms(boxes.float(), scores, valid, iou_threshold, max_out,
                      nms_keep_slots)
