"""Batched greedy NMS on the hand-written CUDA kernel ``csrc/nms.cu``.

Port of ``frcnn_tpu/ops/pallas_nms.py``: the sort stays in PyTorch around
the kernel, as the JAX wrapper keeps it in XLA; the kernel computes the
keep mask over the sorted order and, in the same launch, the compaction
to ``[B, max_out]`` slots that the JAX wrapper runs in XLA after it. On a
CPU tensor the wrapper runs the plain version
(``ops/nms.py::nms_keep_slots``) for any N; on a CUDA tensor it launches
the kernel: up to :data:`MAX_BOXES` boxes per image staged in shared
memory, past that read from device memory (:func:`plan`), up to
:data:`MAX_DIRECT` boxes per image, where the alive bitset (a bit a box)
fills the shared memory; ``ValueError`` past that, before any launch.
"""

from __future__ import annotations

import ctypes

import torch

from frcnn_tpu_torch.ops.nms import nms_keep_slots as plain_keep_slots
from frcnn_tpu_torch.ops.nms import sorted_nms
from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, library, ptr

# The kernel's staging on the H100 (``frcnn_nms_max_boxes`` in nms.cu gives
# its limit on the current device): up to 2048 boxes every block of the
# cluster stages the whole image; past that each of the 8 blocks stages the
# boxes of its own alive words (20 bytes per box) beside the whole alive
# bitset (one bit per box), in the 227 KB of shared memory a block may opt
# in to (232448 bytes, less the kernel's 2064 bytes of static arrays).
# Past the largest staged count the blocks read their boxes from device
# memory and keep only the bitset.
SMEM_OPTIN = 232448
STATIC_SMEM = 2064


def staged_smem(n: int) -> int:
    """The kernel's dynamic shared memory per block for ``n`` staged boxes
    (``staging`` in nms.cu)."""
    words = (n + 31) // 32
    staged = 32 * words if words <= 64 else 32 * (-(-words // 8))
    return staged * 20 + words * 4 + 32


# the largest staged count (``max_boxes()`` on the card)
MAX_BOXES = max(n for n in range(32, 1 << 17, 32)
                if staged_smem(n) <= SMEM_OPTIN - STATIC_SMEM)
# the largest count at all: the alive bitset fills the shared memory (an
# int32 box offset, 4 N, would overflow only past 2^29 boxes)
MAX_DIRECT = (SMEM_OPTIN - STATIC_SMEM - 32) // 4 * 32


def plan(n: int) -> bool:
    """Whether the kernel reads an image of ``n`` boxes from device memory
    (``direct``: past :data:`MAX_BOXES`) rather than staging it. Raises
    past :data:`MAX_DIRECT`: more boxes per image than the Pallas kernel
    holds in VMEM."""
    if n <= MAX_BOXES:
        return False
    if n > MAX_DIRECT:
        raise ValueError(f"nms kernel takes at most {MAX_DIRECT} boxes per "
                         f"image, got {n}")
    return True

KERNEL = CudaKernel(
    name="nms_keep_mask",
    entry="nms_keep_kernel",
    symbols={torch.float32: "frcnn_nms_keep"},
    # boxes, valid, keep, slots; B, N, iou threshold, max_out, direct
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
              ctypes.c_int, ctypes.c_int],
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
    direct = plan(N)
    if max_out < 1:
        raise ValueError(f"nms kernel needs max_out >= 1, got {max_out}")
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes_sorted.device)
    slots = torch.empty((B, max_out), dtype=torch.int32,
                        device=boxes_sorted.device)
    if B > 0:
        KERNEL.launch(torch.float32, ptr(boxes_sorted), ptr(valid_sorted),
                      ptr(keep), ptr(slots), B, N, float(iou_threshold),
                      int(max_out), int(direct))
    return keep, slots


def max_boxes() -> int:
    """The largest N the kernel stages in shared memory on the current
    CUDA device, as the built library computes it (builds the kernels);
    :data:`MAX_BOXES` on the H100. Past it the kernel reads the boxes
    from device memory."""
    fn = library().frcnn_nms_max_boxes
    fn.restype = ctypes.c_int
    return int(fn())


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
