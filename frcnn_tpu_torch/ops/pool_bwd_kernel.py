"""2x2/2 ceil-mode max pool whose backward is the hand-written CUDA kernel
``csrc/pool_bwd.cu`` (first-max routing).

Port of ``frcnn_tpu/ops/pallas_pool_bwd.py::ceil_max_pool_2x2_firstmax``.
The forward is ``F.max_pool2d(ceil_mode=True)`` (identical values); the
backward routes each cotangent to the first maximum of its window. On a CPU
tensor the backward runs the plain version (``ops/pool_bwd.py``); on a
CUDA tensor it launches the kernel or raises. Unlike the JAX wrapper, odd W
needs no fallback: the kernel handles every H and W.

pnet's tensors are NCHW views of channels_last memory; the kernel reads the
NHWC view of ``x``, and the incoming cotangent is made channels_last first
(``KERNEL.grad_copies`` counts the calls where that took a copy).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from frcnn_tpu_torch.ops import pool_bwd as plain
from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    name="pool_bwd",
    entry="pool_bwd_kernel",
    symbols={torch.float32: "frcnn_pool_bwd_f32",
             torch.bfloat16: "frcnn_pool_bwd_bf16"},
    argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
    source="frcnn_tpu_torch/csrc/pool_bwd.cu",
    replaces="frcnn_tpu/ops/pallas_pool_bwd.py:54 (_bwd_kernel of "
             "_pool_bwd_pallas, pallas_call at :125)",
)
KERNEL.grad_copies = 0


def ceil_max_pool_2x2_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] (float32 or bfloat16), g [B, ceil(H/2), ceil(W/2), C].
    Returns dx [B, H, W, C] contiguous in the dtype of ``x``."""
    if x.device.type == "cpu":
        return plain.ceil_max_pool_2x2_bwd(x, g)
    b, h, w, c = x.shape
    gq = g.to(x.dtype).contiguous()
    check_cuda("x", x, x.dtype, (b, h, w, c))
    check_cuda("g", gq, x.dtype, (b, -(-h // 2), -(-w // 2), c))
    dx = torch.empty_like(x)
    KERNEL.launch(x.dtype, ptr(x), ptr(gq), ptr(dx), b, h, w, c)
    return dx


class _FirstMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.max_pool2d(x, 2, 2, ceil_mode=True)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if not g.is_contiguous(memory_format=torch.channels_last):
            KERNEL.grad_copies += 1
            g = g.contiguous(memory_format=torch.channels_last)
        dx = ceil_max_pool_2x2_bwd(x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1))
        return dx.permute(0, 3, 1, 2)


def ceil_max_pool_2x2_firstmax(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 ceil-mode max pool of NCHW ``x`` with the first-max
    backward of the kernel."""
    return _FirstMaxPool.apply(x)
