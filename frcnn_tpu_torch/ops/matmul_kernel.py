"""The probe's matrix product on the hand-written CUDA kernel
``csrc/matmul.cu``: ``O[M, N] = A[M, K] . B[K, N]``, int8 x int8 -> int32
or bfloat16 x bfloat16 -> float32, on tensor cores (``mma.sync``).

Port of ``scripts/probe_int8_dot.py::pallas_mm`` (kernel body
``_mm_kernel``). Both operands are row-major and contiguous, as the probe
makes them; the kernel transposes the int8 B tiles itself, so no copy is
made here. On a CPU tensor :func:`mm` runs the plain version
(``ops/matmul.py::mm_plain``); on a CUDA tensor it launches the kernel or
raises. It lies on no serving or training path: the probe
(``tools/probe_int8_dot.py``) is its one caller.
"""

from __future__ import annotations

import ctypes

import torch

from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr
from frcnn_tpu_torch.ops.matmul import check_operands, mm_plain

KERNEL = CudaKernel(
    name="mm",
    entry="mm_kernel",
    symbols={torch.int8: "frcnn_mm_s8s32",
             torch.bfloat16: "frcnn_mm_bf16f32"},
    argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
    source="frcnn_tpu_torch/csrc/matmul.cu",
    replaces="scripts/probe_int8_dot.py:40 (_mm_kernel of pallas_mm, "
             "pallas_call at :51)",
)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] (sums wrap modulo 2^32),
    or bfloat16 -> float32."""
    if a.device.type == "cpu":
        return mm_plain(a, b)
    out_dtype = check_operands(a, b)
    (m, k), n = a.shape, b.shape[1]
    check_cuda("a", a, a.dtype, (m, k))
    check_cuda("b", b, a.dtype, (k, n))
    if m == 0 or n == 0:
        raise ValueError(f"mm: empty output {m} x {n}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"mm: a size of {m} x {k} x {n} exceeds int32")
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    KERNEL.launch(a.dtype, ptr(a), ptr(b), ptr(out), m, k, n)
    return out
