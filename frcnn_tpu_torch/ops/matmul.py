"""Plain PyTorch version of the probe's matrix product
(``scripts/probe_int8_dot.py::pallas_mm``): ``O[M, N] = A[M, K] . B[K, N]``
in two modes,

* int8 x int8 -> int32: the sums of ``lax.dot_general(...,
  preferred_element_type=int32)``, which wrap modulo 2^32 as XLA's int32
  dot does. PyTorch on CUDA has no integer matmul, so the product is taken
  in float64, exact while K * 127^2 < 2^53 (every partial sum an integer
  below 2^53, in any order), and then reduced modulo 2^32 into int32;
* bfloat16 x bfloat16 -> float32: each product is exact in float32 and
  the sum is a float32 matmul (full float32: the default
  ``torch.backends.cuda.matmul.allow_tf32 = False``).

The hand-written kernel is ``ops/matmul_kernel.py::mm``; this is what the
CPU tests hold against the Pallas kernel and what the card compares it
with.
"""

from __future__ import annotations

import torch

# K * 127^2 must stay below 2^53 for the float64 sums to be exact
MAX_K_S8 = (1 << 53) // (127 * 127)


def check_operands(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The output dtype of ``a @ b`` in the probe's modes; raises for
    other dtypes or shapes."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mm: expected [M, K] and [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    modes = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
    if a.dtype != b.dtype or a.dtype not in modes:
        raise TypeError(f"mm: expected two int8 or two bfloat16 operands, "
                        f"got {a.dtype} and {b.dtype}")
    if a.dtype == torch.int8 and a.shape[1] > MAX_K_S8:
        raise ValueError(f"mm: K = {a.shape[1]} exceeds {MAX_K_S8}, past "
                         f"which float64 sums of int8 products are inexact")
    return modes[a.dtype]


def wrap_int32(p: torch.Tensor) -> torch.Tensor:
    """Integer-valued float64 ``p`` modulo 2^32, as two's-complement
    int32 (what an int32 sum that overflows holds)."""
    q = torch.remainder(p, 2.0 ** 32).to(torch.int64)
    return torch.where(q >= 2 ** 31, q - 2 ** 32, q).to(torch.int32)


def mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N], or bf16 -> float32."""
    out = check_operands(a, b)
    if out == torch.int32:
        return wrap_int32(a.double() @ b.double())
    return a.float() @ b.float()
