"""Backward of the 2x2/2 ceil-mode max pool: the plain PyTorch version.

Port of the function that ``frcnn_tpu/ops/pallas_pool_bwd.py::_pool_bwd_pallas``
computes: each pooled cotangent goes to the FIRST maximum of its window in
row-major order ((h0, w0), (h0, w1), (h1, w0), (h1, w1)), as XLA's
SelectAndScatter and torch's ``max_pool2d`` backward route it; the other
cells get zero. Cells past H or W (the ceil tail) take part as -inf.
Comparisons run in float32 (widening bf16 is exact and monotone), so the
result is pure routing: bitwise the library backward's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ceil_max_pool_2x2_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] (any strides), g [B, ceil(H/2), ceil(W/2), C].
    Returns dx [B, H, W, C] contiguous, in the dtype of ``x`` (``g`` is
    cast to it first, as the JAX wrapper does)."""
    b, h, w, c = x.shape
    hc, wc = -(-h // 2), -(-w // 2)
    if tuple(g.shape) != (b, hc, wc, c):
        raise ValueError(f"g: expected {(b, hc, wc, c)}, got {tuple(g.shape)}")
    xf = F.pad(x.float(), (0, 0, 0, 2 * wc - w, 0, 2 * hc - h),
               value=-torch.inf)
    win = xf.reshape(b, hc, 2, wc, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, hc, wc, 4, c)
    eq = win == win.amax(dim=3, keepdim=True)
    first = eq & (torch.cumsum(eq.to(torch.int32), dim=3) == 1)
    gq = g.to(x.dtype)
    dx = torch.where(first, gq[:, :, :, None, :], torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
    dx = dx.reshape(b, hc, wc, 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, 2 * hc, 2 * wc, c)
    return dx[:, :h, :w].contiguous()
