"""Building blocks of the reference's Torch modules (eval only).

Port of the JAX package's ``models/layers.py``:

* :func:`prelu` — ``nn.PReLU()``: one slope shared by all channels;
* :func:`ceil_max_pool_2x2` — ``SpatialMaxPooling(2,2,2,2):ceil()``: an odd
  extent gets a last window of one cell (as padding with -inf would);
* :class:`MaskedBatchNorm` — batch norm with running statistics (eval),
  computed in float32 and returned in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def prelu(x, slope):
    """``where(x >= 0, x, slope * x)`` with the (1,)-shaped slope cast to
    the dtype of ``x`` (one fused ``F.prelu`` pass)."""
    return F.prelu(x, slope.to(x.dtype))


def ceil_max_pool_2x2(x):
    """2x2 stride-2 ceil-mode max pool of NCHW ``x``."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class MaskedBatchNorm(nn.Module):
    """Eval-mode batch norm of ``[..., R, F]`` rows with torch defaults
    (eps 1e-5). Train-time per-image statistics are a later slice."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        xf = x.float()
        inv = torch.rsqrt(self.running_var + self.eps)
        out = (xf - self.running_mean) * inv * self.weight + self.bias
        return out.to(x.dtype)
